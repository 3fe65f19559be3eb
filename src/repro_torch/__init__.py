"""PyTorch + CUDA port of the FuseMax reproduction, for one NVIDIA H100.

Mirrors the JAX package ``repro`` module for module (``configs``,
``kernels``, ``model``, ``serving``, ``launch``) and never imports it or
JAX: the JAX package is the reference the port is tested against.  Its
attention runs through hand-written Hopper kernels (``kernels/csrc``),
each with a plain torch version that the CPU tests and the card's checks
hold it to.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
