"""Analysis: the paper's accelerator model and the Einsum-cascade analyzer
(pass-count lower bounds, live-footprint proofs, and the structural check
of the CUDA kernels — ``python -m repro_torch.analysis.report --check``).
Port of ``repro.analysis``, with the roofline on the H100's published
peaks (:mod:`~repro_torch.analysis.roofline`) and per-card collective
bytes reckoned from a sharding plan (:mod:`~repro_torch.analysis.
collectives`, the counterpart of ``hlo_stats``) for the dry run."""
