"""Analysis: the paper's accelerator model and the Einsum-cascade analyzer
(pass-count lower bounds, live-footprint proofs, and the structural check
of the CUDA kernels — ``python -m repro_torch.analysis.report --check``).
Port of ``repro.analysis``; the roofline and dry-run tables wait for
ROADMAP item 10c."""
