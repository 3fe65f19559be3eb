"""FuseMax attention kernels for Hopper, with their plain torch versions.

``fusemax.py``  — 1-pass prefill attention: CUDA wrapper + plain version
                  (each with a log-sum-exp output), and the recompute
                  backward in torch ops
``decode.py``   — split-K decode partials, dense, paged, and MLA latent
                  (paged and dense): CUDA wrappers + plain versions, and
                  the torch combine
``ops.py``      — public ops (GQA folding, tile choice, impl dispatch,
                  the differentiable ``FuseMaxAttention``)
``autotune.py`` — modeled tile / split selection
``ref.py``      — 3-pass fp32 oracles
``_build.py``   — nvcc build + ctypes loading of ``csrc/*.cu``
"""
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import (
    AttentionParams, DecodeParams, attention_params, decode_params,
    mla_paged_decode_params, paged_decode_params,
)
from repro_torch.kernels.decode import (
    combine_partials, decode_partials_cuda, decode_partials_torch,
    latent_decode_partials_cuda, latent_decode_partials_torch,
    mla_paged_decode_partials_cuda, mla_paged_decode_partials_torch,
    paged_decode_partials_cuda, paged_decode_partials_torch,
)
from repro_torch.kernels.fusemax import (
    exp_maccs, fusemax_attention_bwd, fusemax_attention_cuda,
    fusemax_attention_torch,
)
from repro_torch.kernels.ops import (
    KERNEL_CASCADES, FuseMaxAttention, fusemax_attention, fusemax_decode,
    fusemax_decode_latent,
    fusemax_decode_paged, fusemax_mla_decode_paged, gather_pages,
)
from repro_torch.kernels.ref import decode_reference, mha_reference

#: the CUDA wrappers, each counting its launches in its ``launches*``
#: attributes (a replayed CUDA graph must advance them: see
#: :mod:`repro_torch.model.decode_graph`)
COUNTED_WRAPPERS = (fusemax_attention_cuda, decode_partials_cuda,
                    paged_decode_partials_cuda,
                    mla_paged_decode_partials_cuda,
                    latent_decode_partials_cuda)

__all__ = [
    "AttentionParams", "COUNTED_WRAPPERS", "DecodeParams", "FuseMaxAttention",
    "KERNEL_CASCADES",
    "attention_params", "autotune", "combine_partials", "decode_params",
    "decode_partials_cuda", "decode_partials_torch", "decode_reference",
    "exp_maccs", "fusemax_attention", "fusemax_attention_bwd",
    "fusemax_attention_cuda",
    "fusemax_attention_torch", "fusemax_decode", "fusemax_decode_latent",
    "fusemax_decode_paged", "fusemax_mla_decode_paged", "gather_pages",
    "latent_decode_partials_cuda", "latent_decode_partials_torch",
    "mha_reference",
    "mla_paged_decode_params", "mla_paged_decode_partials_cuda",
    "mla_paged_decode_partials_torch", "paged_decode_params",
    "paged_decode_partials_cuda", "paged_decode_partials_torch",
]
