"""Registry of declared Einsum cascades for every shipped kernel family.

Port of ``repro.analysis.cascade``: the same eight entries, with the
reference's names, expected passes, footprints, buckets and peers.  The
declarations live beside the kernels (:mod:`repro_torch.kernels.ref`,
:mod:`repro_torch.kernels.fusemax`, :mod:`repro_torch.kernels.decode`) and
the numeric taxonomy (:mod:`repro_torch.core.cascades_numeric`); each
entry binds one to its *expected* analysis results — pass count over the
sequence rank M, live-footprint class, taxonomy bucket — to the port's
implementation sites (``kernels``: the CUDA sources and their ``*_cuda``
wrappers and ``*_torch`` plain versions) and to the structural probes of
:mod:`repro_torch.analysis.lint` that hold those sites to the declaration
(``lint``): the visit-count probes, and the ``trace:*`` probes that read
the pass count off the plain versions' torch calls where the reference
binds its ``jnp:*`` probes.

``python -m repro_torch.analysis.report --check`` walks this registry and
exits non-zero on any mismatch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Tuple

from repro_torch.core.einsum import Cascade
from repro_torch.core.taxonomy import attention_2pass as _cascade_2pass
from repro_torch.kernels.decode import (
    decode_paged_cascade,
    decode_splitk_cascade,
    mla_decode_paged_cascade,
    mla_verify_chain_cascade,
    verify_chain_cascade,
)
from repro_torch.kernels.fusemax import prefill_cascade
from repro_torch.kernels.ops import KERNEL_CASCADES
from repro_torch.kernels.ref import reference_cascade

O1 = "O(1)"
OS = "O(S)"

_CSRC = "kernels/csrc/"


@dataclass(frozen=True)
class CascadeEntry:
    """One kernel family: declared cascade + expected analysis results."""

    name: str
    build: Callable[[], Cascade]
    expected_passes: int
    footprint: str                    # O1 / OS in sequence length
    bucket: str                       # taxonomy bucket (paper Table I)
    kernels: Tuple[str, ...] = ()     # implementation sites (docs only)
    lint: Tuple[str, ...] = field(default_factory=tuple)
    rank: str = "M"                   # analysis rank (sequence)
    peers: Tuple[str, ...] = ()       # prior work in the same bucket


REGISTRY: Tuple[CascadeEntry, ...] = (
    CascadeEntry(
        name="reference-3pass",
        build=reference_cascade,
        expected_passes=3,
        footprint=OS,
        bucket="3-pass",
        kernels=("kernels/ref.py::mha_reference",
                 "kernels/ref.py::decode_reference"),
        lint=("torch:mha_reference", "torch:decode_reference",
              "trace:mha_reference", "trace:decode_reference"),
        peers=("PyTorch", "TensorFlow", "FLAT", "E.T."),
    ),
    CascadeEntry(
        name="fusemax-2pass",
        build=_cascade_2pass,
        expected_passes=2,
        footprint=OS,
        bucket="2-pass",
        kernels=("core/cascades_numeric.py::attention_2pass",),
        lint=("torch:attention_2pass", "trace:attention_2pass"),
        peers=("TileFlow", "Choi et al."),
    ),
    CascadeEntry(
        name="fusemax-prefill-1pass",
        build=prefill_cascade,
        expected_passes=1,
        footprint=O1,
        bucket="1-pass",
        kernels=(_CSRC + "fusemax_prefill.cu",
                 "kernels/fusemax.py::fusemax_attention_cuda",
                 "kernels/fusemax.py::fusemax_attention_torch"),
        lint=("prefill", "trace:prefill"),
        peers=("FlashAttention-2", "FuseMax"),
    ),
    CascadeEntry(
        name="decode-splitk-1pass",
        build=decode_splitk_cascade,
        expected_passes=1,
        footprint=O1,
        bucket="1-pass",
        kernels=(_CSRC + "decode_partials.cu",
                 "kernels/decode.py::decode_partials_cuda",
                 "kernels/decode.py::decode_partials_torch",
                 _CSRC + "latent_decode_partials.cu",
                 "kernels/decode.py::latent_decode_partials_cuda",
                 "kernels/decode.py::latent_decode_partials_torch"),
        lint=("decode", "decode_latent", "trace:decode"),
    ),
    CascadeEntry(
        name="decode-paged-splitk-1pass",
        build=decode_paged_cascade,
        expected_passes=1,
        footprint=O1,
        bucket="1-pass",
        kernels=(_CSRC + "paged_decode_partials.cu",
                 "kernels/decode.py::paged_decode_partials_cuda",
                 "kernels/decode.py::paged_decode_partials_torch"),
        lint=("decode_paged", "decode_paged_fp8"),
    ),
    CascadeEntry(
        name="mla-decode-paged-1pass",
        build=mla_decode_paged_cascade,
        expected_passes=1,
        footprint=O1,
        bucket="1-pass",
        kernels=(_CSRC + "mla_paged_decode_partials.cu",
                 "kernels/decode.py::mla_paged_decode_partials_cuda",
                 "kernels/decode.py::mla_paged_decode_partials_torch"),
        lint=("mla_decode_paged", "trace:mla_decode"),
    ),
    CascadeEntry(
        name="verify-chain-1pass",
        build=verify_chain_cascade,
        expected_passes=1,
        footprint=O1,
        bucket="1-pass",
        kernels=("kernels/decode.py::decode_partials_*[n_pos>1]",
                 "kernels/decode.py::paged_decode_partials_*[n_pos>1]",
                 "kernels/decode.py::latent_decode_partials_*[n_pos>1]"),
        lint=("verify", "verify_paged", "verify_latent", "trace:verify"),
    ),
    CascadeEntry(
        name="mla-verify-chain-1pass",
        build=mla_verify_chain_cascade,
        expected_passes=1,
        footprint=O1,
        bucket="1-pass",
        kernels=("kernels/decode.py::mla_paged_decode_partials_*[n_pos>1]",),
        lint=("mla_verify_paged", "trace:mla_verify"),
    ),
)


def entry(name: str) -> CascadeEntry:
    for e in REGISTRY:
        if e.name == name:
            return e
    raise KeyError(name)


def op_cascade(op_name: str) -> Cascade:
    """Declared cascade for a public kernel op (dispatch registry)."""
    return KERNEL_CASCADES[op_name]()


__all__ = [
    "O1",
    "OS",
    "CascadeEntry",
    "KERNEL_CASCADES",
    "REGISTRY",
    "entry",
    "op_cascade",
]
