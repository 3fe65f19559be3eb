"""Roofline terms of a dry-run cell on the card's published peaks.

Port of ``repro.analysis.roofline`` for an NVIDIA H100:

    compute    = FLOPs_per_card / peak FLOP/s of the cell's dtype
    memory     = HBM bytes_per_card / HBM bandwidth
    collective = wire bytes_per_card over NVLink (within a host of 8)
                 + wire bytes_per_card over the network (an axis whose
                 groups span hosts)

FLOPs and bytes come from the dry run (:mod:`repro_torch.launch.dryrun`),
wire bytes from :mod:`repro_torch.analysis.collectives`.  MODEL_FLOPS
(6·N·D train / 2·N·D inference, N = active parameters) anchors the
usefulness ratio, as in the reference.

The peaks are a table keyed by the card's name as
``torch.cuda.get_device_properties`` reports it: :func:`card_peaks` reads
the present card's and refuses one the table does not hold; without a
card (the dry run on the CPU) it takes the H100 SXM's, the card the port
targets.  Every number is a published one, its source beside it — none
is a measurement.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class CardPeaks:
    """One card's published peaks (per card, dense, no sparsity)."""
    name: str
    flops: dict              # dtype name → FLOP/s
    hbm_bytes_per_s: float
    nvlink_bytes_per_s: float    # each way, within a host
    network_bytes_per_s: float   # each way, the card's share across hosts
    source: str


#: NVIDIA H100 SXM5 80GB (the name the card reports).  Compute and HBM:
#: NVIDIA's H100 data sheet — 989 TFLOP/s bf16 / fp16, 495 TF32, 67 fp32
#: outside the tensor cores, 3.35 TB/s; NVLink 4: 900 GB/s per card, 450
#: GB/s each way, within an HGX host of 8.  Network: the DGX H100 data
#: sheet's one ConnectX-7 400 Gb/s port per GPU, 50 GB/s each way.
H100_SXM = CardPeaks(
    name="NVIDIA H100 80GB HBM3",
    flops={"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
           "float32": 67e12},
    hbm_bytes_per_s=3.35e12,
    nvlink_bytes_per_s=450e9,
    network_bytes_per_s=400e9 / 8,
    source="NVIDIA H100 data sheet (SXM5; dense); DGX H100 data sheet "
           "(ConnectX-7 400 Gb/s per GPU)")

PEAKS = {H100_SXM.name: H100_SXM}

#: the directory the dry run, the roofline pass and the hill climb write
#: their records under, and the report reads them from
OUT_ENV = "REPRO_TORCH_DRYRUN_OUT"


def out_dir(*parts: str) -> str:
    """``$REPRO_TORCH_DRYRUN_OUT`` (read at each call; default
    ``out/torch_dryrun/`` at the repo root) joined with ``parts``."""
    base = os.environ.get(OUT_ENV) or os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "out", "torch_dryrun")
    return os.path.join(base, *parts)


def card_peaks(name: Optional[str] = None) -> CardPeaks:
    """The peaks of the card called ``name``; by default the present
    card's (``torch.cuda.get_device_properties(0).name``), or the H100
    SXM's when no card is present.  A card the table does not hold is
    refused."""
    if name is None:
        if not torch.cuda.is_available():
            return H100_SXM
        name = torch.cuda.get_device_properties(0).name
    if name not in PEAKS:
        raise KeyError(f"no published peaks for the card {name!r}; the "
                       f"table holds {sorted(PEAKS)}")
    return PEAKS[name]


def dtype_name(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bfloat16", torch.float16: "float16",
            torch.float32: "float32"}[dtype]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-card quantities
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_chip: float
    useful_ratio: float
    #: roofline fraction: the useful compute's time / the largest term
    roofline_fraction: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only)."""
    if cfg.moe is None:
        return cfg.param_count()
    mo = cfg.moe
    dense_equiv = dataclasses.replace(
        cfg, moe=dataclasses.replace(mo, n_experts=mo.top_k))
    return dense_equiv.param_count()


def model_flops(cfg: ModelConfig, *, tokens: int, train: bool) -> float:
    """6·N·D (train) or 2·N·D (inference) with N = active params."""
    n = active_param_count(cfg)
    return (6.0 if train else 2.0) * n * tokens


def roofline(
    *, arch: str, shape: str, mesh: str, chips: int,
    hlo_flops: float, hlo_bytes: float, collective_bytes: float,
    tokens: int, train: bool, cfg: Optional[ModelConfig] = None,
    dtype: torch.dtype = torch.bfloat16, network_bytes: float = 0.0,
) -> RooflineReport:
    """The terms of one cell: ``hlo_flops`` / ``hlo_bytes`` /
    ``collective_bytes`` per card (the dry run's counts; the names are the
    reference's), ``network_bytes`` the part of the wire bytes that
    crosses hosts; the compute term at ``dtype``'s peak."""
    peaks = card_peaks()
    peak = peaks.flops[dtype_name(dtype)]
    compute_s = hlo_flops / peak
    memory_s = hlo_bytes / peaks.hbm_bytes_per_s
    collective_s = (collective_bytes - network_bytes) \
        / peaks.nvlink_bytes_per_s + network_bytes / peaks.network_bytes_per_s
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, tokens=tokens, train=train) / chips if cfg else 0.0
    useful = (mf / hlo_flops) if hlo_flops else 0.0
    top = max(terms.values())
    frac = (mf / peak) / top if top else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops_per_chip=mf, useful_ratio=useful,
        roofline_fraction=frac,
    )
