"""Analytical spatial-array model: unfused / FLAT / FuseMax (paper §VI).

The paper evaluates with Timeloop+Accelergy on a spatial architecture
(Fig. 2: 128×128 2D MACC array + 128-PE 1D array @ 940 MHz, shared global
buffer, DRAM).  This module re-implements that evaluation analytically —
per-Einsum cycle, traffic, and energy accounting driven by the pass
structure each design implements:

  * **unfused**  — 3-pass cascade, phases sequential, every intermediate
    (QK, SN, A) round-trips DRAM (§VI-A "Unfused Baseline");
  * **FLAT**     — 3-pass cascade, fused on a P row-block: QK/SN live in
    the global buffer while the 1D array runs the softmax; the
    algorithmic-minimum O(M) live footprint (§III-B) forces spills once a
    row fiber exceeds the buffer — FLAT becomes memory-bound at long M
    (paper Fig. 6);
  * **FuseMax**  — 1-pass cascade (Cascade 5) + division deferral (§IV-D)
    + exp-as-6-MACCs on the 2D array + sum/max sharing between arrays
    (§V): both arrays stay ~fully utilized and DRAM traffic is
    Q/K/V/AV-only, independent of M.

Cost constants are 45nm-class estimates (Horowitz ISSCC'14 scaling);
DESIGN.md records them as changed assumptions vs. the paper's Accelergy
runs.  The benchmarks reproduce Figs. 6-10 and report the paper's headline
ratios for comparison.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SpatialArch:
    pe2d_rows: int = 128
    pe2d_cols: int = 128
    pe1d: int = 128
    freq_hz: float = 940e6
    #: area-normalized global buffer; 1 MiB reproduces FLAT's observed
    #: spill onset (paper Fig. 6: utilization degrades from M ≥ 256K:
    #: 2 fibers · 256Ki · 2 B = 1 MiB = 2× the usable half-buffer)
    glb_bytes: int = 1 * 2**20
    #: calibrated so FLAT's spilled 3-pass traffic (7 accesses/elem ·2B)
    #: crosses its 1D-array softmax time (9 ops/elem / 128 PEs) — the
    #: paper-observed memory-bound transition at M ≥ 256K (Fig. 6a)
    dram_bw: float = 100e9               # bytes/s
    elem_bytes: int = 2                  # bf16
    # energy (45nm-class, pJ)
    e_macc: float = 2.0                  # 16-bit multiply-accumulate
    e_div: float = 10.0                  # fp divider [54]
    e_sfu: float = 1.0                   # max/add on the 1D array
    #: calibrated against the paper's §VI energy anchors (FuseMax = 77%
    #: of unfused / 79% of FLAT on attention): HBM-class 5 pJ/B DRAM,
    #: large-SRAM 0.5 pJ/B — see EXPERIMENTS.md §Paper-validation
    e_glb_byte: float = 0.5
    e_dram_byte: float = 5.0

    @property
    def pe2d(self) -> int:
        return self.pe2d_rows * self.pe2d_cols


@dataclass(frozen=True)
class Workload:
    """One transformer encoder layer family (paper Table: BERT etc.)."""
    name: str
    n_layers: int
    d_model: int
    heads: int
    head_dim: int                        # E = F
    d_ff: int
    batch: int = 64

    def source(self) -> str:
        return {
            "BERT": "BERT-Base [18]", "TrXL": "TrXL-wt103 [14]",
            "T5": "T5-small [46]", "XLM": "XLM [29]",
        }.get(self.name, self.name)


WORKLOADS = {
    "BERT": Workload("BERT", 12, 768, 12, 64, 3072),
    "TrXL": Workload("TrXL", 16, 1024, 16, 64, 4096),
    "T5": Workload("T5", 6, 512, 8, 64, 2048),
    "XLM": Workload("XLM", 12, 2048, 16, 128, 8192),
}

SEQLENS = [1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20]

EXP_MACCS = 6          # exponential via 6 MACCs (paper [36], §V)
DIV_CYCLES = 1         # pipelined fp divider [54]


@dataclass
class Result:
    time_s: float
    energy_j: float
    util_2d: float
    util_1d: float
    dram_bytes: float
    compute_bound: bool


def _phase(compute_2d: float, compute_1d: float, dram_bytes: float,
           arch: SpatialArch) -> tuple[float, str]:
    """Phase latency (s) = max(2D, 1D, DRAM) and its binding resource."""
    t2 = compute_2d / arch.pe2d / arch.freq_hz
    t1 = compute_1d / arch.pe1d / arch.freq_hz
    tm = dram_bytes / arch.dram_bw
    t = max(t2, t1, tm)
    bound = {t2: "2d", t1: "1d", tm: "mem"}[t]
    return t, bound


def attention_unfused(w: Workload, m: int,
                      arch: SpatialArch = SpatialArch()) -> Result:
    """3-pass, unfused: QK / softmax / AV as separate DRAM-staged phases."""
    p = m
    e = f = w.head_dim
    bh = w.batch * w.heads
    eb = arch.elem_bytes

    # Phase 1: QK (2D array)
    c2_qk = p * m * e
    d_qk = (p * e + m * e + p * m) * eb
    t_qk, _ = _phase(c2_qk, 0, d_qk, arch)
    # Phase 2: 3-pass softmax on the 1D array (GM; SN+SD; A)
    c1_sm = p * m * (1 + EXP_MACCS + 1 + DIV_CYCLES)    # max, exp, add, div
    d_sm = (2 * p * m + p * m + p * m + p * m) * eb     # QK×2, SN w+r, A w
    t_sm, _ = _phase(0, c1_sm, d_sm, arch)
    # Phase 3: AV
    c2_av = p * m * f
    d_av = (p * m + m * f + p * f) * eb
    t_av, _ = _phase(c2_av, 0, d_av, arch)

    t = (t_qk + t_sm + t_av) * bh
    dram = (d_qk + d_sm + d_av) * bh
    maccs = (c2_qk + c2_av + p * m * EXP_MACCS) * bh
    sfu = (p * m * 2) * bh
    divs = p * m * bh
    glb = dram * 2                                      # staging in/out
    energy = (dram * arch.e_dram_byte + glb * arch.e_glb_byte
              + maccs * arch.e_macc + sfu * arch.e_sfu
              + divs * arch.e_div) * 1e-12
    busy_2d = (c2_qk + c2_av) * bh / arch.pe2d / arch.freq_hz
    busy_1d = c1_sm * bh / arch.pe1d / arch.freq_hz
    return Result(t, energy, busy_2d / t, busy_1d / t, dram,
                  t < dram / arch.dram_bw * 1.01)


def attention_flat(w: Workload, m: int,
                   arch: SpatialArch = SpatialArch()) -> Result:
    """FLAT: fused 3-pass; O(M) row fibers buffered on-chip, spilling when
    M·eb exceeds the (double-buffered) global buffer (paper §I, §VI-B)."""
    p = m
    e = f = w.head_dim
    bh = w.batch * w.heads
    eb = arch.elem_bytes

    c2 = p * m * (e + f)
    c1 = p * m * (1 + EXP_MACCS + 1 + DIV_CYCLES)
    # live footprint per row: QK fiber + SN fiber (3-pass ⇒ both O(M));
    # the fraction exceeding the (double-buffered) buffer spills — partial
    # spilling models a Timeloop-optimal mapping that keeps what fits
    fiber_bytes = 2 * m * eb
    usable = arch.glb_bytes // 2                        # double buffering
    d_base = (p * e + 2 * m * e + p * f) * eb           # Q, K, V, AV
    spill_frac = max(0.0, 1.0 - usable / fiber_bytes)
    # 3-pass spill traffic: QK w + 2r (GM, SN passes); SN w + r (div
    # pass); A w + r (AV) = 7 accesses per spilled element
    dram = d_base + 7 * p * m * eb * spill_frac
    spilled = spill_frac > 0
    t, bound = _phase(c2, c1, dram, arch)
    t *= bh
    dram *= bh
    maccs = c2 * bh
    sfu = p * m * 2 * bh
    divs = p * m * bh
    exp_ops = p * m * EXP_MACCS * bh                    # on the 1D array
    glb = (d_base + 7 * p * m * eb * (1 - spill_frac)) * bh   # on-chip part
    energy = (dram * arch.e_dram_byte + glb * arch.e_glb_byte
              + (maccs + exp_ops) * arch.e_macc + sfu * arch.e_sfu
              + divs * arch.e_div) * 1e-12
    busy_2d = c2 * bh / arch.pe2d / arch.freq_hz
    busy_1d = c1 * bh / arch.pe1d / arch.freq_hz
    return Result(t, energy, busy_2d / t, busy_1d / t, dram, bound != "mem")


def attention_fusemax(w: Workload, m: int,
                      arch: SpatialArch = SpatialArch()) -> Result:
    """FuseMax: 1-pass cascade, deferred division, exp on the 2D array,
    sum/max shared between arrays, deep fusion ⇒ M-independent buffering."""
    p = m
    e = f = w.head_dim
    bh = w.batch * w.heads
    eb = arch.elem_bytes
    m0 = 128                                            # M1 block size

    # total scalar work, schedulable on either array (§V "sharing")
    ops_mxu = p * m * (e + f) + p * m * EXP_MACCS       # BQK, SLNV, exp
    ops_1d = p * m * 2                                  # LM max, SLD add
    ops_corr = p * (m // m0) * 6                        # RM/PRM/SPD/RD/...
    ops_div = p * f * DIV_CYCLES                        # deferred (§IV-D)
    total_ops = ops_mxu + ops_1d + ops_corr + ops_div
    # both arrays drain the shared work pool (fine-grain pipelining, Fig 4)
    c_combined = total_ops / (arch.pe2d + arch.pe1d)
    dram = (p * e + 2 * m * e + p * f) * eb             # Q, K, V, AV only
    t_comp = c_combined / arch.freq_hz
    t_mem = dram / arch.dram_bw
    t = max(t_comp, t_mem) * bh
    dram *= bh
    divs = p * f * bh
    maccs = (ops_mxu) * bh
    sfu = (ops_1d + ops_corr) * bh
    glb = dram + (p * (m // m0) * 8) * eb * bh          # tiles + running state
    energy = (dram * arch.e_dram_byte + glb * arch.e_glb_byte
              + maccs * arch.e_macc + sfu * arch.e_sfu
              + divs * arch.e_div) * 1e-12
    util = min(1.0, t_comp / (t / bh))
    return Result(t, energy, util, util, dram, t_comp >= t_mem)


def linear_layers(w: Workload, m: int,
                  arch: SpatialArch = SpatialArch(),
                  gemm_util: float = 0.85) -> Result:
    """Projections + deprojection + 2-layer FFN (identical mapping for all
    three designs; Timeloop-searched in the paper, §VI-C)."""
    s, d, dff = m, w.d_model, w.d_ff
    b = w.batch
    eb = arch.elem_bytes
    macs = b * s * (4 * d * d + 2 * d * dff)
    weights = (4 * d * d + 2 * d * dff) * eb            # read once per batch
    acts = b * s * (8 * d + 2 * dff) * eb               # in/out per GEMM
    dram = weights + acts
    t = max(macs / (arch.pe2d * gemm_util) / arch.freq_hz,
            dram / arch.dram_bw)
    energy = (dram * arch.e_dram_byte + 2 * dram * arch.e_glb_byte
              + macs * arch.e_macc) * 1e-12
    util = min(1.0, macs / arch.pe2d / arch.freq_hz / t)
    return Result(t, energy, util, 0.0, dram, True)


ATTENTION_MODELS = {
    "unfused": attention_unfused,
    "flat": attention_flat,
    "fusemax": attention_fusemax,
}


def attention_result(design: str, w: Workload, m: int,
                     arch: SpatialArch = SpatialArch()) -> Result:
    return ATTENTION_MODELS[design](w, m, arch)


def e2e_result(design: str, w: Workload, m: int,
               arch: SpatialArch = SpatialArch()) -> Result:
    a = attention_result(design, w, m, arch)
    l = linear_layers(w, m, arch)
    n = w.n_layers
    t = (a.time_s + l.time_s) * n
    e = (a.energy_j + l.energy_j) * n
    util2 = (a.util_2d * a.time_s + l.util_2d * l.time_s) / (
        a.time_s + l.time_s)
    util1 = a.util_1d * a.time_s / (a.time_s + l.time_s)
    return Result(t, e, util2, util1,
                  (a.dram_bytes + l.dram_bytes) * n, a.compute_bound)


def geomean(xs) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs))
