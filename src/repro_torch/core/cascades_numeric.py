"""Numeric (torch) implementations of the attention cascade taxonomy (§IV).

Port of ``repro.core.cascades_numeric``.  Each function computes *exactly*
the cascade of Einsums with the same name in
:mod:`repro_torch.core.taxonomy` — same intermediates, same
reassociations — so that tests can assert (a) all variants are
numerically equivalent and (b) the op-count / traffic claims of the paper
(division deferral saves ``M/F``× divisions; the 1-pass cascade never
materializes an O(M) intermediate per fiber).

Shapes follow the paper's rank names:

    Q : [..., P, E]     (P = query positions, E = head dim)
    K : [..., M, E]     (M = key positions / sequence length)
    V : [..., M, F]     (F = value head dim)
    out AV : [..., P, F]

Masking (causal / sliding window) and logit softcap (Gemma-2) are folded
in *before* the max/exp steps so that every cascade remains numerically
stable and they all stay equivalent.  Every tensor a function makes (the
masks, the running state) is made on ``q.device`` in ``q.dtype``: the
cascades run where their inputs lie, the CPU or the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1e30  # large-but-finite: keeps (x - max) well-defined when a
                 # whole row is masked (decode with short prefixes).


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Options shared by every cascade implementation."""

    causal: bool = False
    #: sliding-window size (keys attend within [q - window + 1, q]); None=off
    window: Optional[int] = None
    #: Gemma-2 style logit soft-capping: cap * tanh(logits / cap); None=off
    softcap: Optional[float] = None
    #: 1/sqrt(E) scaling; paper §IV-C1 notes stable softmax makes it optional
    scale: Optional[float] = None
    #: absolute query-position offset (for decode: q position = offset + i)
    q_offset: int = 0


def _logit_mask(spec: AttnSpec, p: int, m: int, dtype: torch.dtype,
                device: torch.device) -> Optional[torch.Tensor]:
    """Additive mask [P, M] on ``device``, or None."""
    if not spec.causal and spec.window is None:
        return None
    qpos = torch.arange(p, device=device)[:, None] + spec.q_offset
    kpos = torch.arange(m, device=device)[None, :]
    ok = torch.ones((p, m), dtype=torch.bool, device=device)
    if spec.causal:
        ok &= kpos <= qpos
    if spec.window is not None:
        ok &= kpos > qpos - spec.window
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(ok, zero, torch.full((), NEG_INF, dtype=dtype,
                                            device=device))


def _scale(spec: AttnSpec, e: int) -> float:
    return spec.scale if spec.scale is not None else 1.0 / (e ** 0.5)


def _qk(q: torch.Tensor, k: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """Eq. 22 (+ masking/softcap): QK[m, p] — here laid out [..., P, M]."""
    logits = torch.einsum("...pe,...me->...pm", q, k) * _scale(spec,
                                                              q.shape[-1])
    if spec.softcap is not None:
        logits = spec.softcap * torch.tanh(logits / spec.softcap)
    mask = _logit_mask(spec, q.shape[-2], k.shape[-2], logits.dtype,
                       q.device)
    if mask is not None:
        logits = logits + mask
    return logits


def _blocks(m: int, block: int) -> tuple[int, int]:
    """(M1, M0) of the partition M → (M1, M0)."""
    m0 = min(block, m)
    if m % m0:
        raise ValueError(f"M={m} not divisible by block={m0}")
    return m // m0, m0


# ---------------------------------------------------------------------------
# 3-pass cascade (Cascade 4) — PyTorch/TF/FLAT-style
# ---------------------------------------------------------------------------

def attention_3pass(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: AttnSpec = AttnSpec(),
    *,
    deferred_division: bool = False,
) -> torch.Tensor:
    """The straightforward numerically-stable cascade (Eqs. 33-36).

    Pass 1: GM = max_m QK;  Pass 2: SN = exp(QK - GM), SD = Σ_m SN;
    Pass 3: A = SN / SD, AV = Σ_m A·V.  With ``deferred_division`` (§IV-D)
    the divide happens after the AV contraction (F·P instead of M·P
    divisions) and the cascade becomes 2-pass.
    """
    qk = _qk(q, k, spec)                                     # [..., P, M]
    gm = qk.amax(dim=-1, keepdim=True)                       # Eq. 33
    sn = torch.exp(qk - gm)                                  # Eq. 34
    sd = sn.sum(dim=-1, keepdim=True)                        # Eq. 35
    if deferred_division:
        snv = torch.einsum("...pm,...mf->...pf", sn, v)      # Eq. 31
        return snv / sd                                      # Eq. 32
    a = sn / sd                                              # Eq. 36
    return torch.einsum("...pm,...mf->...pf", a, v)          # Eq. 24


# ---------------------------------------------------------------------------
# 2-pass cascade (§IV-E2) — TileFlow / Choi et al.-style
# ---------------------------------------------------------------------------

def attention_2pass(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: AttnSpec = AttnSpec(),
    *,
    block: int = 128,
    deferred_division: bool = True,
) -> torch.Tensor:
    """Partition M → (M1, M0); pass 1 computes per-partition local max /
    numerator / denominator (building the global max alongside); pass 2
    corrects every partition with the global max and reduces."""
    m1, m0 = _blocks(k.shape[-2], block)

    qk = _qk(q, k, spec)                                     # [..., P, M]
    bqk = qk.reshape(*qk.shape[:-1], m1, m0)                 # [..., P, M1, M0]
    bv = v.reshape(*v.shape[:-2], m1, m0, v.shape[-1])       # [..., M1, M0, F]

    # -- pass 1: local quantities -----------------------------------------
    lm = bqk.amax(dim=-1)                                    # [..., P, M1]
    sln = torch.exp(bqk - lm[..., None])                     # local numerator
    sld = sln.sum(dim=-1)                                    # local denom
    gm = lm.amax(dim=-1, keepdim=True)                       # global max
    # -- inter-pass bookkeeping over (M1, P): O(M/M0), not a pass ---------
    cf = torch.exp(lm - gm)                                  # correction
    sd = (sld * cf).sum(dim=-1, keepdim=True)                # global denom
    # -- pass 2: correct and reduce ---------------------------------------
    if deferred_division:
        snv = torch.einsum("...pnm,...nmf->...pf", sln * cf[..., None], bv)
        return snv / sd
    a = sln * cf[..., None] / sd[..., None]
    return torch.einsum("...pnm,...nmf->...pf", a, bv)


# ---------------------------------------------------------------------------
# 1-pass cascade (Cascade 5) — FlashAttention-2, adopted by FuseMax
# ---------------------------------------------------------------------------

def attention_1pass(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    spec: AttnSpec = AttnSpec(),
    *,
    block: int = 128,
) -> torch.Tensor:
    """Iterative 1-pass cascade (Eqs. 37-54), a loop over M1 (the
    reference's ``lax.scan``).

    Per iteration m1 the running max / denominator / numerator-times-V are
    corrected by ``PRM = exp(RM_old - RM_new)`` and accumulated; the single
    division (deferred, Eq. 53) happens once at the end.  The carried state
    is O(P·F) — independent of sequence length, the paper's headline
    property.
    """
    m1, m0 = _blocks(k.shape[-2], block)
    p, f = q.shape[-2], v.shape[-1]
    batch = q.shape[:-2]
    scale = _scale(spec, q.shape[-1])
    mask = _logit_mask(spec, p, m1 * m0, q.dtype, q.device)  # [P, M] or None

    bk = k.reshape(*batch, m1, m0, k.shape[-1])              # Eq. 37
    bv = v.reshape(*batch, m1, m0, f)                        # Eq. 38

    rm = torch.full((*batch, p), NEG_INF, dtype=q.dtype,
                    device=q.device)                         # Eq. 39
    rd = torch.zeros((*batch, p), dtype=q.dtype, device=q.device)  # Eq. 40
    rnv = torch.zeros((*batch, p, f), dtype=q.dtype,
                      device=q.device)                       # Eq. 41
    for i in range(m1):
        bqk = torch.einsum("...pe,...me->...pm", q,
                           bk[..., i, :, :]) * scale          # Eq. 42
        if spec.softcap is not None:
            bqk = spec.softcap * torch.tanh(bqk / spec.softcap)
        if mask is not None:
            bqk = bqk + mask[:, i * m0:(i + 1) * m0]
        lm = bqk.amax(dim=-1)                                 # Eq. 43
        rm_new = torch.maximum(rm, lm)                        # Eq. 44
        sln = torch.exp(bqk - rm_new[..., None])              # Eq. 45
        sld = sln.sum(dim=-1)                                 # Eq. 46
        slnv = torch.einsum("...pm,...mf->...pf", sln,
                            bv[..., i, :, :])                 # Eq. 47
        prm = torch.exp(rm - rm_new)                          # Eq. 48
        spd = rd * prm                                        # Eq. 49
        rd = sld + spd                                        # Eq. 50
        spnv = rnv * prm[..., None]                           # Eq. 51
        rnv = slnv + spnv                                     # Eq. 52
        rm = rm_new
    return rnv / rd[..., None]                                # Eq. 53


# ---------------------------------------------------------------------------
# Decode-shaped attention: one new query against a long KV fiber
# ---------------------------------------------------------------------------

def attention_decode_1pass(
    q: torch.Tensor,        # [..., 1, E]
    k: torch.Tensor,        # [..., M, E]
    v: torch.Tensor,        # [..., M, F]
    spec: AttnSpec = AttnSpec(),
    *,
    splits: int = 8,
) -> torch.Tensor:
    """Split-K ("flash-decoding") evaluation of the 1-pass cascade.

    The running-max algebra of Cascade 5 is associative: partial
    (RM, RD, RNV) triples from disjoint M chunks combine exactly like one
    more iteration.  We exploit that for decode, where P=1 gives no row
    parallelism: evaluate per-split partials in parallel, then combine —
    a two-level instantiation of the same cascade.
    """
    m = k.shape[-2]
    if m % splits:
        raise ValueError(f"M={m} not divisible by splits={splits}")
    ms = m // splits
    batch = q.shape[:-2]
    f = v.shape[-1]

    ks = k.reshape(*batch, splits, ms, k.shape[-1])
    vs = v.reshape(*batch, splits, ms, f)

    logits = torch.einsum("...pe,...sme->...spm", q, ks) * _scale(
        spec, q.shape[-1])
    if spec.softcap is not None:
        logits = spec.softcap * torch.tanh(logits / spec.softcap)
    mask = _logit_mask(spec, q.shape[-2], m, q.dtype, q.device)
    if mask is not None:
        mask_s = mask.reshape(q.shape[-2], splits, ms)
        logits = logits + torch.movedim(mask_s, -2, -3)

    lm = logits.amax(dim=-1)                        # [..., S, P]
    sln = torch.exp(logits - lm[..., None])
    sld = sln.sum(dim=-1)                           # [..., S, P]
    slnv = torch.einsum("...spm,...smf->...spf", sln, vs)

    gm = lm.amax(dim=-2, keepdim=True)              # combine: global max
    cf = torch.exp(lm - gm)                         # per-split correction
    rd = (sld * cf).sum(dim=-2)                     # [..., P]
    rnv = (slnv * cf[..., None]).sum(dim=-3)        # [..., P, F]
    return rnv / rd[..., None]


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    spec: AttnSpec = AttnSpec()
) -> torch.Tensor:
    """The oracle: the 3-pass cascade evaluated in float32, or in float64
    for float64 inputs (the card's float64 reference)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    out = attention_3pass(q.to(acc), k.to(acc), v.to(acc), spec)
    return out.to(q.dtype)


def division_counts(m: int, p: int, f: int) -> dict[str, int]:
    """§IV-D: divisions needed with/without deferral (M·P vs F·P)."""
    return {"eager": m * p, "deferred": f * p, "savings_factor": m // max(f, 1)}
