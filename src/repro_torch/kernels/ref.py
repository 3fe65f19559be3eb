"""Plain-torch oracles for the FuseMax kernels.

The reference is the 3-pass numerically-stable cascade (Cascade 4) in
float32 with multi-head/GQA batching — global max (Eq. 33), stable
numerator/denominator (Eqs. 34-35), eager division (Eq. 36).  Port of
``repro.kernels.ref``; every kernel and plain 1-pass path is held to it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.einsum import Cascade
from repro_torch.core.taxonomy import attention_3pass

NEG_INF = -1e30


def reference_cascade() -> Cascade:
    """Declared cascade of this kernel family (checked by the analyzer).

    Both oracles below evaluate Cascade 4 verbatim — global max (Eq. 33),
    stable numerator/denominator (Eqs. 34-35), eager division (Eq. 36) —
    which is the 3-pass point of the taxonomy: SN must stay live across
    the divide, so the M fiber's footprint is O(S).
    """
    return attention_3pass()


def mha_reference(
    q: torch.Tensor,   # [B, Hq, P, E]
    k: torch.Tensor,   # [B, Hkv, M, E]
    v: torch.Tensor,   # [B, Hkv, M, F]
    *,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Grouped-query attention oracle. Returns [B, Hq, P, F] in q.dtype."""
    b, hq, p, e = q.shape
    _, hkv, m, f = v.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    group = hq // hkv

    qf = q.float().reshape(b, hkv, group, p, e)
    kf = k.float()
    vf = v.float()
    s = scale if scale is not None else 1.0 / (e ** 0.5)

    logits = torch.einsum("bhgpe,bhme->bhgpm", qf, kf) * s
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)

    qpos = torch.arange(p, device=q.device)[:, None] + q_offset
    kpos = torch.arange(m, device=q.device)[None, :]
    ok = torch.ones((p, m), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    logits = torch.where(ok, logits, torch.full((), NEG_INF, device=q.device))

    gm = logits.amax(dim=-1, keepdim=True)                # Eq. 33
    sn = torch.exp(logits - gm)                           # Eq. 34
    sd = sn.sum(dim=-1, keepdim=True)                     # Eq. 35
    a = sn / sd                                           # Eq. 36
    out = torch.einsum("bhgpm,bhmf->bhgpf", a, vf)        # Eq. 24
    return out.reshape(b, hq, p, f).to(q.dtype)


def decode_reference(
    q: torch.Tensor,        # [B, Hq, 1, E]
    k: torch.Tensor,        # [B, Hkv, M, E]
    v: torch.Tensor,        # [B, Hkv, M, F]
    kv_len: Optional[torch.Tensor] = None,  # [B] valid KV lengths
    **kwargs,
) -> torch.Tensor:
    """Decode-shape oracle: one query vs. a (possibly ragged) KV fiber."""
    if kv_len is None:
        return mha_reference(q, k, v, **kwargs)
    m = k.shape[-2]
    ar = torch.arange(m, device=k.device)[None, :]
    valid = ar < kv_len[:, None]                          # [B, M]
    window = kwargs.get("window")
    if window is not None:
        # the query is the newest token: position kv_len - 1 (per batch)
        qpos = kv_len[:, None] - 1
        valid &= ar > qpos - window
    km = torch.where(valid[:, None, :, None], k, torch.zeros((), dtype=k.dtype,
                                                             device=k.device))
    big_neg = torch.where(valid, 0.0, NEG_INF)            # additive [B, M]
    b, hq, p, e = q.shape
    _, hkv, _, f = v.shape
    group = hq // hkv
    s = kwargs.get("scale") or 1.0 / (e ** 0.5)
    logits = torch.einsum(
        "bhgpe,bhme->bhgpm",
        q.float().reshape(b, hkv, group, p, e),
        km.float(),
    ) * s
    softcap = kwargs.get("softcap")
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits + big_neg[:, None, None, None, :]
    gm = logits.amax(dim=-1, keepdim=True)
    sn = torch.exp(logits - gm)
    a = sn / sn.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgpm,bhmf->bhgpf", a, v.float())
    return out.reshape(b, hq, p, f).to(q.dtype)
