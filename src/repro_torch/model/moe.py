"""Mixture-of-Experts FFN: top-k routing, capacity-bounded scatter dispatch.

Port of ``repro.model.moe``, the switch-style load-balance loss
(``moe_ffn(..., return_aux=True)``) included; as in the reference, no
caller adds it to a loss.  As in the reference:

* the router is fp32 ``[d, E]``: softmax top-k, or (DeepSeek-V3, llama4)
  sigmoid scores with the top-k gates renormalised.  Ties break toward the
  lower expert index, as ``jax.lax.top_k`` breaks them: the top k come from
  a stable descending sort, never from ``torch.topk``'s unspecified order
  among equal values;
* groups are sequences: each batch row owns ``cap = max(4, ceil(S·k/E ·
  capacity_factor))`` slots per expert, so the capacity depends on the S
  the caller routes (the serving engine's pow2 prefill bucket, padding
  included; 1 a decode step).  A token's slot within its expert is the
  exclusive count of earlier (token, choice) picks of that expert over the
  flattened S·k axis; picks at slot >= cap are dropped and fall through
  with the residual;
* the expert FFN (SwiGLU) runs over every expert's whole capacity buffer,
  empty slots included, and the shared experts run densely and add.

The buffer is laid out ``[E, B, C, d]`` (the reference's ``[B, E, C,
d]`` with the expert axis first), so each expert product is one
``torch.bmm`` of the buffer viewed ``[E, B·C, d]`` against the weight as
stored (``[E, d, ff]`` / ``[E, ff, d]``): no layout copy of a weight is
made (one DeepSeek-V3 ``wi_gate`` is 15 GB in fp32).  The scatter is
``index_put_(accumulate=True)``: kept (expert, slot) pairs are unique and
a dropped pick adds an exact zero to the slot it was clamped onto, so the
sum is exact in any order, as the reference's ``.at[].add``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.model.layers import _ACTS, MLP, _param, mlp, normal_


class MoE(nn.Module):
    """Parameters under the reference's names (``moe_init``): ``router``
    [d, E] fp32, ``wi_gate`` / ``wi_up`` [E, d, ff], ``wo`` [E, ff, d],
    and with shared experts ``shared`` (an :class:`MLP` of width ff ·
    n_shared)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        mo = cfg.moe
        d, ff, e = cfg.d_model, mo.d_ff_expert, mo.n_experts
        self.router = _param((d, e), torch.float32, device)
        self.wi_gate = _param((e, d, ff), dtype, device)
        self.wi_up = _param((e, d, ff), dtype, device)
        self.wo = _param((e, ff, d), dtype, device)
        if gen is not None:
            for w, fan_in in ((self.router, d), (self.wi_gate, d),
                              (self.wi_up, d), (self.wo, ff)):
                normal_(w, 1.0 / math.sqrt(fan_in), gen)
        if mo.n_shared:
            self.shared = MLP(d, ff * mo.n_shared, dtype=dtype,
                              device=device, gen=gen)


def _top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, mo: MoEConfig):
    """Return (gates [.., k], experts [.., k], probs [.., E])."""
    if mo.router == "sigmoid":                      # DeepSeek-V3
        scores = torch.sigmoid(logits)
        gates, experts = _top_k(scores, mo.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, experts = _top_k(probs, mo.top_k)
        if mo.top_k > 1:
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
    return gates, experts, probs


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig,
            return_aux: bool = False):
    """x: [B, S, d] → [B, S, d]; each batch row is one capacity group.
    With ``return_aux`` also the switch-style load-balance loss
    ``E · Σ_e f_e · p_e · aux_loss_weight`` (f: the share of picks, p: the
    mean routing probability of expert e)."""
    mo = cfg.moe
    b, s, d = x.shape
    e, k = mo.n_experts, mo.top_k
    cap = max(4, int(math.ceil(s * k / e * mo.capacity_factor)))
    dt = x.dtype

    logits = x.float() @ p.router                            # [B, S, E]
    gates, experts, probs = _route(logits, mo)               # [B, S, k]

    # slot: exclusive count of each expert over the flattened (S·k) axis
    flat_e = experts.reshape(b, s * k)                       # [B, T]
    oh = F.one_hot(flat_e, e)                                # [B, T, E]
    pos = torch.cumsum(oh, dim=1) - oh
    slot = pos.gather(-1, flat_e[..., None])[..., 0]         # [B, T]
    keep = slot < cap
    slot = torch.clamp(slot, max=cap - 1)

    # dispatch: token copies into [E, B, C, d]; a dropped copy adds 0
    xe = x[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    xe = xe * keep[..., None].to(dt)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = torch.zeros((e, b, cap, d), dtype=dt, device=x.device)
    buf.index_put_((flat_e, bidx, slot), xe, accumulate=True)

    # expert FFN (SwiGLU): [E, B·C, d] against each expert's weights
    act = _ACTS[cfg.mlp_act]
    xb = buf.view(e, b * cap, d)
    h = act(torch.bmm(xb, p.wi_gate.to(dt))) * torch.bmm(xb, p.wi_up.to(dt))
    out = torch.bmm(h, p.wo.to(dt)).view(e, b, cap, d)

    # combine: gather the slots back, weighted by the gates
    gathered = out[flat_e, bidx, slot]                       # [B, T, d]
    w = keep.to(gates.dtype) * gates.reshape(b, s * k)
    y = (gathered * w[..., None].to(dt)).reshape(b, s, k, d).sum(dim=2)

    if hasattr(p, "shared"):
        y = y + mlp(p.shared, x, cfg.mlp_act)
    if not return_aux:
        return y
    me = probs.float().mean(dim=(0, 1))                      # mean prob [E]
    ce = F.one_hot(experts, e).float().sum(dim=2).mean(dim=(0, 1)) / k
    return y, e * (me * ce).sum() * mo.aux_loss_weight
