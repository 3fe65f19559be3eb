"""GQA attention on the FuseMax kernels, dense cache layout.

Port of the global-attention GQA paths of ``repro.model.attention``:
``wq [d, h, dh]``, ``wk``/``wv [d, hkv, dh]``, ``wo [h, dh, d]``; RoPE at
the absolute position, applied before K is cached so reads need no
rotation.  Attention runs through :mod:`repro_torch.kernels.ops` with
``Runtime.attn_impl``.

Cache protocol (dense layout, global layers): ``{"k", "v": [B, Hkv, Mmax,
dh]}``, one row per batch slot.  The port updates caches *in place*
(``index_put_`` / slice assignment) where the reference returns new
arrays under buffer donation; every function still returns the cache so
the call sites read the same.

Not ported yet (ROADMAP "Modules still to port"): sliding-window ring
caches, the paged layout, verify, MLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels.ops import fusemax_attention, fusemax_decode
from repro_torch.model.layers import Runtime, _param, normal_, rope


class GQA(nn.Module):
    """Parameters of one GQA layer under the reference's names/layouts."""

    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        self.wq = _param((d, h, dh), dtype, device)
        self.wk = _param((d, hkv, dh), dtype, device)
        self.wv = _param((d, hkv, dh), dtype, device)
        self.wo = _param((h, dh, d), dtype, device)
        if gen is not None:
            s = 1.0 / math.sqrt(d)
            for w in (self.wq, self.wk, self.wv):
                normal_(w, s, gen)
            normal_(self.wo, 1.0 / math.sqrt(h * dh), gen)


def gqa_init(cfg: ModelConfig, *, dtype, device,
             gen: Optional[torch.Generator] = None) -> GQA:
    return GQA(cfg, dtype=dtype, device=device, gen=gen)


def _proj_qkv(p: GQA, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bhse", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhe->bhse", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhe->bhse", x, p.wv.to(dt))
    q = rope(q, positions[:, None, :], cfg.rope_theta)
    k = rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _out_proj(p: GQA, out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhse,hed->bsd", out, p.wo.to(out.dtype))


def gqa_forward(p: GQA, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                rt: Runtime, positions: Optional[torch.Tensor] = None,
                qkv=None) -> torch.Tensor:
    """Full-sequence (training / prefill) attention. x: [B, S, d].
    ``qkv`` passes projections the caller already computed."""
    b, s_len, _ = x.shape
    if qkv is None:
        if positions is None:
            positions = torch.arange(s_len, device=x.device).expand(b, s_len)
        qkv = _proj_qkv(p, x, cfg, positions)
    q, k, v = qkv
    out = fusemax_attention(
        q, k, v,
        causal=cfg.causal,
        window=spec.window,
        softcap=cfg.attn_softcap,
        impl=rt.attn_impl,
        block_q=rt.block_q,
        block_k=rt.block_k,
        exp_impl=rt.exp_impl,
    )                                                    # [B, H, S, dh]
    return _out_proj(p, out)


def gqa_init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                   max_len: int, dtype, device) -> dict:
    slots = spec.window if spec.window is not None else max_len
    shape = (batch, cfg.n_kv_heads, slots, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill_chunk(p: GQA, x: torch.Tensor, cache: dict, off: int,
                      cfg: ModelConfig, spec: LayerSpec, rt: Runtime):
    """Chunked-prefill continuation of a global layer: queries [off, off+S)
    attend the cached history plus the chunk, whose K/V are written into
    the cache first.  x: [B, S, d]."""
    if spec.window is not None:
        raise NotImplementedError(
            "windowed ring caches are not ported yet (ROADMAP §1 item 2, "
            "windows and softcaps)")
    b, s_len, _ = x.shape
    positions = torch.arange(off, off + s_len, device=x.device).expand(
        b, s_len)
    q, k_new, v_new = _proj_qkv(p, x, cfg, positions)
    kc, vc = cache["k"], cache["v"]
    kc[:, :, off:off + s_len] = k_new
    vc[:, :, off:off + s_len] = v_new
    out = fusemax_attention(
        q, kc[:, :, :off + s_len], vc[:, :, :off + s_len],
        causal=cfg.causal, softcap=cfg.attn_softcap, q_offset=off,
        impl=rt.attn_impl, block_q=rt.block_q, block_k=rt.block_k,
        exp_impl=rt.exp_impl,
    )
    return _out_proj(p, out), cache


def gqa_decode(p: GQA, x: torch.Tensor, cache: dict, kv_len: torch.Tensor,
               cfg: ModelConfig, spec: LayerSpec, rt: Runtime):
    """One-token decode. x: [B, 1, d]; kv_len: [B] length *including* x.
    The new K/V land at slot ``(kv_len - 1) % slots`` (an empty slot with
    kv_len = 0 writes the last slot, as in the reference)."""
    if spec.window is not None:
        raise NotImplementedError(
            "windowed ring caches are not ported yet (ROADMAP §1 item 2, "
            "windows and softcaps)")
    b = x.shape[0]
    pos = (kv_len.long() - 1)[:, None]                   # [B, 1]
    q, k_new, v_new = _proj_qkv(p, x, cfg, pos)          # [B, H*, 1, dh]
    slots = cache["k"].shape[2]
    slot = pos[:, 0] % slots
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, :, slot] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][bidx, :, slot] = v_new[:, :, 0].to(cache["v"].dtype)
    out = fusemax_decode(
        q, cache["k"], cache["v"], kv_len,
        softcap=cfg.attn_softcap,
        impl=rt.attn_impl,
        splits=rt.decode_splits,
        exp_impl=rt.exp_impl,
    )                                                    # [B, H, 1, dh]
    return _out_proj(p, out), cache
