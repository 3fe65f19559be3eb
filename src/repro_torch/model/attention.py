"""GQA and MLA attention on the FuseMax kernels.

Port of the GQA paths of ``repro.model.attention`` (global and
sliding-window layers) and of its MLA paths on the dense and the paged
layout.  GQA:
``wq [d, h, dh]``, ``wk``/``wv [d, hkv, dh]``, ``wo [h, dh, d]``; RoPE at
the absolute position, applied before K is cached so reads need no
rotation.  Attention runs through :mod:`repro_torch.kernels.ops` with
``Runtime.attn_impl``.

Cache protocols:

* dense — ``{"k", "v": [B, Hkv, Mmax, dh]}`` (MLA: ``{"ckv": [B, Mmax,
  r], "krope": [B, Mmax, rd]}``), one row per batch slot; a
  sliding-window (local) layer keeps a *ring* of ``window`` slots instead,
  token at position ``t`` in slot ``t % window``, and decode reads
  ``min(kv_len, window)`` slots with no window mask (the ring holds
  exactly the in-window keys);
* paged — ``{"k_pages", "v_pages": [P + 1, page_size, Hkv, dh]}``: the
  pool's ``P`` pages plus one *sink* page at index ``P``.  Block tables
  (``[B, W]`` int32, host-managed by :mod:`repro_torch.serving.kv_cache`)
  map logical token ``l = position % capacity`` to ``(table[b, l //
  page_size], l % page_size)`` (capacity: the window for local layers,
  whose table class ``"w<window>"`` is a ring of ``ceil(window /
  page_size)`` pages; the table span for global ones) and hold the
  sentinel id ``P`` where no page backs them.  The reference drops masked
  and sentinel writes with a ``mode="drop"`` scatter; torch has none, and
  a boolean-masked write would cost a device→host sync per layer, so the
  port routes them into the sink page instead.  Every read sees pages
  ``0..P-1`` only (sentinel reads clamp to ``P - 1``).  The dense ring
  has no sink row: its masked writes (:func:`ring_write_masked`) select
  per slot instead.

The port updates caches *in place* (``index_put_`` / slice assignment)
where the reference returns new arrays under buffer donation; every
function still returns the cache so the call sites read the same.

MLA (DeepSeek multi-head latent attention, ``MLAAttention``): queries
through a low-rank ``w_dq``/``q_norm``/``w_uq``; keys and values from one
latent ``ckv = kv_norm(x w_dkv[:, :r])`` plus a shared rope key.  A
prompt's first chunk runs the per-head expanded form (:func:`mla_forward`,
K1 at (E, F) = (nope + rope, v)); a continuation chunk and every decode
step run the absorbed form against the latent history (K1 at (r + rd, r)
through :func:`_mla_absorbed_attend`; decode through
``ops.fusemax_decode_latent``, K2's E ≠ F branch, on the dense latent
cache, or K4 through ``ops.fusemax_mla_decode_paged``).  Its paged pool
is ``{"ckv_pages":
[P + 1, page_size, r], "krope_pages": [P + 1, page_size, rd]}``, sink page
included, in the "full" class.

Quantized page pools (``kv_dtype`` "fp8_e4m3" or "int8"): the pages hold
codes in ``torch.float8_e4m3fn`` / ``torch.int8`` and a parallel fp16
*scale pool* rides beside each — ``k_scale`` / ``v_scale [P + 1,
page_size, Hkv]`` for GQA (one scale per token and kv head),
``ckv_scale`` / ``krope_scale [P + 1, page_size]`` for MLA (one per
latent and per rope vector).  :func:`quantize_kv` is symmetric per token
over the feature axis, with the scale rounded to fp16 *before* the codes
are computed, so codes and scales equal the reference's bit for bit.
Dequantization happens where pages are read (K3 / K4, and the gathered
history of a prefill chunk), never in storage: COW copies, swap blobs
and the prefix hash all see raw codes.  A continuation chunk attends its
own K/V quant-round-tripped, as the reference does, so it sees exactly
what later reads reconstruct.

A device-sharded pool (``Runtime.kv_shard``, a
:class:`repro_torch.distributed.sharding.KVShard` of ``tp`` devices)
keeps each page array as ``tp`` tensors, shard ``d`` on ``devices[d]``
with its own sink page: GQA pools split on the kv-head axis, MLA latent
pools on the rank axis, MLA scale pools stay whole on the engine's
device.  GQA prefill and decode run head-parallel
(:func:`_over_head_shards`): each shard takes its slice of the query and
fresh K/V heads, writes its pages and runs K1 (prefill; at ``off == 0``
too, as the reference's sharded path does) or K3 (decode) on them, and
the heads concatenate in shard order before the replicated ``wo``.  MLA
writes rank slices; a continuation chunk reads the rank-complete view of
its history (the reference's all-gather); a decode step makes that view
of the whole table and each shard sweeps one contiguous strip of K4's
page-aligned splits with the latent kernel
(``ops.fusemax_mla_decode_strip``), and the strips' partials combine
once.  Every shard computes exactly what the unsharded call computes for
its heads or splits, so greedy streams equal the unsharded pool's bit
for bit.

Speculative verify (:func:`gqa_verify`, :func:`gqa_verify_paged`,
:func:`mla_verify`, :func:`mla_verify_paged`) scores a P-token chain in
one call: chain position j sits at ``kv_len - 1 + j`` and attends keys
``< kv_len + j`` through the same kernels as decode, at P·G (GQA) or
P·H (MLA) query rows.  Positions at or past a row's ``span`` must not
land: on the pages they go to the sink page; the dense cache has no sink
row, so :func:`write_chain_dense` writes a window of distinct in-range
slots per row, each keeping its old value where no kept position maps to
it.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distributed.sharding import (
    DenseCacheShards, KVShard, leaf_parts, shard_slice,
)
from repro_torch.kernels.ops import (
    combine_strips, fusemax_attention, fusemax_decode, fusemax_decode_latent,
    fusemax_decode_seq_sharded,
    fusemax_decode_paged, fusemax_mla_decode_paged, fusemax_mla_decode_strip,
    gather_pages, mla_strips,
)
from repro_torch.model.layers import (
    Norm, Runtime, _param, apply_norm, normal_, rope, tp_count,
)


# ---------------------------------------------------------------------------
# KV-page quantization
# ---------------------------------------------------------------------------

#: fp16's smallest subnormal, 2**-24: the floor of a stored scale (torch's
#: ``finfo`` has no ``smallest_subnormal``)
FP16_SMALLEST_SUBNORMAL = 2.0 ** -24


def kv_quant_dtype(kv_dtype: Optional[str]) -> Optional[torch.dtype]:
    """Resolve a ``kv_dtype`` name to its storage dtype (None → None)."""
    if kv_dtype is None:
        return None
    if kv_dtype == "fp8_e4m3":
        return torch.float8_e4m3fn
    if kv_dtype == "int8":
        return torch.int8
    raise ValueError(f"unknown kv_dtype {kv_dtype!r} (fp8_e4m3 | int8)")


def _kv_qmax(qdtype: torch.dtype) -> float:
    """Largest magnitude of the storage grid: 127 for int8, 448 for fp8
    e4m3."""
    return 127.0 if qdtype == torch.int8 else 448.0


def quantize_kv(values: torch.Tensor, qdtype: torch.dtype):
    """Symmetric per-token quantization over the trailing feature axis:
    ``[..., feat]`` → (codes ``[..., feat]`` in ``qdtype``, scales
    ``[...]`` fp16) with ``scale = amax / qmax`` (1 for an all-zero
    token), rounded to fp16 before the codes are computed and floored at
    fp16's smallest subnormal.  int8 rounds half to even, as
    ``jnp.round`` does; fp8 takes the cast's rounding after the clip to
    ±448."""
    v32 = values.float()
    qmax = _kv_qmax(qdtype)
    amax = v32.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / qmax,
                        torch.ones_like(amax)).to(torch.float16)
    scale = torch.clamp_min(scale, FP16_SMALLEST_SUBNORMAL)
    q = v32 / scale.float()[..., None]
    if qdtype == torch.int8:
        q = torch.round(q)
    return torch.clamp(q, -qmax, qmax).to(qdtype), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``q [..., feat] × scale [...]``,
    the product taken in fp32 (exact: at most 8 x 11 significant bits)."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def paged_cache_key(spec: LayerSpec) -> str:
    """Block-table key for a layer: windowed GQA layers share a table per
    window size; global GQA layers and every MLA layer share the "full"
    table (the reference's page classes)."""
    return "full" if spec.attn == "mla" or spec.window is None \
        else f"w{spec.window}"


def pool_pages(pages: torch.Tensor) -> torch.Tensor:
    """The readable pages of a pool allocated with its sink page
    (``[P + 1, ...]`` → the ``[P, ...]`` view, contiguous)."""
    return pages[:-1]


def page_slots(pages: torch.Tensor, bt_rows: torch.Tensor,
               positions: torch.Tensor, capacity: int,
               valid: Optional[torch.Tensor] = None):
    """Where per-token writes land in a pool allocated with its sink page:
    ``(page, offset)``, each shaped like ``positions``.  The logical index
    wraps at ``capacity``; tokens where ``valid`` is False go to the sink
    page ``P``, as do tokens behind a sentinel table entry (which *is*
    ``P``) — the reference's ``mode="drop"`` without a host sync."""
    sink = pages.shape[0] - 1
    page_size = pages.shape[1]
    l = positions.long() % capacity
    page = torch.gather(bt_rows.long(), 1, l // page_size)
    if valid is not None:
        page = torch.where(valid, page, sink)
    return page, l % page_size


def write_pages(pages: torch.Tensor, bt_rows: torch.Tensor,
                positions: torch.Tensor, values: torch.Tensor,
                capacity: int, valid: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Scatter per-token values into a page pool through block-table rows,
    in place.

    pages: ``[P + 1, page_size, *tail]`` (pool + sink page); bt_rows:
    ``[N, W]``; positions: ``[N, S]`` absolute token positions; values:
    ``[N, S, *tail]``.  Masked and sentinel writes land in the sink page
    (:func:`page_slots`), so pages ``0..P-1`` end exactly as the
    reference's.  Returns ``pages``."""
    page, off = page_slots(pages, bt_rows, positions, capacity, valid)
    pages[page, off] = values.to(pages.dtype)
    return pages


def write_chain_dense(cache: torch.Tensor, new: torch.Tensor,
                      kv_len: torch.Tensor, span: torch.Tensor) -> None:
    """Write a verify chain into a dense cache, in place: ``cache [B, M,
    *tail]`` (sequence on axis 1; a transposed view writes through),
    ``new [B, P, *tail]``, chain position j at ``kv_len - 1 + j``, kept
    where ``j < span`` and the position is below M — the reference's
    ``mode="drop"`` scatter without a host sync.  Each row rewrites the
    ``min(P, M)`` distinct slots from ``clamp(kv_len - 1, 0, M - P)``,
    which hold every kept position; a slot no kept position maps to takes
    its old value back, so no two writes of a row share a slot (a CUDA
    ``index_put`` with duplicate indices has no defined winner)."""
    b, m = cache.shape[:2]
    p = new.shape[1]
    w = min(p, m)
    dev = cache.device
    first = (kv_len.to(dev).long() - 1)[:, None]             # [B, 1]
    idx = torch.clamp(first, 0, m - w) + torch.arange(w, device=dev)
    j = idx - first                                          # chain pos
    keep = (j >= 0) & (j < span.to(dev).long()[:, None])     # [B, W]
    bidx = torch.arange(b, device=dev)[:, None]
    src = new[bidx, torch.clamp(j, 0, p - 1)].to(cache.dtype)
    keep = keep.view(b, w, *([1] * (new.dim() - 2)))
    cache[bidx, idx] = torch.where(keep, src, cache[bidx, idx])


def ring_write_masked(kc: torch.Tensor, vc: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor, off: int,
                      true_len: Optional[torch.Tensor] = None):
    """Write a prompt chunk's K/V ([B, Hkv, S, dh], positions [off, off +
    S)) into a dense ring cache ([B, Hkv, slots, dh]) under length-bucket
    padding, in place: per row, only positions that are real (< true_len;
    ``None``: every position of the chunk) and not already evicted by this
    chunk's own tail land — at most ``slots`` survivors, a contiguous run
    of positions, so no two share a slot.  The reference drops the others
    with a ``mode="drop"`` scatter; here each slot instead takes the one
    surviving position that maps to it, if any, and keeps its old value
    otherwise (no host sync).  Returns (kc, vc)."""
    b, _, s_len, _ = k_new.shape
    slots = kc.shape[2]
    tl = torch.full((b, 1), off + s_len, device=kc.device) \
        if true_len is None else true_len.to(kc.device).long()[:, None]
    hi = torch.clamp(tl, max=off + s_len)                    # survivors
    lo = torch.clamp(hi - slots, min=off)                    # [lo, hi)
    slot = torch.arange(slots, device=kc.device)[None, :]    # [1, slots]
    pos = lo + torch.remainder(slot - lo, slots)             # [B, slots]
    keep = (pos < hi)[:, None, :, None]
    idx = torch.clamp(pos - off, 0, s_len - 1)[:, None, :, None]
    for cache, new in ((kc, k_new), (vc, v_new)):
        src = torch.gather(new.to(cache.dtype), 2,
                           idx.expand(-1, new.shape[1], -1, new.shape[3]))
        cache.copy_(torch.where(keep, src, cache))
    return kc, vc


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
        tp = tp_count(rt)
        if tp > 1 and cfg.n_kv_heads % tp == 0:
            return _gqa_forward_shards(p, x, cfg, spec, rt, positions)
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


def _gqa_forward_shards(p: GQA, x: torch.Tensor, cfg: ModelConfig,
                        spec: LayerSpec, rt: Runtime,
                        positions: torch.Tensor) -> torch.Tensor:
    """:func:`gqa_forward` split over ``rt.tp_devices``: shard ``j`` takes
    its slice of the kv heads (and of the query heads that read them),
    projects QKV, runs the attention (one K1 launch on CUDA) and its part
    of the output projection on ``tp_devices[j]``; the partial outputs
    sum in shard order on x's device."""
    devs = rt.tp_devices
    tp = len(devs)
    out = None
    for j, dev in enumerate(devs):
        hs = shard_slice(cfg.n_heads, j, tp)
        ks = shard_slice(cfg.n_kv_heads, j, tp)
        part = SimpleNamespace(wq=p.wq[:, hs].to(dev), wk=p.wk[:, ks].to(dev),
                               wv=p.wv[:, ks].to(dev), wo=p.wo[hs].to(dev))
        rt_j = dataclasses.replace(rt, tp_devices=None)
        y = gqa_forward(part, x.to(dev), cfg, spec, rt_j,
                        positions=positions.to(dev)).to(x.device)
        out = y if out is None else out + y
    return out


def gqa_init_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                   max_len: int, dtype, device) -> dict:
    slots = spec.window if spec.window is not None else max_len
    shape = (batch, cfg.n_kv_heads, slots, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_prefill_chunk(p: GQA, x: torch.Tensor, cache: dict, off: int,
                      cfg: ModelConfig, spec: LayerSpec, rt: Runtime,
                      true_len: Optional[torch.Tensor] = None):
    """Chunked-prefill continuation: queries [off, off+S) attend the
    cached history plus the chunk.  A global layer writes the chunk's K/V
    into the cache first; a ring layer gathers its history band before
    the writes land and attends it with the window (K1 at ``q_offset =
    off - klo``), then writes the chunk into the ring, masked past each
    row's ``true_len`` when the batch is bucket-padded.  x: [B, S, d]."""
    b, s_len, _ = x.shape
    positions = torch.arange(off, off + s_len, device=x.device).expand(
        b, s_len)
    q, k_new, v_new = _proj_qkv(p, x, cfg, positions)
    kc, vc = cache["k"], cache["v"]
    kw = dict(causal=cfg.causal, softcap=cfg.attn_softcap,
              impl=rt.attn_impl, block_q=rt.block_q, block_k=rt.block_k,
              exp_impl=rt.exp_impl)
    if spec.window is None:
        kc[:, :, off:off + s_len] = k_new
        vc[:, :, off:off + s_len] = v_new
        out = fusemax_attention(q, kc[:, :, :off + s_len],
                                vc[:, :, :off + s_len], q_offset=off, **kw)
        return _out_proj(p, out), cache
    # the still-needed history band [klo, off) from ring slots position %
    # slots, gathered before the chunk's writes land
    klo = max(0, off - spec.window + 1)
    hist = torch.arange(klo, off, device=x.device) % kc.shape[2]
    out = fusemax_attention(
        q, torch.cat([kc[:, :, hist], k_new.to(kc.dtype)], dim=2),
        torch.cat([vc[:, :, hist], v_new.to(vc.dtype)], dim=2),
        window=spec.window, q_offset=off - klo, **kw)
    ring_write_masked(kc, vc, k_new, v_new, off, true_len)
    return _out_proj(p, out), cache


def gqa_decode(p: GQA, x: torch.Tensor, cache: dict, kv_len: torch.Tensor,
               cfg: ModelConfig, spec: LayerSpec, rt: Runtime):
    """One-token decode. x: [B, 1, d]; kv_len: [B] length *including* x.
    The new K/V land at slot ``(kv_len - 1) % slots`` (an empty slot with
    kv_len = 0 writes the last slot, as in the reference).  A ring layer
    reads ``min(kv_len, slots)`` slots, all in its window, with no window
    mask.  A cache split over the model axis
    (:class:`~repro_torch.distributed.sharding.DenseCacheShards`) runs
    per kv-head shard through :func:`_over_head_shards`, or on its slot
    strips (:func:`_gqa_decode_strips`)."""
    pos = (kv_len.long() - 1)[:, None]                   # [B, 1]
    q, k_new, v_new = _proj_qkv(p, x, cfg, pos)          # [B, H*, 1, dh]
    kc, vc = cache["k"], cache["v"]
    if isinstance(kc, DenseCacheShards) and kc.dim == 2:
        return _out_proj(p, _gqa_decode_strips(q, k_new, v_new, kc.parts,
                                               vc.parts, kv_len, cfg, spec,
                                               rt)), cache
    shard, parts = None, cache
    if isinstance(kc, DenseCacheShards):
        shard = KVShard(tuple(t.device for t in kc.parts))
        parts = {"k": kc.parts, "v": vc.parts}

    def write_attend(part: dict, q, k_new, v_new):
        kp, vp = part["k"], part["v"]
        slots = kp.shape[2]
        lens = kv_len.to(kp.device)
        slot = (lens.long() - 1) % slots
        bidx = torch.arange(q.shape[0], device=kp.device)
        kp[bidx, :, slot] = k_new[:, :, 0].to(kp.dtype)
        vp[bidx, :, slot] = v_new[:, :, 0].to(vp.dtype)
        eff_len = lens if spec.window is None \
            else torch.clamp(lens, max=slots)
        return fusemax_decode(q, kp, vp, eff_len, softcap=cfg.attn_softcap,
                              impl=rt.attn_impl, splits=rt.decode_splits,
                              exp_impl=rt.exp_impl)      # [B, H, 1, dh]

    out = _over_head_shards(shard, parts, write_attend, q, k_new, v_new)
    return _out_proj(p, out), cache


def _gqa_decode_strips(q: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, kparts: list, vparts: list,
                       kv_len: torch.Tensor, cfg: ModelConfig,
                       spec: LayerSpec, rt: Runtime) -> torch.Tensor:
    """:func:`gqa_decode`'s write and attention on a dense cache whose
    slots are split into strips over the model axis (the sequence-sharded
    fallback of :func:`~repro_torch.distributed.sharding.cache_shardings`):
    each row's new K/V land in the strip that holds its slot (the others
    rewrite what they hold), every strip computes its splits' partials on
    its device (:func:`~repro_torch.kernels.ops.fusemax_decode_seq_sharded`;
    a split count the strip count does not divide is refused) and one
    combine merges them."""
    b = q.shape[0]
    ms = kparts[0].shape[2]
    slots = ms * len(kparts)
    slot = (kv_len.long() - 1) % slots
    for d, (kp, vp) in enumerate(zip(kparts, vparts)):
        dev = kp.device
        local = (slot - d * ms).to(dev)
        mine = (local >= 0) & (local < ms)
        at = local.clamp(0, ms - 1)
        bidx = torch.arange(b, device=dev)
        for part, new in ((kp, k_new), (vp, v_new)):
            old = part[bidx, :, at]                        # [B, Hkv, dh]
            part[bidx, :, at] = torch.where(
                mine[:, None, None], new[:, :, 0].to(dev, part.dtype), old)
    eff_len = kv_len if spec.window is None \
        else torch.clamp(kv_len, max=slots)
    return fusemax_decode_seq_sharded(
        q, kparts, vparts, eff_len, softcap=cfg.attn_softcap,
        impl=rt.attn_impl, splits=rt.decode_splits, exp_impl=rt.exp_impl)


# ---------------------------------------------------------------------------
# GQA — paged cache variants
# ---------------------------------------------------------------------------

def gqa_init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                         dtype, device, kv_dtype: Optional[str] = None
                         ) -> dict:
    """A layer's page pool: ``num_pages`` pages plus the sink page; with
    ``kv_dtype`` the pages hold codes and fp16 scale pools ride beside
    them (sink page included)."""
    shape = (num_pages + 1, page_size, cfg.n_kv_heads, cfg.dh)
    qdt = kv_quant_dtype(kv_dtype)
    if qdt is None:
        return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                "v_pages": torch.zeros(shape, dtype=dtype, device=device)}
    ones = dict(dtype=torch.float16, device=device)
    return {"k_pages": torch.zeros(shape, dtype=qdt, device=device),
            "v_pages": torch.zeros(shape, dtype=qdt, device=device),
            "k_scale": torch.ones(shape[:-1], **ones),
            "v_scale": torch.ones(shape[:-1], **ones)}


def _gqa_capacity(cache: dict, bt_rows: torch.Tensor,
                  spec: LayerSpec) -> int:
    """Logical token capacity of a paged GQA cache: the window for local
    layers, the full table span for global layers."""
    page_size = leaf_parts(cache["k_pages"])[0].shape[1]
    return spec.window if spec.window is not None \
        else bt_rows.shape[1] * page_size


def _gqa_paged_attend(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, bt_rows: torch.Tensor,
                      off: int, cap: int, cfg: ModelConfig,
                      spec: LayerSpec, rt: Runtime,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Attention of a paged prefill chunk *before* its writes land:
    queries [off, off+S) attend the history gathered through the
    block-table rows plus the chunk's own K/V.  Returns the
    pre-projection output [B, H, S, F].  ``k_pages``/``v_pages`` are the
    readable ``[P, ...]`` pools; a ring layer (capacity ``cap``) reads
    the band [klo, off) at logical indices ``position % cap``.  A
    quantized pool passes its readable scale pools too: the gathered
    history is dequantized here (the caller passes the chunk's K/V
    quant-round-tripped)."""
    kw = dict(causal=cfg.causal, softcap=cfg.attn_softcap,
              impl=rt.attn_impl, block_q=rt.block_q, block_k=rt.block_k,
              exp_impl=rt.exp_impl)
    if off == 0:
        # no history: attend the chunk itself (as gqa_forward does)
        return fusemax_attention(q, k_new, v_new, window=spec.window, **kw)
    if spec.window is not None:
        # ring continuation: the still-needed band, through the table
        # rows (sentinel entries clamp to the last page, as gather_pages
        # does; only bucket-padding rows read them)
        w = spec.window
        klo = max(0, off - w + 1)
        ps = k_pages.shape[1]
        l = torch.arange(klo, off, device=q.device) % cap
        pg = torch.clamp(bt_rows.long()[:, l // ps], max=k_pages.shape[0] - 1)
        k_hist = k_pages[pg, l % ps].transpose(1, 2)     # [B, Hkv, band, dh]
        v_hist = v_pages[pg, l % ps].transpose(1, 2)
        if k_scale is not None:
            k_hist = dequantize_kv(
                k_hist, k_scale[pg, l % ps].transpose(1, 2), k_new.dtype)
            v_hist = dequantize_kv(
                v_hist, v_scale[pg, l % ps].transpose(1, 2), v_new.dtype)
        return fusemax_attention(
            q, torch.cat([k_hist, k_new.to(k_hist.dtype)], dim=2),
            torch.cat([v_hist, v_new.to(v_hist.dtype)], dim=2), window=w,
            q_offset=off - klo, **kw)
    # gather only the pages the prefix occupies (plain torch indexing, as
    # the reference gathers in jnp outside any kernel), then K1 with the
    # history offset
    hp = -(-off // k_pages.shape[1])
    k_hist = gather_pages(k_pages, bt_rows[:, :hp]).transpose(1, 2)
    v_hist = gather_pages(v_pages, bt_rows[:, :hp]).transpose(1, 2)
    k_hist, v_hist = k_hist[:, :, :off], v_hist[:, :, :off]
    if k_scale is not None:
        k_hist = dequantize_kv(k_hist, gather_pages(
            k_scale, bt_rows[:, :hp]).transpose(1, 2)[:, :, :off],
            k_new.dtype)
        v_hist = dequantize_kv(v_hist, gather_pages(
            v_scale, bt_rows[:, :hp]).transpose(1, 2)[:, :, :off],
            v_new.dtype)
    k = torch.cat([k_hist, k_new.to(k_hist.dtype)], dim=2)
    v = torch.cat([v_hist, v_new.to(v_hist.dtype)], dim=2)
    return fusemax_attention(q, k, v, q_offset=off, **kw)


def _gqa_quant_new(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor):
    """Quantize a chunk's fresh K/V ([B, Hkv, S, dh]) to the pool's
    storage dtype → (k_q, k_s, v_q, v_s, k_att, v_att): codes and
    per-(token, head) scales for the page writes, and the round-tripped
    values the chunk attends (what later reads reconstruct).  An
    unquantized pool returns the inputs with None scales."""
    if "k_scale" not in cache:
        return k_new, None, v_new, None, k_new, v_new
    qdt = cache["k_pages"].dtype
    k_q, k_s = quantize_kv(k_new, qdt)
    v_q, v_s = quantize_kv(v_new, qdt)
    return (k_q, k_s, v_q, v_s, dequantize_kv(k_q, k_s, k_new.dtype),
            dequantize_kv(v_q, v_s, v_new.dtype))


def _readable_scales(cache: dict, *names: str) -> list:
    """The readable ``[P, ...]`` views of a pool's scale pools (None each
    for an unquantized pool)."""
    return [pool_pages(cache[n]) if n in cache else None for n in names]


def _over_head_shards(shard, cache: dict, fn, *heads: torch.Tensor
                      ) -> torch.Tensor:
    """``fn(part, *heads)`` on the whole pool (``shard`` None), or once per
    shard of a head-sharded pool: shard ``d`` gets its page tensors and
    its slice of each ``[B, H*, ...]`` head tensor on its device, and the
    outputs concatenate on the head axis, in shard order, on the device
    of ``heads``."""
    if shard is None:
        return fn(cache, *heads)
    lead = heads[0].device
    outs = []
    for d, dev in enumerate(shard.devices):
        part = {name: leaf[d] for name, leaf in cache.items()}
        sliced = (t[:, shard_slice(t.shape[1], d, shard.size)].to(dev)
                  for t in heads)
        outs.append(fn(part, *sliced).to(lead))
    return torch.cat(outs, dim=1)


def gqa_prefill_paged(p: GQA, x: torch.Tensor, cache: dict,
                      bt_rows: torch.Tensor, off: int, cfg: ModelConfig,
                      spec: LayerSpec, rt: Runtime, true_len: torch.Tensor,
                      cached_len: Optional[torch.Tensor] = None):
    """Prefill a prompt chunk straight into the page pool: queries
    [off, off+S) attend history gathered through ``bt_rows`` plus the
    chunk; the chunk's K/V then scatter into pages, masked by
    ``true_len`` and by ``cached_len`` (positions below it live in pages
    mapped from the prefix index: read, never rewritten).  On a sharded
    pool (``rt.kv_shard``) each shard does so for its heads.  x: [B, S,
    d]."""
    b, s_len, _ = x.shape
    positions = torch.arange(off, off + s_len, device=x.device).expand(
        b, s_len)
    cap = _gqa_capacity(cache, bt_rows, spec)
    tl = true_len.to(x.device).long()[:, None]
    pos = positions[:1]                                   # [1, S]
    valid = (pos < tl) & (pos >= torch.clamp(tl, max=off + s_len) - cap)
    if cached_len is not None:
        valid = valid & (positions >= cached_len.to(x.device)[:, None])
    valid = valid.expand(b, s_len)

    q, k_new, v_new = _proj_qkv(p, x, cfg, positions)

    def attend_write(part: dict, q, k_new, v_new):
        dev = q.device
        bt = bt_rows.to(dev)
        k_q, k_s, v_q, v_s, k_att, v_att = _gqa_quant_new(part, k_new,
                                                          v_new)
        if off == 0:
            # the first chunk attends its K/V as computed, as the
            # reference's gqa_forward does (quantized or not)
            k_att, v_att = k_new, v_new
        ks, vs = _readable_scales(part, "k_scale", "v_scale")
        out = _gqa_paged_attend(q, k_att, v_att, pool_pages(part["k_pages"]),
                                pool_pages(part["v_pages"]), bt, off, cap,
                                cfg, spec, rt, k_scale=ks, v_scale=vs)
        for name, new in (("k_pages", k_q), ("v_pages", v_q),
                          ("k_scale", k_s), ("v_scale", v_s)):
            if new is not None:
                write_pages(part[name], bt, positions.to(dev),
                            new.transpose(1, 2), cap, valid.to(dev))
        return out

    out = _over_head_shards(rt.kv_shard, cache, attend_write, q, k_new, v_new)
    return _out_proj(p, out), cache


def decode_slots(cache: dict, bt_rows: torch.Tensor, kv_len: torch.Tensor,
                 spec: LayerSpec):
    """:func:`page_slots` of one decode step's new token (position
    ``kv_len - 1``; inactive slots with kv_len = 0 go to the sink), for a
    GQA or an MLA page pool.  The same for every layer of a capacity
    class, so a step computes it once per class."""
    pos = (kv_len.long() - 1)[:, None]
    if "ckv_pages" in cache:
        pages = leaf_parts(cache["ckv_pages"])[0]
        cap = bt_rows.shape[1] * pages.shape[1]
    else:
        pages = leaf_parts(cache["k_pages"])[0]
        cap = _gqa_capacity(cache, bt_rows, spec)
    return page_slots(pages, bt_rows, pos, cap, (kv_len > 0)[:, None])


def gqa_decode_paged(p: GQA, x: torch.Tensor, cache: dict,
                     bt_rows: torch.Tensor, kv_len: torch.Tensor,
                     cfg: ModelConfig, spec: LayerSpec, rt: Runtime,
                     slots=None):
    """One-token decode against the page pool: write the new K/V at the
    logical tail, read through the block table.  Inactive slots
    (kv_len = 0) drop their writes (into the sink page).  ``slots``: this
    step's :func:`decode_slots`, when the caller shares them across
    layers.  A ring layer writes at ``(kv_len - 1) % window`` and reads
    ``min(kv_len, window)`` logical tokens of its class's table.  On a
    sharded pool each shard writes and runs K3 for its heads.  x: [B, 1,
    d]."""
    pos = (kv_len.long() - 1)[:, None]                   # [B, 1]
    q, k_new, v_new = _proj_qkv(p, x, cfg, pos)          # [B, H*, 1, dh]
    page, off = decode_slots(cache, bt_rows, kv_len, spec) \
        if slots is None else slots
    cap = None if spec.window is None \
        else _gqa_capacity(cache, bt_rows, spec)
    eff_len = kv_len if cap is None else torch.clamp(kv_len, max=cap)

    def write_attend(part: dict, q, k_new, v_new):
        dev = q.device
        pg, po = page.to(dev), off.to(dev)
        k_q, k_s, v_q, v_s, _, _ = _gqa_quant_new(part, k_new, v_new)
        for name, new in (("k_pages", k_q), ("v_pages", v_q),
                          ("k_scale", k_s), ("v_scale", v_s)):
            if new is not None:
                pages = part[name]
                pages[pg, po] = new.transpose(1, 2).to(pages.dtype)
        ks, vs = _readable_scales(part, "k_scale", "v_scale")
        return fusemax_decode_paged(
            q, pool_pages(part["k_pages"]), pool_pages(part["v_pages"]),
            bt_rows.to(dev), eff_len.to(dev), capacity=cap,
            softcap=cfg.attn_softcap,
            impl=rt.attn_impl,
            splits=rt.decode_splits,
            exp_impl=rt.exp_impl,
            k_scale=ks, v_scale=vs,
        )                                                # [B, H, 1, dh]

    out = _over_head_shards(rt.kv_shard, cache, write_attend, q, k_new, v_new)
    return _out_proj(p, out), cache


def _chain_positions(kv_len: torch.Tensor, pq: int) -> torch.Tensor:
    """Absolute positions of a P-token verify chain: ``kv_len - 1 + j``
    ([B, P]; ``kv_len`` counts chain position 0)."""
    return (kv_len.long() - 1)[:, None] + torch.arange(pq,
                                                       device=kv_len.device)


def gqa_verify(p: GQA, x: torch.Tensor, cache: dict, kv_len: torch.Tensor,
               span: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
               rt: Runtime):
    """Speculative verify on the dense cache: score a P-token chain in one
    call.  x: [B, P, d]; chain position j sits at ``kv_len - 1 + j``
    (``kv_len`` counts the cache *including* chain position 0, as
    :func:`gqa_decode`'s does); ``span``: [B] real chain positions per
    row — K/V past it never land (:func:`write_chain_dense`), so rejected
    drafts leave the cache as it was, and outputs past it are garbage the
    engine ignores.  Global attention only (the engine gates windows
    off); K2 at P·G rows."""
    pos = _chain_positions(kv_len, x.shape[1])           # [B, P]
    q, k_new, v_new = _proj_qkv(p, x, cfg, pos)          # [B, H*, P, dh]
    write_chain_dense(cache["k"].transpose(1, 2), k_new.transpose(1, 2),
                      kv_len, span)
    write_chain_dense(cache["v"].transpose(1, 2), v_new.transpose(1, 2),
                      kv_len, span)
    out = fusemax_decode(
        q, cache["k"], cache["v"], kv_len,
        softcap=cfg.attn_softcap,
        impl=rt.attn_impl,
        splits=rt.decode_splits,
        exp_impl=rt.exp_impl,
    )                                                    # [B, H, P, dh]
    return _out_proj(p, out), cache


def gqa_verify_paged(p: GQA, x: torch.Tensor, cache: dict,
                     bt_rows: torch.Tensor, kv_len: torch.Tensor,
                     span: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                     rt: Runtime):
    """Paged :func:`gqa_verify`: the chain's K/V land through the block
    table (its tail rows are the slot's scratch draft pages — see
    ``PagedKVCache.reserve_draft``; positions past ``span`` and inactive
    rows go to the sink page), and K3 reads them back through the same
    table at P·G rows.  A quantized pool takes the chain's codes and
    per-(token, head) scales, so every read of the chain, its own
    included, sees the quant-round-tripped values."""
    pq = x.shape[1]
    pos = _chain_positions(kv_len, pq)                   # [B, P]
    q, k_new, v_new = _proj_qkv(p, x, cfg, pos)          # [B, H*, P, dh]
    cap = _gqa_capacity(cache, bt_rows, spec)
    valid = (torch.arange(pq, device=x.device)[None]
             < span.to(x.device)[:, None]) & (kv_len > 0)[:, None]
    k_q, k_s, v_q, v_s, _, _ = _gqa_quant_new(cache, k_new, v_new)
    for name, new in (("k_pages", k_q), ("v_pages", v_q), ("k_scale", k_s),
                      ("v_scale", v_s)):
        if new is not None:
            write_pages(cache[name], bt_rows, pos, new.transpose(1, 2), cap,
                        valid)
    ks, vs = _readable_scales(cache, "k_scale", "v_scale")
    out = fusemax_decode_paged(
        q, pool_pages(cache["k_pages"]), pool_pages(cache["v_pages"]),
        bt_rows, kv_len,
        softcap=cfg.attn_softcap,
        impl=rt.attn_impl,
        splits=rt.decode_splits,
        exp_impl=rt.exp_impl,
        k_scale=ks, v_scale=vs,
    )                                                    # [B, H, P, dh]
    return _out_proj(p, out), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention) — paged layout
# ---------------------------------------------------------------------------

class MLAAttention(nn.Module):
    """Parameters of one MLA layer under the reference's names/layouts:
    ``w_dq [d, q_lora]``, ``w_uq [q_lora, h, nope + rope]``, ``w_dkv [d,
    r + rd]``, ``w_uk [r, h, nope]``, ``w_uv [r, h, v]``, ``wo [h, v, d]``
    and the rmsnorms ``q_norm`` / ``kv_norm`` on the latent axes."""

    def __init__(self, cfg: ModelConfig, *, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        qk = m.nope_dim + m.rope_dim
        nk = dict(dtype=dtype, device=device)
        self.w_dq = _param((d, m.q_lora_rank), **nk)
        self.w_uq = _param((m.q_lora_rank, h, qk), **nk)
        self.w_dkv = _param((d, m.kv_lora_rank + m.rope_dim), **nk)
        self.w_uk = _param((m.kv_lora_rank, h, m.nope_dim), **nk)
        self.w_uv = _param((m.kv_lora_rank, h, m.v_dim), **nk)
        self.wo = _param((h, m.v_dim, d), **nk)
        self.q_norm = Norm(m.q_lora_rank, "rmsnorm", **nk)
        self.kv_norm = Norm(m.kv_lora_rank, "rmsnorm", **nk)
        if gen is not None:
            for w, fan_in in ((self.w_dq, d), (self.w_uq, m.q_lora_rank),
                              (self.w_dkv, d), (self.w_uk, m.kv_lora_rank),
                              (self.w_uv, m.kv_lora_rank),
                              (self.wo, h * m.v_dim)):
                normal_(w, 1.0 / math.sqrt(fan_in), gen)


def mla_init(cfg: ModelConfig, *, dtype, device,
             gen: Optional[torch.Generator] = None) -> MLAAttention:
    return MLAAttention(cfg, dtype=dtype, device=device, gen=gen)


def _mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.mla.nope_dim + cfg.mla.rope_dim)


def _mla_qkv_latent(p: MLAAttention, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor):
    """Shared down-projections: returns (q_nope [B, H, S, nope], q_rope
    [B, H, S, rd], ckv [B, S, r], k_rope [B, S, rd])."""
    m = cfg.mla
    dt = x.dtype
    cq = apply_norm(p.q_norm, x @ p.w_dq.to(dt))
    q = torch.einsum("bsr,rhe->bhse", cq, p.w_uq.to(dt))
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = rope(q_rope, positions[:, None, :], cfg.rope_theta)
    dkv = x @ p.w_dkv.to(dt)                             # [B, S, r + rd]
    ckv = apply_norm(p.kv_norm, dkv[..., :m.kv_lora_rank])
    k_rope = rope(dkv[..., m.kv_lora_rank:], positions, cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def mla_forward(p: MLAAttention, x: torch.Tensor, cfg: ModelConfig,
                spec: LayerSpec, rt: Runtime,
                positions: Optional[torch.Tensor] = None,
                latent=None) -> torch.Tensor:
    """Training / prefill MLA: expand the latents per head and run K1 at
    (E, F) = (nope + rope, v).  x: [B, S, d].  ``latent`` passes
    :func:`_mla_qkv_latent`'s outputs the caller already computed."""
    m = cfg.mla
    b, s_len, _ = x.shape
    if latent is None:
        if positions is None:
            positions = torch.arange(s_len, device=x.device).expand(b, s_len)
        latent = _mla_qkv_latent(p, x, cfg, positions)
    q_nope, q_rope, ckv, k_rope = latent
    dt = x.dtype
    k_nope = torch.einsum("bsr,rhe->bhse", ckv, p.w_uk.to(dt))
    v = torch.einsum("bsr,rhe->bhse", ckv, p.w_uv.to(dt))
    h = cfg.n_heads
    q = torch.cat([q_nope, q_rope], dim=-1)              # [B, H, S, qk]
    k = torch.cat([k_nope, k_rope[:, None].expand(b, h, s_len, m.rope_dim)],
                  dim=-1)
    out = fusemax_attention(
        q, k, v,
        causal=cfg.causal,
        softcap=cfg.attn_softcap,
        scale=_mla_scale(cfg),
        impl=rt.attn_impl,
        block_q=rt.block_q,
        block_k=rt.block_k,
        exp_impl=rt.exp_impl,
    )                                                    # [B, H, S, v]
    return _out_proj(p, out)


def _mla_absorbed_attend(p: MLAAttention, q_nope: torch.Tensor,
                         q_rope: torch.Tensor, ckv: torch.Tensor,
                         krope: torch.Tensor, off: int, cfg: ModelConfig,
                         rt: Runtime) -> torch.Tensor:
    """Absorbed-form chunk attention over a latent history: one fiber
    (Hkv = 1) with every query head in its group; ``q_eff = q_nopeᵀW_uk``
    scores the rank-r latents plus the shared rope keys directly, the
    accumulator stays in latent space (K1 at (r + rd, r)), and W_uv lifts
    it at the end.  ckv: [B, tot, r]; krope: [B, tot, rd] (history and
    this chunk).  Returns the per-head output [B, H, S, v] (pre-``wo``)."""
    dt = q_nope.dtype
    q_eff = torch.einsum("bhse,rhe->bhsr", q_nope, p.w_uk.to(dt))
    q_cat = torch.cat([q_eff, q_rope], dim=-1)           # [B, H, S, r+rd]
    k_cat = torch.cat([ckv, krope], dim=-1)[:, None]     # [B, 1, tot, r+rd]
    out_lat = fusemax_attention(
        q_cat, k_cat, ckv[:, None],
        causal=cfg.causal, softcap=cfg.attn_softcap, scale=_mla_scale(cfg),
        q_offset=off, impl=rt.attn_impl, block_q=rt.block_q,
        block_k=rt.block_k, exp_impl=rt.exp_impl,
    )                                                    # [B, H, S, r]
    return torch.einsum("bhsr,rhe->bhse", out_lat, p.w_uv.to(dt))


def mla_prefill_chunk(p: MLAAttention, x: torch.Tensor, cache: dict,
                      off: int, cfg: ModelConfig, spec: LayerSpec,
                      rt: Runtime):
    """Chunked-prefill continuation on the dense latent cache: the chunk's
    latents land at [off, off + S) and its queries attend the cached
    prefix plus the chunk in absorbed form (:func:`_mla_absorbed_attend`,
    K1 at (r + rd, r)), so the history stays [tot, r + rd] per sequence.
    x: [B, S, d]."""
    b, s_len, _ = x.shape
    positions = torch.arange(off, off + s_len, device=x.device).expand(
        b, s_len)
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_latent(p, x, cfg,
                                                         positions)
    cache["ckv"][:, off:off + s_len] = ckv_new.to(cache["ckv"].dtype)
    cache["krope"][:, off:off + s_len] = krope_new.to(cache["krope"].dtype)
    tot = off + s_len
    out = _mla_absorbed_attend(p, q_nope, q_rope, cache["ckv"][:, :tot],
                               cache["krope"][:, :tot], off, cfg, rt)
    return _out_proj(p, out), cache


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> dict:
    """A layer's dense latent cache: ``ckv [batch, max_len, r]`` and
    ``krope [batch, max_len, rd]``."""
    m = cfg.mla
    nk = dict(dtype=dtype, device=device)
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), **nk),
            "krope": torch.zeros((batch, max_len, m.rope_dim), **nk)}


def mla_decode(p: MLAAttention, x: torch.Tensor, cache: dict,
               kv_len: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
               rt: Runtime):
    """Absorbed-form decode on the dense latent cache: write the step's
    latents at ``kv_len - 1`` (an empty slot with kv_len = 0 writes the
    last row, as in the reference), then ``ops.fusemax_decode_latent``
    (K2's E ≠ F branch: Hkv = 1, every head in the group) and the W_uv /
    ``wo`` lifts.  x: [B, 1, d]; kv_len: [B] length *including* x."""
    b = x.shape[0]
    pos = (kv_len.long() - 1)[:, None]                   # [B, 1]
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_latent(p, x, cfg, pos)
    slot = pos[:, 0] % cache["ckv"].shape[1]
    bidx = torch.arange(b, device=x.device)
    cache["ckv"][bidx, slot] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["krope"][bidx, slot] = krope_new[:, 0].to(cache["krope"].dtype)
    dt = x.dtype
    q_eff = torch.einsum("bhse,rhe->bhsr", q_nope, p.w_uk.to(dt))
    q_cat = torch.cat([q_eff, q_rope], dim=-1)           # [B, H, 1, r+rd]
    out_lat = fusemax_decode_latent(
        q_cat, cache["ckv"], cache["krope"], kv_len,
        scale=_mla_scale(cfg), softcap=cfg.attn_softcap,
        impl=rt.attn_impl, splits=rt.decode_splits, exp_impl=rt.exp_impl,
    )                                                    # [B, H, 1, r]
    out = torch.einsum("bhsr,rhe->bhse", out_lat, p.w_uv.to(dt))
    return _out_proj(p, out), cache


def mla_verify(p: MLAAttention, x: torch.Tensor, cache: dict,
               kv_len: torch.Tensor, span: torch.Tensor, cfg: ModelConfig,
               spec: LayerSpec, rt: Runtime):
    """Speculative verify in latent space on the dense cache: the P-chain
    analogue of :func:`mla_decode` (chain contract in :func:`gqa_verify`):
    the chain's latents land where kept (:func:`write_chain_dense`), then
    K2's E ≠ F branch at P·H rows and the W_uv / ``wo`` lifts.  x: [B, P,
    d]."""
    pos = _chain_positions(kv_len, x.shape[1])           # [B, P]
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_latent(p, x, cfg, pos)
    write_chain_dense(cache["ckv"], ckv_new, kv_len, span)
    write_chain_dense(cache["krope"], krope_new, kv_len, span)
    dt = x.dtype
    q_eff = torch.einsum("bhse,rhe->bhsr", q_nope, p.w_uk.to(dt))
    q_cat = torch.cat([q_eff, q_rope], dim=-1)           # [B, H, P, r+rd]
    out_lat = fusemax_decode_latent(
        q_cat, cache["ckv"], cache["krope"], kv_len,
        scale=_mla_scale(cfg), softcap=cfg.attn_softcap,
        impl=rt.attn_impl, splits=rt.decode_splits, exp_impl=rt.exp_impl,
    )                                                    # [B, H, P, r]
    out = torch.einsum("bhsr,rhe->bhse", out_lat, p.w_uv.to(dt))
    return _out_proj(p, out), cache


def mla_init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                         dtype, device, kv_dtype: Optional[str] = None
                         ) -> dict:
    """A layer's latent page pools: ``num_pages`` pages plus the sink
    page; with ``kv_dtype`` the pools hold codes and per-token fp16 scale
    pools ride beside them."""
    m = cfg.mla
    qdt = kv_quant_dtype(kv_dtype)
    nk = dict(dtype=dtype if qdt is None else qdt, device=device)
    cache = {"ckv_pages": torch.zeros((num_pages + 1, page_size,
                                       m.kv_lora_rank), **nk),
             "krope_pages": torch.zeros((num_pages + 1, page_size,
                                         m.rope_dim), **nk)}
    if qdt is not None:
        for name in ("ckv_scale", "krope_scale"):
            cache[name] = torch.ones((num_pages + 1, page_size),
                                     dtype=torch.float16, device=device)
    return cache


def _mla_quant_new(cache: dict, ckv_new: torch.Tensor,
                   krope_new: torch.Tensor):
    """Quantize a chunk's fresh latents ([B, S, r] / [B, S, rd]) to the
    pool's storage dtype with one scale per token and vector → (ckv_q,
    ckv_s, kr_q, kr_s); an unquantized pool passes them through with None
    scales."""
    if "ckv_scale" not in cache:
        return ckv_new, None, krope_new, None
    qdt = leaf_parts(cache["ckv_pages"])[0].dtype
    ckv_q, ckv_s = quantize_kv(ckv_new, qdt)
    kr_q, kr_s = quantize_kv(krope_new, qdt)
    return ckv_q, ckv_s, kr_q, kr_s


def _rank_slices(leaf, new: torch.Tensor):
    """(pool, values) pairs that write ``new`` ([..., r]) into a latent
    pool leaf: the whole vectors into an unsharded (or replicated) pool,
    shard ``d``'s slice of the last axis into shard ``d``, on its
    device."""
    parts = leaf_parts(leaf)
    if len(parts) == 1:
        return [(parts[0], new)]
    return [(part, new[..., shard_slice(new.shape[-1], d, len(parts))]
             .to(part.device)) for d, part in enumerate(parts)]


def _mla_write(cache: dict, bt_rows: torch.Tensor, positions: torch.Tensor,
               cap: int, valid: Optional[torch.Tensor],
               ckv_new: torch.Tensor, krope_new: torch.Tensor) -> None:
    """Write a chunk's latents (quantized first on a quantized pool, with
    their scales: over whole vectors, so a rank-sharded pool's shards hold
    slices of the unsharded codes) into the pools through the block-table
    rows."""
    ckv_q, ckv_s, kr_q, kr_s = _mla_quant_new(cache, ckv_new, krope_new)
    for name, new in (("ckv_pages", ckv_q), ("krope_pages", kr_q),
                      ("ckv_scale", ckv_s), ("krope_scale", kr_s)):
        if new is None:
            continue
        for pages, vals in _rank_slices(cache[name], new):
            dev = pages.device
            write_pages(pages, bt_rows.to(dev), positions.to(dev), vals, cap,
                        None if valid is None else valid.to(dev))


def _latent_view(leaf, rows: torch.Tensor, tot: int,
                 device: torch.device) -> torch.Tensor:
    """The first ``tot`` tokens of a latent (or scale) pool leaf gathered
    through table rows, on ``device``: a rank-sharded leaf's shards
    gathered where they lie and concatenated on the rank axis — the
    reference's all-gather of the rank-complete view."""
    views = [gather_pages(pool_pages(part), rows.to(part.device))[:, :tot]
             .to(device) for part in leaf_parts(leaf)]
    return views[0] if len(views) == 1 else torch.cat(views, dim=-1)


def mla_prefill_paged(p: MLAAttention, x: torch.Tensor, cache: dict,
                      bt_rows: torch.Tensor, off: int, cfg: ModelConfig,
                      spec: LayerSpec, rt: Runtime, true_len: torch.Tensor,
                      cached_len: Optional[torch.Tensor] = None):
    """Prefill a prompt chunk's latents into the page pool, masked by
    ``true_len`` and by ``cached_len`` (positions below it live in pages
    mapped from the prefix index: read, never rewritten).  At ``off ==
    0`` the chunk attends itself in the expanded form
    (:func:`mla_forward`, on the latents as computed); a continuation
    (``off > 0``: chunked prefill or a prefix-cache hit) attends, in
    absorbed form (:func:`_mla_absorbed_attend`), the latents of
    positions ``[0, off + S)`` gathered through ``bt_rows`` after the
    chunk's writes — as the reference reads them, so a position the masks
    kept from being written is read from its page, and on a quantized
    pool every latent is read back dequantized.  A rank-sharded pool
    takes rank slices and is read as the rank-complete view.  x: [B, S,
    d]."""
    b, s_len, _ = x.shape
    positions = torch.arange(off, off + s_len, device=x.device).expand(
        b, s_len)
    latent = _mla_qkv_latent(p, x, cfg, positions)
    q_nope, q_rope, ckv_new, krope_new = latent
    ps = leaf_parts(cache["ckv_pages"])[0].shape[1]
    cap = bt_rows.shape[1] * ps
    valid = positions[:1] < true_len.to(x.device).long()[:, None]
    if cached_len is not None:
        valid = valid & (positions >= cached_len.to(x.device)[:, None])
    valid = valid.expand(b, s_len)
    _mla_write(cache, bt_rows, positions, cap, valid, ckv_new, krope_new)
    if off == 0:
        return mla_forward(p, x, cfg, spec, rt, latent=latent), cache
    # gather only the pages the history and the chunk occupy (plain torch
    # indexing, as the reference gathers in jnp outside any kernel)
    tot = off + s_len
    hp = -(-tot // ps)
    rows = bt_rows[:, :hp]
    ckv, krope = (_latent_view(cache[n], rows, tot, x.device)
                  for n in ("ckv_pages", "krope_pages"))
    if "ckv_scale" in cache:
        ckv, krope = (dequantize_kv(v, _latent_view(cache[n], rows, tot,
                                                    x.device), x.dtype)
                      for v, n in ((ckv, "ckv_scale"),
                                   (krope, "krope_scale")))
    out = _mla_absorbed_attend(p, q_nope, q_rope, ckv, krope, off, cfg, rt)
    return _out_proj(p, out), cache


def mla_decode_paged(p: MLAAttention, x: torch.Tensor, cache: dict,
                     bt_rows: torch.Tensor, kv_len: torch.Tensor,
                     cfg: ModelConfig, spec: LayerSpec, rt: Runtime,
                     slots=None):
    """Absorbed-form decode against the latent pages: write the new
    latents at the logical tail, then K4 through
    ``ops.fusemax_mla_decode_paged`` and the W_uv / ``wo`` lifts.
    Inactive slots (kv_len = 0) drop their writes.  ``slots``: this
    step's :func:`decode_slots`, shared across layers.  A rank-sharded
    pool (``rt.kv_shard``) takes rank slices and decodes in page strips
    (:func:`_mla_decode_strips`).  x: [B, 1, d]."""
    pos = (kv_len.long() - 1)[:, None]                   # [B, 1]
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_latent(p, x, cfg, pos)
    page, off = decode_slots(cache, bt_rows, kv_len, spec) \
        if slots is None else slots
    ckv_q, ckv_s, kr_q, kr_s = _mla_quant_new(cache, ckv_new, krope_new)
    for name, new in (("ckv_pages", ckv_q), ("krope_pages", kr_q),
                      ("ckv_scale", ckv_s), ("krope_scale", kr_s)):
        if new is None:
            continue
        for pages, vals in _rank_slices(cache[name], new):
            dev = pages.device
            pages[page.to(dev), off.to(dev)] = vals.to(pages.dtype)
    dt = x.dtype
    q_eff = torch.einsum("bhse,rhe->bhsr", q_nope, p.w_uk.to(dt))
    q_cat = torch.cat([q_eff, q_rope], dim=-1)           # [B, H, 1, r+rd]
    if rt.kv_shard is not None:
        out_lat = _mla_decode_strips(q_cat, cache, bt_rows, kv_len, cfg, rt)
    else:
        cs, ks = _readable_scales(cache, "ckv_scale", "krope_scale")
        out_lat = fusemax_mla_decode_paged(
            q_cat, pool_pages(cache["ckv_pages"]),
            pool_pages(cache["krope_pages"]), bt_rows, kv_len,
            scale=_mla_scale(cfg), softcap=cfg.attn_softcap,
            impl=rt.attn_impl, exp_impl=rt.exp_impl,
            ckv_scale=cs, krope_scale=ks,
        )                                                # [B, H, 1, r]
    out = torch.einsum("bhsr,rhe->bhse", out_lat, p.w_uv.to(dt))
    return _out_proj(p, out), cache


def _mla_decode_strips(q_cat: torch.Tensor, cache: dict,
                       bt_rows: torch.Tensor, kv_len: torch.Tensor,
                       cfg: ModelConfig, rt: Runtime) -> torch.Tensor:
    """The rank-sharded pool's decode (the reference's sharded branch of
    ``mla_decode_paged``): the rank-complete view of the whole table
    (dequantized on a code pool), then on each shard's device one
    contiguous strip of the page-aligned splits the unsharded K4 launch
    would sweep (``ops.mla_strips``, at the pool's element size) through
    the latent kernel, and one combine of the strips' partials in split
    order.  Returns the latent output ``[B, H, 1, r]``."""
    shard = rt.kv_shard
    dev = q_cat.device
    ckv_parts = leaf_parts(cache["ckv_pages"])
    _, ps, _ = ckv_parts[0].shape
    w = bt_rows.shape[1]
    ckv = _latent_view(cache["ckv_pages"], bt_rows, w * ps, dev)
    krope = _latent_view(cache["krope_pages"], bt_rows, w * ps, dev)
    if "ckv_scale" in cache:
        ckv, krope = (dequantize_kv(v, _latent_view(cache[n], bt_rows,
                                                    w * ps, dev))
                      for v, n in ((ckv, "ckv_scale"),
                                   (krope, "krope_scale")))
    splits, block_k, strips = mla_strips(
        w, ps, q_cat.shape[1], ckv.shape[-1], krope.shape[-1], shard.size,
        elem_bytes=ckv_parts[0].element_size())
    views, parts = {}, []
    for sdev, (first, n) in zip(shard.devices, strips):
        if n == 0:
            continue
        if sdev not in views:
            views[sdev] = (ckv.to(sdev), krope.to(sdev))
        parts.append(tuple(t.to(dev) for t in fusemax_mla_decode_strip(
            q_cat.to(sdev), *views[sdev], kv_len.to(sdev), splits=splits,
            block_k=block_k, split_first=first, n_splits=n,
            scale=_mla_scale(cfg), softcap=cfg.attn_softcap,
            impl=rt.attn_impl, exp_impl=rt.exp_impl)))
    return combine_strips(parts, q_cat)


def mla_verify_paged(p: MLAAttention, x: torch.Tensor, cache: dict,
                     bt_rows: torch.Tensor, kv_len: torch.Tensor,
                     span: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                     rt: Runtime):
    """Paged latent-space verify: the P-chain analogue of
    :func:`mla_decode_paged` (chain contract in :func:`gqa_verify`): the
    chain's latents (codes and per-token scales on a quantized pool) land
    in the slot's scratch draft pages through the block table, masked
    positions in the sink page, then K4 at ``n_pos = P``.  x: [B, P, d]."""
    pq = x.shape[1]
    pos = _chain_positions(kv_len, pq)                   # [B, P]
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv_latent(p, x, cfg, pos)
    cap = bt_rows.shape[1] * cache["ckv_pages"].shape[1]
    valid = (torch.arange(pq, device=x.device)[None]
             < span.to(x.device)[:, None]) & (kv_len > 0)[:, None]
    _mla_write(cache, bt_rows, pos, cap, valid, ckv_new, krope_new)
    dt = x.dtype
    q_eff = torch.einsum("bhse,rhe->bhsr", q_nope, p.w_uk.to(dt))
    q_cat = torch.cat([q_eff, q_rope], dim=-1)           # [B, H, P, r+rd]
    cs, ks = _readable_scales(cache, "ckv_scale", "krope_scale")
    out_lat = fusemax_mla_decode_paged(
        q_cat, pool_pages(cache["ckv_pages"]),
        pool_pages(cache["krope_pages"]), bt_rows, kv_len,
        scale=_mla_scale(cfg), softcap=cfg.attn_softcap,
        impl=rt.attn_impl, exp_impl=rt.exp_impl,
        ckv_scale=cs, krope_scale=ks,
    )                                                    # [B, H, P, r]
    out = torch.einsum("bhsr,rhe->bhse", out_lat, p.w_uv.to(dt))
    return _out_proj(p, out), cache
