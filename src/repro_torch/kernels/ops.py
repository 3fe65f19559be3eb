"""Public attention ops: GQA folding, tile choice and dispatch around the
FuseMax kernels.  Port of ``repro.kernels.ops``.

``fusemax_attention``    — [B, Hq, P, E] × [B, Hkv, M, E/F] → [B, Hq, P, F];
  differentiable: with grad mode on and an operand that requires grad,
  "cuda" and "torch" run :class:`FuseMaxAttention`, the reference's custom
  VJP (K1 or its plain version with a log-sum-exp output forward, the
  FA-2 recompute backward in torch ops); "ref" is plain autograd.
``fusemax_decode``       — one-token (or P-row verify) queries against a
  ragged dense KV cache, split-K.
``fusemax_decode_paged`` — the same against a page pool through a block
  table (``gather_pages`` materializes the table's view for the ref path).
``fusemax_mla_decode_paged`` — DeepSeek's absorbed-form decode in latent
  space against a latent page pool (Hkv = 1, every head in the group).
``fusemax_decode_latent`` — the same against a dense latent cache: the
  reference's ``fusemax_decode`` on ``[ckv | krope]`` and ``ckv``, without
  building the concatenation.
``fusemax_mla_decode_strip`` / ``combine_strips`` — the latent decode's
  split-K partials over one strip of K4's page-aligned splits (a
  rank-sharded pool's decode runs one strip a shard) and the combine of
  the strips' partials.

``impl``:
  "cuda"   the hand-written Hopper kernel; raises on a CPU tensor,
  "torch"  the kernel's plain torch version (the CPU path, and the
           reference the kernel is held to on the card),
  "ref"    the 3-pass oracle,
  "auto"   "cuda" for CUDA tensors, "torch" for CPU tensors — a CUDA
           tensor never takes the plain path unless the caller names it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, ref as _ref
from repro_torch.kernels.decode import (
    _dequant_tile, combine_partials, decode_paged_cascade,
    decode_partials_cuda, decode_partials_torch, decode_splitk_cascade,
    latent_decode_partials_cuda, latent_decode_partials_torch,
    mla_decode_paged_cascade, mla_paged_decode_partials_cuda,
    mla_paged_decode_partials_torch, mla_verify_chain_cascade,
    paged_decode_partials_cuda, paged_decode_partials_torch,
    verify_chain_cascade,
)
from repro_torch.kernels.fusemax import (
    fusemax_attention_bwd, fusemax_attention_cuda, fusemax_attention_torch,
    prefill_cascade,
)

# Every public op dispatches to exactly one declared cascade, built by the
# port's own builder beside its kernel (``repro.kernels.ops``'s map, with
# the port's builders); ``python -m repro_torch.analysis.report --check``
# verifies the declarations.  ``REFERENCE_CASCADES`` names the reference's
# builder of each op by dotted path, so the port never imports the JAX
# package; tests/test_torch_kernels.py checks that the two agree, Einsum by
# Einsum (a port-only op through the reference op it implements,
# ``REFERENCE_OP``).
KERNEL_CASCADES = {
    "mha_reference": _ref.reference_cascade,
    "decode_reference": _ref.reference_cascade,
    "fusemax_attention": prefill_cascade,
    "fusemax_decode": decode_splitk_cascade,
    "fusemax_decode_paged": decode_paged_cascade,
    "fusemax_mla_decode_paged": mla_decode_paged_cascade,
    "fusemax_decode[p>1]": verify_chain_cascade,
    "fusemax_decode_paged[p>1]": verify_chain_cascade,
    "fusemax_mla_decode_paged[p>1]": mla_verify_chain_cascade,
    "fusemax_decode_latent": decode_splitk_cascade,
    "fusemax_decode_latent[p>1]": verify_chain_cascade,
}

REFERENCE_CASCADES = {
    "mha_reference": "repro.kernels.ref.reference_cascade",
    "decode_reference": "repro.kernels.ref.reference_cascade",
    "fusemax_attention": "repro.kernels.fusemax.prefill_cascade",
    "fusemax_decode": "repro.kernels.decode.decode_splitk_cascade",
    "fusemax_decode_paged": "repro.kernels.decode.decode_paged_cascade",
    "fusemax_mla_decode_paged":
        "repro.kernels.decode.mla_decode_paged_cascade",
    "fusemax_decode[p>1]": "repro.kernels.decode.verify_chain_cascade",
    "fusemax_decode_paged[p>1]": "repro.kernels.decode.verify_chain_cascade",
    "fusemax_mla_decode_paged[p>1]":
        "repro.kernels.decode.mla_verify_chain_cascade",
    "fusemax_decode_latent": "repro.kernels.decode.decode_splitk_cascade",
    "fusemax_decode_latent[p>1]":
        "repro.kernels.decode.verify_chain_cascade",
}

#: port-only ops → the reference op each implements
REFERENCE_OP = {"fusemax_decode_latent": "fusemax_decode",
                "fusemax_decode_latent[p>1]": "fusemax_decode[p>1]"}

#: "meta": the dry run's stand-in on meta tensors (:func:`_meta_attention`)
IMPLS = ("cuda", "torch", "ref", "auto", "meta")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def resolve_impl(impl: str, t: torch.Tensor) -> str:
    """Resolve ``"auto"`` by the tensor's device; refuse "cuda" on the
    CPU."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    if impl == "auto":
        return "cuda" if t.is_cuda else "torch"
    if impl == "meta" and t.device.type != "meta":
        raise ValueError("impl='meta' is the dry run's stand-in and takes "
                         f"meta tensors; got a tensor on {t.device}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors; got a tensor on "
                         f"{t.device}")
    return impl


def _meta_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """An attention output's shape [B, Hq, P, F] from q [B, Hq, P, E] and
    k / v [B, Hkv, M, *] with no product a FLOP counter sees: the dry run
    counts attention by formula (the (query, key) pairs its masks leave),
    not through a kernel.  Every input reaches the output, so the
    projections' backward runs and is counted."""
    g = q.shape[1] // v.shape[1]
    kv = v.mean(dim=2, keepdim=True) \
        + k.mean(dim=(2, 3), keepdim=True)[..., :1] * 0
    return q[..., :1] * 0 + kv.repeat_interleave(g, dim=1)


class FuseMaxAttention(torch.autograd.Function):
    """The reference's ``_make_flash_jnp`` custom VJP on the folded layout
    (q [B·Hkv, P·G, E], k, v): forward is K1 (``impl="cuda"``) or its
    plain version (``"torch"``), each with its log-sum-exp output, and
    saves (q, k, v, out, lse); backward is
    :func:`~repro_torch.kernels.fusemax.fusemax_attention_bwd`.  ``kw``
    holds the forward's keyword arguments (scale, masks, group, tile)."""

    @staticmethod
    def forward(ctx, q_f, k_f, v_f, impl: str, kw: dict):
        fwd = fusemax_attention_cuda if impl == "cuda" \
            else fusemax_attention_torch
        out, lse = fwd(q_f, k_f, v_f, return_lse=True, **kw)
        ctx.save_for_backward(q_f, k_f, v_f, out, lse)
        ctx.kw = {key: kw[key] for key in ("scale", "causal", "window",
                                           "softcap", "q_offset", "group",
                                           "m_valid")}
        return out

    @staticmethod
    def backward(ctx, dout):
        q_f, k_f, v_f, out, lse = ctx.saved_tensors
        dq, dk, dv = fusemax_attention_bwd(q_f, k_f, v_f, out, lse, dout,
                                           **ctx.kw)
        return dq, dk, dv, None, None


def fusemax_attention(
    q: torch.Tensor,   # [B, Hq, P, E]
    k: torch.Tensor,   # [B, Hkv, M, E]
    v: torch.Tensor,   # [B, Hkv, M, F]
    *,
    causal: bool = False,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    impl: str = "auto",
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    exp_impl: str = "native",
) -> torch.Tensor:
    """FuseMax attention (1-pass cascade, deferred division).

    ``block_q`` / ``block_k`` left as ``None`` come from
    :func:`autotune.attention_params` (the kernel's compiled tile for
    "cuda", the reference's modeled choice otherwise)."""
    b, hq, p, e = q.shape
    _, hkv, m, f = v.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (e ** 0.5)
    impl = resolve_impl(impl, q)

    if impl == "meta":
        return _meta_attention(q, k, v)
    if impl == "ref":
        return _ref.mha_reference(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset)

    if block_q is None or block_k is None:
        tuned = autotune.attention_params(p * group, m, e, f, impl=impl)
        block_q = tuned.block_q if block_q is None else block_q
        block_k = tuned.block_k if block_k is None else block_k

    # fold GQA groups into query rows: row r = p·group + g → qpos = r//group
    q_f = (q.reshape(b, hkv, group, p, e).transpose(2, 3)
           .reshape(b * hkv, p * group, e))
    k_f = k.reshape(b * hkv, m, e)
    v_f = v.reshape(b * hkv, m, f)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, group=group, m_valid=m, exp_impl=exp_impl)
    if impl == "cuda":
        q_f, k_f, v_f = q_f.contiguous(), k_f.contiguous(), v_f.contiguous()
        kw.update(block_q=block_q, block_k=block_k)
        fwd = fusemax_attention_cuda
    else:
        # the TPU wrapper's tile clamps, so the plain version runs the
        # same (query tile, key tile) pairs as the Pallas kernel
        kw.update(block_q=min(block_q, _round_up(p * group, 8)),
                  block_k=min(block_k, _round_up(m, 128)))
        fwd = fusemax_attention_torch
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FuseMaxAttention.apply(q_f, k_f, v_f, impl, kw)
    else:
        out = fwd(q_f, k_f, v_f, **kw)
    return (out.reshape(b, hkv, p, group, f).transpose(2, 3)
            .reshape(b, hq, p, f))


def _fold_decode_q(q: torch.Tensor, b: int, hkv: int, group: int,
                   e: int) -> torch.Tensor:
    """Fold GQA groups into kernel query rows ([B, Hq, P, E] →
    [B·Hkv, P·G, E]; row r is draft position r // G).  Unlike the TPU
    wrapper, G is not padded to an 8-row floor: the CUDA kernel tiles
    keys, not query rows, so no padded row exists to reach the output."""
    p = q.shape[2]
    return (q.reshape(b, hkv, group, p, e).transpose(2, 3)
            .reshape(b * hkv, p * group, e))


def _unfold_decode_out(out: torch.Tensor, b: int, hkv: int, group: int,
                       f: int, p: int = 1) -> torch.Tensor:
    """Inverse of :func:`_fold_decode_q` for kernel outputs
    ([B·Hkv, P·G, F] → [B, Hq, P, F])."""
    return (out.reshape(b, hkv, p, group, f).transpose(2, 3)
            .reshape(b, hkv * group, p, f))


def _decode_geometry(m: int, group: int, e: int, f: int, p: int,
                     splits: Optional[int], block_k: Optional[int]):
    """(splits, block_k) of a dense split-K decode as the reference's
    ``fusemax_decode`` resolves them: the tuned pair from
    :func:`autotune.decode_params` where left as ``None``, splits cut to a
    divisor of M, and the verify rows' ``block_k`` clamp."""
    if splits is None or block_k is None:
        tuned = autotune.decode_params(m, max(group, 8), e, f)
        splits = tuned.splits if splits is None else splits
        block_k = tuned.block_k if block_k is None else block_k
    splits = max(1, min(splits, m // min(m, block_k)))
    while m % splits:
        splits -= 1
    return splits, autotune.verify_block_k(block_k, p=p, g=max(group, 8),
                                           e=e, f=f)


def fusemax_decode(
    q: torch.Tensor,         # [B, Hq, P, E]
    k: torch.Tensor,         # [B, Hkv, M, E]  (cache, padded to M slots)
    v: torch.Tensor,         # [B, Hkv, M, F]
    kv_len: torch.Tensor,    # [B] valid lengths (the query is kv_len-1)
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    splits: Optional[int] = None,
    block_k: Optional[int] = None,
    exp_impl: str = "native",
) -> torch.Tensor:
    """Decode against a ragged KV cache (split-K FuseMax).

    P = 1 is the plain decode step; P > 1 are verify rows: query j sits at
    ``kv_len - 1 + j`` and attends keys ``< kv_len + j``.  ``splits`` /
    ``block_k`` left as ``None`` come from :func:`autotune.decode_params`,
    whose key never sees P."""
    b, hq, p, e = q.shape
    _, hkv, m, f = v.shape
    if p != 1 and window is not None:
        raise ValueError(
            "multi-query verify does not support windowed attention "
            "(draft positions would need per-query ring views)")
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (e ** 0.5)
    impl = resolve_impl(impl, q)

    if impl == "meta":
        return _meta_attention(q, k, v)
    if impl == "ref":
        if p == 1:
            return _ref.decode_reference(
                q, k, v, kv_len, softcap=softcap, window=window, scale=scale)
        outs = [_ref.decode_reference(
                    q[:, :, j:j + 1], k, v, kv_len + j,
                    softcap=softcap, window=window, scale=scale)
                for j in range(p)]
        return torch.cat(outs, dim=2)

    splits, block_k = _decode_geometry(m, group, e, f, p, splits, block_k)
    q_f = _fold_decode_q(q, b, hkv, group, e)
    k_f = k.reshape(b * hkv, m, e)
    v_f = v.reshape(b * hkv, m, f)
    kw = dict(scale=scale, softcap=softcap, window=window, hkv=hkv,
              splits=splits, block_k=block_k, exp_impl=exp_impl, n_pos=p,
              rows_per_pos=group)
    if impl == "cuda":
        pm, pl, pnv = decode_partials_cuda(
            q_f.contiguous(), k_f.contiguous(), v_f.contiguous(),
            kv_len.to(device=q.device, dtype=torch.int32).contiguous(), **kw)
    else:
        pm, pl, pnv = decode_partials_torch(q_f, k_f, v_f, kv_len, **kw)
    out = combine_partials(pm, pl, pnv, q.dtype)
    return _unfold_decode_out(out, b, hkv, group, f, p=p)


def seq_strips(m: int, group: int, e: int, f: int, tp: int, *, p: int = 1,
               splits: Optional[int] = None,
               block_k: Optional[int] = None) -> tuple:
    """(splits, block_k, n_splits) of a decode over a dense cache of ``m``
    slots split on its slots into ``tp`` strips: the unsharded call's
    geometry (:func:`fusemax_decode`'s), each strip ``n_splits = splits /
    tp`` of its splits.  ``tp`` must divide the split count — a strip of
    unequal length would change the sweep — so any other ``tp`` is
    refused, naming both numbers.  A ``splits`` given without a
    ``block_k`` keeps its count: the tuned tile is cut to the split
    length."""
    if splits is not None and block_k is None:
        block_k = min(autotune.decode_params(m, max(group, 8), e, f).block_k,
                      max(1, m // splits))
    splits, block_k = _decode_geometry(m, group, e, f, p, splits, block_k)
    if splits % tp:
        raise ValueError(
            f"a sequence-sharded cache of {tp} strips needs a split count "
            f"it divides; the decode of M={m} sweeps splits={splits} "
            f"(tp={tp} does not divide {splits}: pick a tp that divides "
            f"the splits, or set Runtime.decode_splits)")
    return splits, block_k, splits // tp


def fusemax_decode_strip(
    q: torch.Tensor,         # [B, Hq, P, E]
    k: torch.Tensor,         # [B, Hkv, M/tp, E] (the strip's slots)
    v: torch.Tensor,         # [B, Hkv, M/tp, F]
    kv_len: torch.Tensor,    # [B] valid lengths (the query is kv_len-1)
    *,
    splits: int,
    block_k: int,
    split_first: int,
    n_splits: int,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    exp_impl: str = "native",
):
    """K2's partials ``(pm, pl, pnv)`` over splits ``[split_first,
    split_first + n_splits)`` of a ``splits`` sweep (:func:`seq_strips`),
    from a K / V that hold only those splits' slots: the strip of a
    sequence-sharded cache.  Key positions stay global, so the tile-run
    rule, the window and a verify chain's causal limit are the whole
    sweep's; the strips' partials, concatenated on the split axis, are the
    whole call's bit for bit.  "cuda" launches K2 on the strip, "torch"
    runs its plain version."""
    b, hq, p, e = q.shape
    hkv = v.shape[1]
    group = hq // hkv
    impl = resolve_impl(impl, q)
    if impl == "ref":
        raise ValueError("fusemax_decode_strip: the 3-pass oracle has no "
                         "split-K partials; use impl 'cuda' or 'torch'")
    scale = scale if scale is not None else 1.0 / (e ** 0.5)
    q_f = _fold_decode_q(q, b, hkv, group, e)
    k_f = k.reshape(b * hkv, k.shape[2], e)
    v_f = v.reshape(b * hkv, v.shape[2], v.shape[3])
    kw = dict(scale=scale, softcap=softcap, window=window, hkv=hkv,
              splits=splits, block_k=block_k, exp_impl=exp_impl, n_pos=p,
              rows_per_pos=group, split_first=split_first,
              n_splits=n_splits)
    if impl == "cuda":
        return decode_partials_cuda(
            q_f.contiguous(), k_f.contiguous(), v_f.contiguous(),
            kv_len.to(device=q.device, dtype=torch.int32).contiguous(), **kw)
    return decode_partials_torch(q_f, k_f, v_f, kv_len, strip_kv=True, **kw)


def fusemax_decode_seq_sharded(
    q: torch.Tensor,         # [B, Hq, P, E]
    k_strips: list,          # tp x [B, Hkv, M/tp, E], strip d on its device
    v_strips: list,          # tp x [B, Hkv, M/tp, F]
    kv_len: torch.Tensor,    # [B]
    *,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    splits: Optional[int] = None,
    block_k: Optional[int] = None,
    exp_impl: str = "native",
) -> torch.Tensor:
    """:func:`fusemax_decode` over a dense cache sharded on its slots:
    strip ``d`` computes its splits' partials on its own device
    (:func:`fusemax_decode_strip`), the partials are gathered in strip
    order on q's device and combined once — the unsharded call's output
    bit for bit.  Returns [B, Hq, P, F]."""
    b, hq, p, e = q.shape
    tp = len(k_strips)
    hkv, ms, f = v_strips[0].shape[1], v_strips[0].shape[2], \
        v_strips[0].shape[3]
    group = hq // hkv
    splits, block_k, n = seq_strips(ms * tp, group, e, f, tp, p=p,
                                    splits=splits, block_k=block_k)
    parts = []
    for d, (k, v) in enumerate(zip(k_strips, v_strips)):
        dev = k.device
        part = fusemax_decode_strip(
            q.to(dev), k, v, kv_len.to(dev), splits=splits, block_k=block_k,
            split_first=d * n, n_splits=n, softcap=softcap, window=window,
            scale=scale, impl=impl, exp_impl=exp_impl)
        parts.append([t.to(q.device) for t in part])
    pm, pl, pnv = (torch.cat([part[i] for part in parts], dim=1)
                   for i in range(3))
    out = combine_partials(pm, pl, pnv, q.dtype)
    return _unfold_decode_out(out, b, hkv, group, f, p=p)


def fusemax_decode_latent(
    q: torch.Tensor,        # [B, H, P, rank + rope_dim] absorbed q_cat
    ckv: torch.Tensor,      # [B, M, rank]  (dense latent cache)
    krope: torch.Tensor,    # [B, M, rope_dim]
    kv_len: torch.Tensor,   # [B] valid lengths (the query is kv_len-1)
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    impl: str = "auto",
    splits: Optional[int] = None,
    block_k: Optional[int] = None,
    exp_impl: str = "native",
) -> torch.Tensor:
    """MLA decode (P = 1) or verify rows (P > 1) against a dense *latent*
    cache: the reference's ``fusemax_decode(q, [ckv | krope][:, None],
    ckv[:, None], kv_len)``, every head in the one group, returning the
    latent output ``[B, H, P, rank]`` for the caller's W_uv lift.

    ``splits`` / ``block_k`` left as ``None`` come from
    :func:`autotune.decode_params` at (E, F) = (rank + rope_dim, rank), as
    the reference's op resolves them.  "cuda" launches the dense latent
    kernel on ckv and krope where they lie, "torch" its plain version (K2's
    sweep on the concatenation), "ref" the 3-pass oracle on the
    concatenation."""
    b, hq, p, e = q.shape
    _, m, rank = ckv.shape
    rope_dim = krope.shape[-1]
    if e != rank + rope_dim:
        raise ValueError(f"q last dim {e} != rank {rank} + rope {rope_dim}")
    scale = scale if scale is not None else 1.0 / (e ** 0.5)
    impl = resolve_impl(impl, q)

    if impl == "meta":
        return _meta_attention(q, ckv[:, None], ckv[:, None]) \
            + krope.mean() * 0
    if impl == "ref":
        k = torch.cat([ckv, krope], dim=-1)[:, None]
        return fusemax_decode(q, k, ckv[:, None], kv_len, softcap=softcap,
                              scale=scale, impl="ref")

    splits, block_k = _decode_geometry(m, hq, e, rank, p, splits, block_k)
    q_f = _fold_decode_q(q, b, 1, hq, e)                     # [B, P·H, e]
    kw = dict(scale=scale, softcap=softcap, splits=splits, block_k=block_k,
              exp_impl=exp_impl, n_pos=p, rows_per_pos=hq)
    if impl == "cuda":
        pm, pl, pnv = latent_decode_partials_cuda(
            q_f.contiguous(), ckv, krope,
            kv_len.to(device=q.device, dtype=torch.int32).contiguous(), **kw)
    else:
        pm, pl, pnv = latent_decode_partials_torch(q_f, ckv, krope, kv_len,
                                                   **kw)
    out = combine_partials(pm, pl, pnv, q.dtype)
    return _unfold_decode_out(out, b, 1, hq, rank, p=p)


def gather_pages(pages: torch.Tensor,
                 block_table: torch.Tensor) -> torch.Tensor:
    """Materialize a block-table view of a page pool: pages
    ``[P, page_size, *tail]``, block_table ``[B, W]`` → ``[B, W·page_size,
    *tail]``.  Unbacked entries hold the sentinel id ``P``; the gather
    clamps them to the last page and callers mask by the logical length.
    The ref path and the prefix-hit prefill read through this; the paged
    kernel resolves pages itself and never builds the view."""
    b = block_table.shape[0]
    bt = torch.clamp(block_table.to(device=pages.device, dtype=torch.long),
                     max=pages.shape[0] - 1)
    return pages[bt].reshape(b, -1, *pages.shape[2:])


def fusemax_decode_paged(
    q: torch.Tensor,            # [B, Hq, P, E]
    k_pages: torch.Tensor,      # [P_pages, page_size, Hkv, E]
    v_pages: torch.Tensor,      # [P_pages, page_size, Hkv, F]
    block_table: torch.Tensor,  # [B, W] int page ids (sentinel = P_pages)
    kv_len: torch.Tensor,       # [B] valid logical lengths
    *,
    capacity: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
    splits: Optional[int] = None,
    block_k: Optional[int] = None,
    exp_impl: str = "native",
    k_scale: Optional[torch.Tensor] = None,   # [P_pages, page_size, Hkv]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode (P = 1) or verify rows (P > 1) against a *paged* KV cache.

    ``capacity`` truncates the logical view to that many tokens: a ring
    class (capacity = window, which may not fill the last page) read at
    ``kv_len = min(kv_len, window)``; ``None`` is the whole table (global
    layers).  "cuda" launches the paged kernel (pages found through the
    table inside the kernel), "torch" its plain version — both with
    page-aligned ``splits``/``block_k`` from
    :func:`autotune.paged_decode_params` when left as ``None``, on the
    whole table, where ``kv_len <= capacity`` masks the rest as the
    reference's Pallas path does; "ref" gathers the table's view, cut to
    ``capacity``, and runs the 3-pass oracle.

    ``k_scale`` / ``v_scale`` (fp16, one per token and kv head) mark the
    pools as quantized (int8 or fp8 e4m3 codes): "ref" dequantizes the
    gathered view before delegating, "cuda" and "torch" take them into K3
    and its plain version, which dequantize each tile.  The split geometry
    comes from the code's 1-byte elements, as the reference's does."""
    b, hq, p, e = q.shape
    n_pages, page_size, hkv, f = v_pages.shape
    w = block_table.shape[1]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (e ** 0.5)
    impl = resolve_impl(impl, q)

    if impl == "ref":
        cap = w * page_size if capacity is None else capacity
        k = gather_pages(k_pages, block_table)
        v = gather_pages(v_pages, block_table)
        if k_scale is not None:
            k = _dequant_tile(k, gather_pages(k_scale, block_table))
            v = _dequant_tile(v, gather_pages(v_scale, block_table))
        k = k.transpose(1, 2)[:, :, :cap]
        v = v.transpose(1, 2)[:, :, :cap]
        return fusemax_decode(q, k, v, kv_len, softcap=softcap, scale=scale,
                              impl="ref")

    if splits is None or block_k is None:
        tuned = autotune.paged_decode_params(
            w, page_size, max(group, 8), e, f,
            elem_bytes=k_pages.element_size())
        splits = tuned.splits if splits is None else splits
        block_k = tuned.block_k if block_k is None else block_k
    splits = max(1, min(splits, w))
    while w % splits:
        splits -= 1
    block_k = min(block_k, page_size)
    while page_size % block_k:
        block_k -= 1
    block_k = autotune.verify_block_k(block_k, p=p, g=max(group, 8), e=e,
                                      f=f)
    q_f = _fold_decode_q(q, b, hkv, group, e)
    kw = dict(scale=scale, softcap=softcap, hkv=hkv, splits=splits,
              block_k=block_k, exp_impl=exp_impl, n_pos=p,
              rows_per_pos=group, k_scale=k_scale, v_scale=v_scale)
    if impl == "cuda":
        pm, pl, pnv = paged_decode_partials_cuda(
            q_f.contiguous(), k_pages, v_pages,
            block_table.to(device=q.device, dtype=torch.int32).contiguous(),
            kv_len.to(device=q.device, dtype=torch.int32).contiguous(), **kw)
    else:
        pm, pl, pnv = paged_decode_partials_torch(
            q_f, k_pages, v_pages, block_table, kv_len, **kw)
    out = combine_partials(pm, pl, pnv, q.dtype)
    return _unfold_decode_out(out, b, hkv, group, f, p=p)


def fusemax_mla_decode_paged(
    q: torch.Tensor,            # [B, H, P, rank + rope_dim] absorbed q_cat
    ckv_pages: torch.Tensor,    # [P_pages, page_size, rank]
    krope_pages: torch.Tensor,  # [P_pages, page_size, rope_dim]
    block_table: torch.Tensor,  # [B, W] int page ids (sentinel = P_pages)
    kv_len: torch.Tensor,       # [B] valid logical lengths
    *,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    impl: str = "auto",
    splits: Optional[int] = None,
    block_k: Optional[int] = None,
    exp_impl: str = "native",
    ckv_scale: Optional[torch.Tensor] = None,
    krope_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MLA decode (P = 1) or verify rows (P > 1) against a paged *latent*
    cache.  Queries arrive W_uk-absorbed (``q_eff = q_nopeᵀW_uk``
    concatenated with ``q_rope``); the result is the latent output
    ``[B, H, P, rank]``, still to be lifted through W_uv by the caller.

    "cuda" launches the paged latent kernel (K4), "torch" its plain
    version — both with the Pallas kernel's page-aligned ``splits`` /
    ``block_k`` from :func:`autotune.mla_paged_decode_params` when left as
    ``None`` (the reference's jnp executor sweeps one split per page
    instead; the two agree within fp32 summation order, except that a
    ``kv_len = 0`` row is 0 here and a mean of the latents there).  "ref"
    gathers the table's view and runs the 3-pass oracle.  Quantized pools
    (int8 or fp8 e4m3 codes) pass ``ckv_scale`` / ``krope_scale`` (fp16,
    one per token): "ref" dequantizes the gathered view, "cuda" and
    "torch" take them into K4 and its plain version."""
    if (ckv_scale is None) != (krope_scale is None):
        raise ValueError("a quantized latent pool takes both ckv_scale and "
                         "krope_scale")
    b, hq, p, e = q.shape
    n_pages, page_size, rank = ckv_pages.shape
    rope_dim = krope_pages.shape[-1]
    w = block_table.shape[1]
    if e != rank + rope_dim:
        raise ValueError(f"q last dim {e} != rank {rank} + rope {rope_dim}")
    scale = scale if scale is not None else 1.0 / (e ** 0.5)
    impl = resolve_impl(impl, q)

    if impl == "ref":
        ckv = gather_pages(ckv_pages, block_table)          # [B, W·ps, r]
        kr = gather_pages(krope_pages, block_table)
        if ckv_scale is not None:
            ckv = _dequant_tile(ckv, gather_pages(ckv_scale, block_table))
            kr = _dequant_tile(kr, gather_pages(krope_scale, block_table))
        k = torch.cat([ckv, kr], dim=-1)[:, None]
        return fusemax_decode(q, k, ckv[:, None], kv_len, softcap=softcap,
                              scale=scale, impl="ref")

    splits, block_k = mla_paged_geometry(
        w, page_size, hq, rank, rope_dim, p=p,
        elem_bytes=ckv_pages.element_size(), splits=splits, block_k=block_k)
    q_f = _fold_decode_q(q, b, 1, hq, e)                     # [B, P·H, e]
    kw = dict(scale=scale, softcap=softcap, splits=splits, block_k=block_k,
              exp_impl=exp_impl, n_pos=p, rows_per_pos=hq,
              ckv_scale=ckv_scale, krope_scale=krope_scale)
    if impl == "cuda":
        pm, pl, pnv = mla_paged_decode_partials_cuda(
            q_f.contiguous(), ckv_pages, krope_pages,
            block_table.to(device=q.device, dtype=torch.int32).contiguous(),
            kv_len.to(device=q.device, dtype=torch.int32).contiguous(), **kw)
    else:
        pm, pl, pnv = mla_paged_decode_partials_torch(
            q_f, ckv_pages, krope_pages, block_table, kv_len, **kw)
    out = combine_partials(pm, pl, pnv, q.dtype)
    return _unfold_decode_out(out, b, 1, hq, rank, p=p)


def mla_paged_geometry(w: int, page_size: int, hq: int, rank: int,
                       rope_dim: int, *, p: int = 1, elem_bytes: int = 4,
                       splits: Optional[int] = None,
                       block_k: Optional[int] = None) -> tuple[int, int]:
    """(splits, block_k) of K4's sweep over a ``w``-page table as
    :func:`fusemax_mla_decode_paged` resolves them: the tuned pair from
    :func:`autotune.mla_paged_decode_params` (at the pool's element size)
    where left as ``None``, splits cut to a divisor of ``w``, ``block_k``
    to a divisor of the page, and the verify rows' ``block_k`` clamp."""
    if splits is None or block_k is None:
        tuned = autotune.mla_paged_decode_params(
            w, page_size, max(hq, 8), rank, rope_dim, elem_bytes=elem_bytes)
        splits = tuned.splits if splits is None else splits
        block_k = tuned.block_k if block_k is None else block_k
    splits = max(1, min(splits, w))
    while w % splits:
        splits -= 1
    block_k = min(block_k, page_size)
    while page_size % block_k:
        block_k -= 1
    return splits, autotune.verify_block_k(block_k, p=p, g=max(hq, 8),
                                           e=rank + rope_dim, f=rank)


def mla_strips(w: int, page_size: int, hq: int, rank: int, rope_dim: int,
               tp: int, *, p: int = 1, elem_bytes: int = 4):
    """How a ``tp``-way sharded decode sweeps a ``w``-page table: the
    unsharded K4 launch's (splits, block_k) (:func:`mla_paged_geometry`
    at the pool's element size) and, per shard ``d``, its contiguous
    strip ``(split_first, n_splits)`` of those splits, ``[d·S/tp,
    (d+1)·S/tp)`` rounded down.  Each strip is a slice of the unsharded
    sweep, so the strips' partials concatenated in shard order are its
    partials bit for bit.  Where ``tp`` does not divide the splits the
    strips differ in length and a shard may get none (``n_splits`` 0:
    it launches nothing); a geometry with more splits would balance them
    but change the fp32 summation order against the unsharded pool."""
    splits, block_k = mla_paged_geometry(w, page_size, hq, rank, rope_dim,
                                         p=p, elem_bytes=elem_bytes)
    bounds = [d * splits // tp for d in range(tp + 1)]
    return splits, block_k, [(lo, hi - lo)
                             for lo, hi in zip(bounds, bounds[1:])]


def fusemax_mla_decode_strip(
    q: torch.Tensor,            # [B, H, P, rank + rope_dim] absorbed q_cat
    ckv: torch.Tensor,          # [B, W·ps, rank] view, or [P_pages, ps, rank]
    krope: torch.Tensor,        # [B, W·ps, rope_dim], or [P_pages, ps, rd]
    kv_len: torch.Tensor,       # [B] valid logical lengths
    *,
    splits: int,
    block_k: int,
    split_first: int,
    n_splits: int,
    block_table: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    impl: str = "auto",
    exp_impl: str = "native",
    ckv_scale: Optional[torch.Tensor] = None,
    krope_scale: Optional[torch.Tensor] = None,
):
    """The latent decode's split-K partials over splits ``[split_first,
    split_first + n_splits)`` of a sweep of ``splits`` page-aligned splits
    (:func:`mla_strips`): ``(pm, pl, pnv)`` of shapes ``[B,
    n_splits, P·H]`` and ``[B, n_splits, P·H, rank]``, query rows folded
    as the kernels take them (:func:`combine_strips` merges the strips).

    Without ``block_table``, ``ckv`` / ``krope`` are the rank-complete
    view of a table's ``W·ps`` tokens (what the reference all-gathers on a
    rank-sharded pool) and "cuda" launches the dense latent kernel, K2's
    E ≠ F branch; with it, they are latent page pools and "cuda" launches
    K4 (with ``ckv_scale`` / ``krope_scale`` on code pools); "torch" runs
    the kernel's plain version.  The split length is the one a whole K4
    sweep of the table at ``splits`` uses, so a strip of the view and the
    same strip of the pool give the same bits.  There is no "ref" path:
    the 3-pass oracle has no partials."""
    b, hq, p, e = q.shape
    impl = resolve_impl(impl, q)
    if impl == "ref":
        raise ValueError("fusemax_mla_decode_strip: the 3-pass oracle has "
                         "no split-K partials; use impl 'cuda' or 'torch'")
    scale = scale if scale is not None else 1.0 / (e ** 0.5)
    q_f = _fold_decode_q(q, b, 1, hq, e)                     # [B, P·H, e]
    kw = dict(scale=scale, softcap=softcap, splits=splits, block_k=block_k,
              exp_impl=exp_impl, n_pos=p, rows_per_pos=hq,
              split_first=split_first, n_splits=n_splits)
    if block_table is None:
        if ckv_scale is not None or krope_scale is not None:
            raise ValueError("a dense latent view is dequantized before "
                             "the sweep; it takes no scales")
        if impl == "cuda":
            return latent_decode_partials_cuda(
                q_f.contiguous(), ckv, krope,
                kv_len.to(device=q.device, dtype=torch.int32).contiguous(),
                **kw)
        return latent_decode_partials_torch(q_f, ckv, krope, kv_len, **kw)
    kw.update(ckv_scale=ckv_scale, krope_scale=krope_scale)
    if impl == "cuda":
        return mla_paged_decode_partials_cuda(
            q_f.contiguous(), ckv, krope,
            block_table.to(device=q.device, dtype=torch.int32).contiguous(),
            kv_len.to(device=q.device, dtype=torch.int32).contiguous(), **kw)
    return mla_paged_decode_partials_torch(q_f, ckv, krope, block_table,
                                           kv_len, **kw)


def combine_strips(parts: list, q: torch.Tensor) -> torch.Tensor:
    """Combine the strips' partials (``(pm, pl, pnv)`` each, in split
    order, on ``q``'s device) into the latent output ``[B, H, P, rank]``
    of queries ``q`` — the unsharded sweep's combine on the concatenated
    stack."""
    b, hq, p, _ = q.shape
    pm, pl, pnv = (torch.cat([part[i] for part in parts], dim=1)
                   for i in range(3))
    out = combine_partials(pm, pl, pnv, q.dtype)
    return _unfold_decode_out(out, b, 1, hq, pnv.shape[-1], p=p)
