"""FuseMax split-K decode ("flash-decoding" over Cascade 5): the CUDA
partials kernels' wrappers, their plain torch versions, and the combine.

Port of ``repro.kernels.decode``.  Decode offers one query token per
sequence, so the 1-pass cascade runs twice:

1. each of S disjoint splits of the cache sweeps its key tiles with the
   running (m, l, acc) state and emits per-split partials — over a dense
   cache with :func:`decode_partials_torch` (plain) or
   :func:`decode_partials_cuda` (``csrc/decode_partials.cu``), over a page
   pool through a block table with :func:`paged_decode_partials_torch` or
   :func:`paged_decode_partials_cuda` (``csrc/paged_decode_partials.cu``),
   and DeepSeek's latent-space MLA decode over a latent page pool with
   :func:`mla_paged_decode_partials_torch` or
   :func:`mla_paged_decode_partials_cuda`
   (``csrc/mla_paged_decode_partials.cu``) or over a dense latent cache
   with :func:`latent_decode_partials_torch` or
   :func:`latent_decode_partials_cuda` (``csrc/latent_decode_partials.cu``,
   the dense kernel's E ≠ F branch; the two latent kernels share one body,
   ``csrc/mla_decode_partials.cuh``); each CUDA wrapper counts its
   launches in ``<wrapper>.launches`` and, by draft positions (1 for a
   decode step, P for a verify chain), in
   ``<wrapper>.launches_by_n_pos``, and the latent ones those of a strip
   of their splits in ``<wrapper>.launches_strips``;
2. :func:`combine_partials` merges them with the associative running-max
   algebra of Eqs. 48-52, in plain torch ops as the reference keeps it in
   jnp outside its ``pallas_call``.

Both partial paths follow the TPU kernel's semantics exactly: a tile runs
only if ``k_lo < kv_len + P - 1`` (and, with a window, ``k_hi > kv_len - 1
- window``), so a slot with ``kv_len = 0`` runs no tile and decodes to 0
(the jnp executor of the reference returns a mean of V there instead).

Layout: q ``[B·Hkv, R, E]`` with R = P·G folded query rows (row r is
draft position ``r // rows_per_pos``), k/v ``[B·Hkv, M, E/F]`` (dense) or
pages ``[P, page_size, Hkv, E/F]`` with a ``[B, W]`` int32 block table
whose unbacked entries hold the sentinel ``P`` (paged), kv_len ``[B]``
int32 → partials m, l ``[B·Hkv, S, R]`` and acc ``[B·Hkv, S, R, F]`` in
fp32, without the TPU's 128-lane padding.  The paged splits are
page-aligned and its key tiles lie inside one page.  The MLA partials
have one fiber per sequence (Hkv = 1, every head in the group): q ``[B,
R, r + rd]`` against ckv pages ``[P, page_size, r]`` and krope pages
``[P, page_size, rd]``; the score is ``q[:r]·ckv + q[r:]·krope`` and the
latent tile is also the value, so acc is ``[B, S, R, r]``.  The dense
latent partials take ckv ``[B, M, r]`` and krope ``[B, M, rd]`` with the
dense split geometry: they are the dense partials of ``q`` against K =
``[ckv | krope]`` and V = ``ckv`` with Hkv = 1, the only E ≠ F call the
reference makes of its dense kernel (its MLA decode and verify).

The latent partials (both kernels and both plain versions) also sweep a
*strip* of a split geometry: ``splits`` fixes the split length as for a
whole sweep, and ``split_first`` / ``n_splits`` pick the splits
``[split_first, split_first + n_splits)`` the call computes, so partials
come out ``[B, n_splits, R]``.  Every split is computed as in the whole
sweep, so the strips of a sweep concatenated in order are its partials
bit for bit — the rank-sharded pool's decode gives each shard one strip
(``repro_torch.model.attention.mla_decode_paged``).

Quantized pools (pages of fp8 e4m3 or int8 codes, ``QUANT_CODES``) pass
their fp16 scale pools — K3: ``k_scale`` / ``v_scale [P, page_size,
Hkv]``, K4: ``ckv_scale`` / ``krope_scale [P, page_size]``.  The plain
versions dequantize each gathered tile, ``code.float() * scale.float()``,
and then run the unchanged sweep; the kernels dequantize on their
shared-memory read.  The product is exact in fp32, so a quantized call
gives the same bits as the unquantized one on the dequantized pool at the
same splits.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.einsum import Cascade, Einsum, T
from repro_torch.kernels import autotune
from repro_torch.kernels.fusemax import (
    CUDA_DTYPES, NEG_INF, _exp, _ptr, _stream, check_cuda_operands,
)

#: head dims the GQA decode kernels (K2, K3) are instantiated for (E == F)
CUDA_HEAD_DIMS = (32, 64, 128, 256)
#: (rank, rope_dim) latents the MLA decode kernel (K4) is instantiated for
CUDA_MLA_DIMS = ((512, 64), (32, 16))
#: (rank, rope_dim) latents the dense latent kernel (K2's E ≠ F branch) is
#: instantiated for, with fp32 and bf16 queries
CUDA_LATENT_DIMS = ((512, 64), (32, 16))
#: code dtypes of quantized pools, by their code in K3's and K4's C
#: interface (0: the pages hold the queries' dtype); K3 and K4 are built
#: for them with fp32 queries, at every head dim / latent above
QUANT_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
#: the launch counters' names of the code dtypes
QUANT_NAMES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8_e4m3"}
#: most folded query rows (P·G) a fiber of K2 and K3 takes: the blocks of
#: rows lie on grid.x, whose limit no int row count reaches, so the bound
#: is the largest int R whose row indices up to R + 7 still fit an int
#: (the kernels' ``max_rows()``, held to the libraries' own report when
#: they load); K4 and K2's latent branch take any count
CUDA_MAX_ROWS = 2**31 - 8


def _check_head_dims(name: str, *tensors: torch.Tensor) -> None:
    dims = {t.shape[-1] for t in tensors}
    if len(dims) != 1 or next(iter(dims)) not in CUDA_HEAD_DIMS:
        raise ValueError(f"{name}: head dims {[t.shape[-1] for t in tensors]}"
                         f" — the kernel is built for E == F in "
                         f"{CUDA_HEAD_DIMS}")


def _check_vectors(name: str, **tensors: torch.Tensor) -> None:
    """Raise unless each tensor starts on a 16-byte boundary and its rows
    (last dim) are a multiple of 16 bytes apart: the K2/K3 kernels copy
    16-byte vectors and have no scalar path."""
    for label, t in tensors.items():
        if t.data_ptr() % 16 or (t.stride(-2) * t.element_size()) % 16:
            raise ValueError(
                f"{name}: {label} must start on a 16-byte boundary with rows "
                f"a multiple of 16 bytes apart (the kernel copies 16-byte "
                f"vectors); it starts {t.data_ptr() % 16} bytes past one, "
                f"rows {t.stride(-2) * t.element_size()} bytes apart")


def _check_grid(name: str, rows: int, splits: int, fibers: int) -> None:
    """Raise unless the K2/K3 grid of a launch
    (:func:`autotune.decode_grid`: the splits on grid.y, the fibers on
    grid.z) fits the CUDA grid's limits."""
    grid = autotune.decode_grid(rows, splits, fibers)
    if max(grid[1:]) > autotune.GRID_YZ:
        raise ValueError(f"{name}: grid {grid} too large")


def _check_smem(name: str, rows: int, d: int, elem_bytes: int,
                pages: int, scaled: bool = False) -> None:
    need = autotune.decode_smem_bytes(rows, d, elem_bytes, pages=pages,
                                      scaled=scaled)
    if need > autotune.SMEM_BUDGET:
        raise ValueError(f"{name}: {rows} rows at head dim {d} with a "
                         f"{pages}-page split list need {need} B of shared "
                         f"memory > {autotune.SMEM_BUDGET} B per block")


def _check_smem_mirror(fn, name: str, codes: bool = False) -> None:
    """Hold ``autotune.decode_smem_bytes`` to the kernel's own layout
    (``<name>_smem_bytes`` of the library) once, when it is loaded; with
    ``codes`` also at the 1-byte code pools and their scale slots (the
    entry point then takes the code as a fifth argument)."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * (5 if codes else 4)
    kinds = [(code, 0, dtype.itemsize, False)
             for dtype, code in CUDA_DTYPES.items()]
    if codes:
        kinds += [(0, kv_code, 1, True) for kv_code in QUANT_CODES.values()]
    for code, kv_code, eb, scaled in kinds:
        for rows in (1, 4, 5, 9, 52, 64, 128):
            for d in CUDA_HEAD_DIMS:
                for pages in (0, 8, 13):
                    got = fn(rows, d, code, pages, kv_code) if codes \
                        else fn(rows, d, code, pages)
                    want = autotune.decode_smem_bytes(
                        rows, d, eb, pages=pages, scaled=scaled)
                    if got != want:
                        raise RuntimeError(
                            f"{name}: kernel takes {got} B of shared memory "
                            f"at rows={rows} d={d} dtype code {code} kv code "
                            f"{kv_code} pages={pages}, "
                            f"autotune.decode_smem_bytes says {want}")


def _check_scales(name: str, pages: torch.Tensor, scales, shape) -> int:
    """The kv code of a launch: 0 for pages in the queries' dtype (no
    scales), else the pages' code dtype's, after checking that both scale
    pools are contiguous fp16 CUDA tensors of ``shape`` on the pages'
    device.  Raises on a quantized pool without its scales, or scales on
    an unquantized one."""
    quantized = pages.dtype in QUANT_CODES
    given = [t is not None for t in scales]
    if not quantized and not any(given):
        return 0
    if not quantized or not all(given):
        raise ValueError(f"{name}: pages of {pages.dtype} with "
                         f"{sum(given)} of 2 scale pools — code pools "
                         f"({list(QUANT_CODES)}) take both, others none")
    for t in scales:
        if t.dtype != torch.float16 or t.device != pages.device \
                or not t.is_contiguous() or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: scale pools must be contiguous fp16 "
                             f"{tuple(shape)} on {pages.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return QUANT_CODES[pages.dtype]


def _check_code_pools(name: str, q: torch.Tensor, *pools: torch.Tensor):
    """The checks of :func:`check_cuda_operands` for a quantized launch:
    fp32 queries (the only quantized instantiation) and contiguous code
    pools of one dtype on q's device."""
    if q.dtype != torch.float32:
        raise ValueError(f"{name}: quantized pools are built for fp32 "
                         f"queries, not {q.dtype}")
    check_cuda_operands(name, q)
    for t in pools:
        if t.device != q.device or t.dtype != pools[0].dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name}: code pools must be contiguous, of one "
                             f"dtype, on {q.device}")


def _count(wrapper, n_pos: int, pages: Optional[torch.Tensor] = None,
           strip: bool = False) -> None:
    """Add one launch to ``wrapper``'s counters: ``launches`` and
    ``launches_by_n_pos[n_pos]`` always, ``launches_by_code[name]`` on a
    quantized pool, ``launches_strips`` for a strip of the splits."""
    wrapper.launches += 1
    if strip:
        wrapper.launches_strips += 1
    wrapper.launches_by_n_pos[n_pos] = \
        wrapper.launches_by_n_pos.get(n_pos, 0) + 1
    if pages is not None and pages.dtype in QUANT_NAMES:
        key = QUANT_NAMES[pages.dtype]
        wrapper.launches_by_code[key] = \
            wrapper.launches_by_code.get(key, 0) + 1


def _dequant_tile(tile: torch.Tensor, scale: Optional[torch.Tensor]):
    """A gathered K/V tile (or table view) as fp32: codes × their scales,
    one per trailing vector (exact), or the tile itself on an unquantized
    pool."""
    return tile if scale is None else tile.float() * scale.float()[..., None]


def _split_geometry(m: int, splits: int, block_k: int) -> tuple[int, int]:
    """(split_len, block_k) as ``fusemax_decode_pallas`` derives them."""
    if m % splits:
        raise ValueError(f"M={m} not divisible by splits={splits}")
    split_len = m // splits
    block_k = min(block_k, split_len)
    if split_len % block_k:
        raise ValueError(f"split_len={split_len} % block_k={block_k}")
    return split_len, block_k


def _strip(splits: int, split_first: int, n_splits: Optional[int]) -> int:
    """The split count of a strip ``[split_first, split_first +
    n_splits)`` of ``splits`` (``n_splits`` None: the rest of them)."""
    n = splits - split_first if n_splits is None else n_splits
    if split_first < 0 or n < 1 or split_first + n > splits:
        raise ValueError(f"strip [{split_first}, {split_first + n}) is not "
                         f"inside {splits} splits")
    return n


def _sweep_partials(q: torch.Tensor, tiles, n_tiles: int, kvl: torch.Tensor,
                    split0: torch.Tensor, *, scale: float,
                    softcap: Optional[float], window: Optional[int],
                    block_k: int, exp_impl: str, n_pos: int,
                    rows_per_pos: int, f: int):
    """The running-state sweep both plain partials versions share: every
    (fiber, split) walks its ``n_tiles`` key tiles in lockstep and updates
    (m, l, acc) only on the tiles the TPU kernel runs.  ``tiles(t)``
    returns tile ``t`` of every split as K ``[BH, S, block_k, E]`` and V
    ``[BH, S, block_k, F]``; ``kvl`` is the per-fiber valid length and
    ``split0`` the logical index of each split's first key."""
    bh, r, _ = q.shape
    splits = split0.numel()
    dev = q.device
    q_pos = kvl - 1                                          # [BH]
    qf = q.float()
    pos = torch.arange(r, device=dev) // rows_per_pos        # [R]
    rm = torch.full((bh, splits, r), NEG_INF, dtype=torch.float32,
                    device=dev)
    rd = torch.zeros((bh, splits, r), dtype=torch.float32, device=dev)
    rnv = torch.zeros((bh, splits, r, f), dtype=torch.float32, device=dev)
    # a fill on the device, not a host copy (a captured step cannot copy)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for t in range(n_tiles):
        k_lo = split0 + t * block_k                          # [S]
        run = k_lo[None, :] < (kvl + (n_pos - 1))[:, None]   # [BH, S]
        if window is not None:
            run &= (k_lo + block_k - 1)[None, :] > (q_pos - window)[:, None]
        kt, vt = tiles(t)
        kt, vt = kt.float(), vt.float()
        sc = torch.einsum("bre,bske->bsrk", qf, kt) * scale  # [BH,S,R,bk]
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        kpos = k_lo[:, None] + torch.arange(block_k, device=dev)  # [S, bk]
        lim = kvl[:, None] + (pos if n_pos > 1 else 0 * pos)[None, :]
        ok = kpos[None, :, None, :] < lim[:, None, :, None]  # [BH,S,R,bk]
        if window is not None:
            ok = ok & (kpos[None, :, None, :]
                       > (q_pos - window)[:, None, None, None])
        sc = torch.where(ok, sc, neg)

        lm = sc.amax(dim=-1)
        m_new = torch.maximum(rm, lm)
        p = _exp(sc - m_new[..., None], exp_impl)
        sld = p.sum(dim=-1)
        prm = _exp(rm - m_new, exp_impl)
        slnv = torch.einsum("bsrk,bskf->bsrf", p, vt)
        run3 = run[..., None]
        rd = torch.where(run3, rd * prm + sld, rd)
        rnv = torch.where(run3[..., None], rnv * prm[..., None] + slnv, rnv)
        rm = torch.where(run3, m_new, rm)
    return rm, rd, rnv


def decode_partials_torch(
    q: torch.Tensor,        # [BHkv, R, E]
    k: torch.Tensor,        # [BHkv, M, E]
    v: torch.Tensor,        # [BHkv, M, F]
    kv_len: torch.Tensor,   # [B] int
    *,
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    hkv: int,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
    split_first: int = 0,
    n_splits: Optional[int] = None,
    strip_kv: bool = False,
):
    """Plain split-K partials, mirroring ``_decode_partials_kernel``: all
    splits sweep their key tiles in lockstep, each (fiber, split) updating
    its running state only on the tiles the TPU kernel runs.
    ``split_first`` / ``n_splits``: the strip of the ``splits`` to
    compute (default: all); ``strip_kv``: k / v hold only that strip's
    keys (a strip of a sequence-sharded cache, ``M·n_splits/splits``
    keys), else the whole cache, which the strip slices."""
    bh, r, e = q.shape
    m, f = v.shape[1], v.shape[2]
    n = _strip(splits, split_first, n_splits)
    if strip_kv:
        split_len, block_k = _split_geometry(m, n, block_k)
    else:
        split_len, block_k = _split_geometry(m, splits, block_k)
    dev = q.device
    kvl = kv_len.to(device=dev, dtype=torch.int64).repeat_interleave(hkv)
    strip = slice(0, n) if strip_kv else slice(split_first, split_first + n)
    k4 = k.reshape(bh, -1, split_len, e)[:, strip]
    v4 = v.reshape(bh, -1, split_len, f)[:, strip]

    def tiles(t):
        sl = slice(t * block_k, (t + 1) * block_k)
        return k4[:, :, sl], v4[:, :, sl]

    return _sweep_partials(
        q, tiles, split_len // block_k, kvl,
        torch.arange(split_first, split_first + n, device=dev) * split_len,
        scale=scale,
        softcap=softcap, window=window, block_k=block_k, exp_impl=exp_impl,
        n_pos=n_pos, rows_per_pos=r // n_pos if rows_per_pos is None
        else rows_per_pos, f=f)


def _paged_geometry(w: int, page_size: int, splits: int,
                    block_k: int) -> tuple[int, int]:
    """(split_pages, block_k) as ``fusemax_decode_paged_pallas`` derives
    them: page-aligned splits, key tiles inside one page."""
    if w % splits:
        raise ValueError(f"table width {w} not divisible by splits={splits}")
    block_k = min(block_k, page_size)
    if page_size % block_k:
        raise ValueError(f"page_size={page_size} % block_k={block_k}")
    return w // splits, block_k


def paged_decode_partials_torch(
    q: torch.Tensor,            # [BHkv, R, E]
    k_pages: torch.Tensor,      # [P, page_size, Hkv, E]
    v_pages: torch.Tensor,      # [P, page_size, Hkv, F]
    block_table: torch.Tensor,  # [B, W] int page ids (sentinel = P)
    kv_len: torch.Tensor,       # [B] int
    *,
    scale: float,
    softcap: Optional[float] = None,
    hkv: int,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # [P, page_size, Hkv] fp16
    v_scale: Optional[torch.Tensor] = None,
):
    """Plain paged split-K partials, mirroring
    ``_paged_decode_partials_kernel``: tile ``t`` of split ``s`` is the
    ``block_k`` keys at offset ``(t % (ps/block_k))·block_k`` of page
    ``block_table[b, s·W/S + t // (ps/block_k)]``, the sentinel clamped to
    ``P - 1`` (those keys lie past ``kv_len`` and are masked); masks and
    the tile-run rule use the logical token index.  A quantized pool's
    tiles are dequantized with the same lookup into its scale pools."""
    bh, r, e = q.shape
    n_pages, ps, hkv_p, f = v_pages.shape
    b, w = block_table.shape
    if hkv_p != hkv or bh != b * hkv:
        raise ValueError(f"q {tuple(q.shape)}, pages {tuple(v_pages.shape)}, "
                         f"table {tuple(block_table.shape)}, hkv={hkv}")
    split_pages, block_k = _paged_geometry(w, ps, splits, block_k)
    bpp = ps // block_k
    dev = q.device
    kvl = kv_len.to(device=dev, dtype=torch.int64).repeat_interleave(hkv)
    bt = torch.clamp(block_table.to(device=dev, dtype=torch.int64),
                     max=n_pages - 1)
    slot0 = torch.arange(splits, device=dev) * split_pages   # [S]

    def tiles(t):
        page = bt[:, slot0 + t // bpp]                        # [B, S]
        off = (t % bpp) * block_k
        # [B, S, bk, Hkv, E] → [B·Hkv, S, bk, E]
        sl = slice(off, off + block_k)
        kt = _dequant_tile(k_pages[:, sl][page],
                           None if k_scale is None else k_scale[:, sl][page])
        vt = _dequant_tile(v_pages[:, sl][page],
                           None if v_scale is None else v_scale[:, sl][page])
        return (kt.permute(0, 3, 1, 2, 4).reshape(bh, splits, block_k, e),
                vt.permute(0, 3, 1, 2, 4).reshape(bh, splits, block_k, f))

    return _sweep_partials(
        q, tiles, split_pages * bpp, kvl, slot0 * ps, scale=scale,
        softcap=softcap, window=None, block_k=block_k, exp_impl=exp_impl,
        n_pos=n_pos, rows_per_pos=r // n_pos if rows_per_pos is None
        else rows_per_pos, f=f)


def mla_paged_decode_partials_torch(
    q: torch.Tensor,            # [B, R, r + rd]
    ckv_pages: torch.Tensor,    # [P, page_size, r]
    krope_pages: torch.Tensor,  # [P, page_size, rd]
    block_table: torch.Tensor,  # [B, W] int page ids (sentinel = P)
    kv_len: torch.Tensor,       # [B] int
    *,
    scale: float,
    softcap: Optional[float] = None,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
    ckv_scale: Optional[torch.Tensor] = None,     # [P, page_size] fp16
    krope_scale: Optional[torch.Tensor] = None,
    split_first: int = 0,
    n_splits: Optional[int] = None,
):
    """Plain paged MLA partials in latent space, mirroring
    ``_mla_paged_decode_partials_kernel``: the paged sweep of
    :func:`paged_decode_partials_torch` with one fiber per sequence, the
    key tile ``[ckv | krope]`` (one dot over both halves, which the TPU
    kernel sums as two) and the ckv tile as the value tile.  A quantized
    pool's tiles are dequantized with their per-token scales.
    ``split_first`` / ``n_splits``: the strip of the ``splits`` to
    compute (default: all)."""
    b, r, e = q.shape
    n_pages, ps, rank = ckv_pages.shape
    bt_b, w = block_table.shape
    if e != rank + krope_pages.shape[-1] or bt_b != b \
            or krope_pages.shape[:2] != ckv_pages.shape[:2]:
        raise ValueError(f"q {tuple(q.shape)}, ckv pages "
                         f"{tuple(ckv_pages.shape)}, krope pages "
                         f"{tuple(krope_pages.shape)}, table "
                         f"{tuple(block_table.shape)}")
    split_pages, block_k = _paged_geometry(w, ps, splits, block_k)
    n = _strip(splits, split_first, n_splits)
    bpp = ps // block_k
    dev = q.device
    kvl = kv_len.to(device=dev, dtype=torch.int64)
    bt = torch.clamp(block_table.to(device=dev, dtype=torch.int64),
                     max=n_pages - 1)
    slot0 = torch.arange(split_first, split_first + n,
                         device=dev) * split_pages           # [S]

    def tiles(t):
        page = bt[:, slot0 + t // bpp]                        # [B, S]
        off = (t % bpp) * block_k
        sl = slice(off, off + block_k)
        ckv_t = _dequant_tile(                                # [B,S,bk,r]
            ckv_pages[:, sl][page],
            None if ckv_scale is None else ckv_scale[:, sl][page])
        kr_t = _dequant_tile(                                 # [B,S,bk,rd]
            krope_pages[:, sl][page],
            None if krope_scale is None else krope_scale[:, sl][page])
        return torch.cat([ckv_t, kr_t], dim=-1), ckv_t

    return _sweep_partials(
        q, tiles, split_pages * bpp, kvl, slot0 * ps, scale=scale,
        softcap=softcap, window=None, block_k=block_k, exp_impl=exp_impl,
        n_pos=n_pos, rows_per_pos=r // n_pos if rows_per_pos is None
        else rows_per_pos, f=rank)


def latent_decode_partials_torch(
    q: torch.Tensor,        # [B, R, r + rd]
    ckv: torch.Tensor,      # [B, M, r]
    krope: torch.Tensor,    # [B, M, rd]
    kv_len: torch.Tensor,   # [B] int
    *,
    scale: float,
    softcap: Optional[float] = None,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
    split_first: int = 0,
    n_splits: Optional[int] = None,
):
    """Plain dense latent partials: :func:`decode_partials_torch` with one
    fiber per sequence (Hkv = 1) on K = ``[ckv | krope]`` and V = ``ckv``
    — what ``_decode_partials_kernel`` computes at the reference's dense
    MLA call sites; ``split_first`` / ``n_splits`` pick a strip of the
    ``splits``."""
    return decode_partials_torch(
        q, torch.cat([ckv, krope], dim=-1), ckv, kv_len, scale=scale,
        softcap=softcap, hkv=1, splits=splits, block_k=block_k,
        exp_impl=exp_impl, n_pos=n_pos, rows_per_pos=rows_per_pos,
        split_first=split_first, n_splits=n_splits)


def combine_partials(pm: torch.Tensor, pl: torch.Tensor, pnv: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Combine split-K partials (associative running-max algebra,
    Eqs. 48-52): [BH, S, R], [BH, S, R], [BH, S, R, F] → [BH, R, F]."""
    gm = pm.amax(dim=1, keepdim=True)
    cf = torch.exp(pm - gm)                  # per-split correction factor
    rd = (pl * cf).sum(dim=1)                # [BH, R]
    rnv = (pnv * cf[..., None]).sum(dim=1)   # [BH, R, F]
    rd = torch.where(rd == 0.0, torch.ones_like(rd), rd)
    return (rnv / rd[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Declared cascades (checked against the kernels by repro_torch.analysis)
# ---------------------------------------------------------------------------

def _splitk_cascade(
    name: str,
    *,
    query_ranks: tuple[str, ...] = ("G",),
    mla: bool = False,
    causal_chain: bool = False,
) -> Cascade:
    """The split-K instantiation of Cascade 5 as a symbolic cascade.

    M is partitioned into (S, M2, M0): S independent splits (grid-parallel),
    M2 the per-split *iterative* rank (the key-chunk walk carrying the
    RM/RD/RNV running state), M0 the tile.  Per-split
    partials (PM, PD, PNV) are single final reads of the running state;
    the combine stage is the associative running-max algebra of Eqs. 48-52
    over the S axis — partial-M bookkeeping (O(S·G) work), not a pass.

    ``mla`` switches to the absorbed-score MLA form: the latent page
    stream BC plays both K (scores contract the latent rank R against the
    W_uk-absorbed queries, plus a rope dot) and V (the accumulator lives
    in latent space) — BC is read twice, but both reads sit in the same
    pass generation, so the cascade stays 1-pass with O(1) live state.

    ``causal_chain`` adds the k+1-token verify chain: the extra free query
    rank C rides every query-side tensor and the intra-draft causal mask
    is a *filtered* consumption of M (``m < kv_len + c``) — filtering
    touches a subset of each fiber and never acts as a pass barrier.
    """
    qr = query_ranks
    c = Cascade(name)
    c.partition("M", ("S", "M2", "M0"))
    blk = ("S", "M2", "M0")
    it = ("S", "M2*")       # running state: per-split, iterative over M2
    if mla:
        # latent pages [R, M] double as K and V; rope pages [O, M] are
        # score-only.  Queries arrive absorbed: QN[R, ...] ⊕ QR[O, ...].
        c.add(Einsum(T("BC", "R", *blk), (T("CKV", "R", "M"),), init=True))
        c.add(Einsum(T("BR", "O", *blk), (T("KR", "O", "M"),), init=True))
        v_rank = "R"
    else:
        c.add(Einsum(T("BK", "E", *blk), (T("K", "E", "M"),), init=True))
        c.add(Einsum(T("BV", "F", *blk), (T("V", "F", "M"),), init=True))
        v_rank = "F"
    c.add(Einsum(T("RM", *it, *qr), (), init=True))
    c.add(Einsum(T("RD", *it, *qr), (), init=True))
    c.add(Einsum(T("RNV", v_rank, *it, *qr), (), init=True))

    if mla:
        score_in = (T("QN", "R", *qr), T("BC", "R", *blk),
                    T("QR", "O", *qr), T("BR", "O", *blk))
    else:
        score_in = (T("Q", "E", *qr), T("BK", "E", *blk))
    if causal_chain:
        # intra-draft causal mask: position c sees keys m < kv_len + c
        score_in = (*score_in, T("CM", "M<=C", "C"))
    c.add(Einsum(T("BQK", *blk, *qr), score_in))                   # Eq. 42
    c.add(Einsum(T("LM", "S", "M2", *qr),
                 (T("BQK", *blk, *qr),), reduce_op="max"))         # Eq. 43
    c.add(Einsum(T("RM", *it, *qr),
                 (T("RM", *it, *qr), T("LM", *it, *qr)),
                 compute="max"))                                   # Eq. 44
    c.add(Einsum(T("SLN", *blk, *qr),
                 (T("BQK", *blk, *qr), T("RM", *it, *qr)),
                 compute="exp-sub"))                               # Eq. 45
    c.add(Einsum(T("SLD", "S", "M2", *qr), (T("SLN", *blk, *qr),)))  # Eq. 46
    c.add(Einsum(T("SLNV", v_rank, "S", "M2", *qr),
                 (T("SLN", *blk, *qr),
                  T("BC" if mla else "BV", v_rank, *blk))))        # Eq. 47
    c.add(Einsum(T("PRM", *it, *qr),
                 (T("RM", *it, *qr),), compute="exp-sub"))         # Eq. 48
    c.add(Einsum(T("SPD", "S", "M2", *qr),
                 (T("RD", *it, *qr), T("PRM", *it, *qr))))         # Eq. 49
    c.add(Einsum(T("RD", *it, *qr),
                 (T("SLD", *it, *qr), T("SPD", *it, *qr))))        # Eq. 50
    c.add(Einsum(T("SPNV", v_rank, "S", "M2", *qr),
                 (T("RNV", v_rank, *it, *qr), T("PRM", *it, *qr))))  # Eq. 51
    c.add(Einsum(T("RNV", v_rank, *it, *qr),
                 (T("SLNV", v_rank, *it, *qr),
                  T("SPNV", v_rank, *it, *qr))))                   # Eq. 52
    # per-split partials: the emitted (PM, PD, PNV) stacks — single final
    # reads of each split's running state (not passes over M)
    c.add(Einsum(T("PM", "S", *qr), (T("RM", "S", "M2$", *qr),)))
    c.add(Einsum(T("PD", "S", *qr), (T("RD", "S", "M2$", *qr),)))
    c.add(Einsum(T("PNV", v_rank, "S", *qr),
                 (T("RNV", v_rank, "S", "M2$", *qr),)))
    # combine: associative running-max algebra over S (_combine_partials)
    c.add(Einsum(T("GM", *qr), (T("PM", "S", *qr),), reduce_op="max"))
    c.add(Einsum(T("CF", "S", *qr),
                 (T("PM", "S", *qr), T("GM", *qr)), compute="exp-sub"))
    c.add(Einsum(T("SD", *qr), (T("PD", "S", *qr), T("CF", "S", *qr))))
    c.add(Einsum(T("SNV", v_rank, *qr),
                 (T("PNV", v_rank, "S", *qr), T("CF", "S", *qr))))
    c.add(Einsum(T("AV", v_rank, *qr),
                 (T("SNV", v_rank, *qr), T("SD", *qr)),
                 compute="÷"))                                     # Eq. 53
    return c


def decode_splitk_cascade() -> Cascade:
    """Dense split-K decode (:func:`decode_partials_cuda` and
    :func:`decode_partials_torch`; K2's E ≠ F branch,
    :func:`latent_decode_partials_cuda`, is this cascade on K = ``[ckv |
    krope]``, V = ``ckv``): 1 pass over M, O(1) live state."""
    return _splitk_cascade("decode-splitk-1pass")


def decode_paged_cascade() -> Cascade:
    """Paged split-K decode (:func:`paged_decode_partials_cuda`): same
    cascade as the dense kernel — the block table changes where tiles
    physically live, never how often they are read."""
    return _splitk_cascade("decode-paged-splitk-1pass")


def mla_decode_paged_cascade() -> Cascade:
    """Paged MLA absorbed-score decode
    (:func:`mla_paged_decode_partials_cuda`): the latent stream BC feeds
    both the score dot and the rank-space accumulator — two same-pass
    reads, still 1-pass with an O(G·R) accumulator."""
    return _splitk_cascade("mla-decode-paged-1pass", mla=True)


def verify_chain_cascade() -> Cascade:
    """k+1-token draft-chain verify (the GQA partials with ``n_pos > 1``): the
    chain rank C is a free query rank; the intra-draft causal mask is a
    filtered consumption of M.  Accumulators are O((k+1)·G) — independent
    of the cache length."""
    return _splitk_cascade("verify-chain-1pass",
                           query_ranks=("C", "G"), causal_chain=True)


def mla_verify_chain_cascade() -> Cascade:
    """MLA variant of the verify chain (absorbed scores, latent
    accumulator, free chain rank C)."""
    return _splitk_cascade("mla-verify-chain-1pass", mla=True,
                           query_ranks=("C", "G"), causal_chain=True)


def _check_max_rows(name: str, got: int) -> int:
    """Hold :data:`CUDA_MAX_ROWS` to a loaded library's own row limit."""
    if got != CUDA_MAX_ROWS:
        raise RuntimeError(f"{name}: the kernel takes {got} query rows, "
                           f"CUDA_MAX_ROWS says {CUDA_MAX_ROWS}")
    return got


@functools.lru_cache(maxsize=None)
def _partials_lib():
    """(kernel entry point, most query rows it takes) — builds at first
    use."""
    from repro_torch.kernels import _build

    lib = _build.load("decode_partials")
    fn = lib.decode_partials
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    max_rows = lib.decode_partials_max_rows
    max_rows.restype = ctypes.c_int
    max_rows.argtypes = []
    _check_smem_mirror(lib.decode_partials_smem_bytes, "decode_partials")
    return fn, _check_max_rows("decode_partials", max_rows())


def decode_partials_cuda(
    q: torch.Tensor,        # [BHkv, R, E]
    k: torch.Tensor,        # [BHkv, M, E]
    v: torch.Tensor,        # [BHkv, M, F]
    kv_len: torch.Tensor,   # [B] int32 on the same device
    *,
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    hkv: int,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
    split_first: int = 0,
    n_splits: Optional[int] = None,
):
    """Launch the CUDA split-K partials kernel on the current stream (no
    sync).  Same contract as :func:`decode_partials_torch`; q, k and v
    start on 16-byte boundaries.  A strip (``split_first`` / ``n_splits``
    of the ``splits``) takes a k / v that hold only its keys, as
    :func:`decode_partials_torch` with ``strip_kv`` (a strip of a
    sequence-sharded cache); ``launches_strips`` counts those launches."""
    check_cuda_operands("decode_partials_cuda", q, k, v)
    _check_head_dims("decode_partials_cuda", q, k, v)
    _check_vectors("decode_partials_cuda", q=q, k=k, v=v)
    bh, r, e = q.shape
    m = k.shape[1]
    if k.shape[0] != bh or v.shape[:2] != k.shape[:2]:
        raise ValueError(f"decode_partials_cuda: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kv_len.dtype != torch.int32 or kv_len.device != q.device \
            or not kv_len.is_contiguous() or kv_len.shape != (bh // hkv,) \
            or bh % hkv:
        raise ValueError(f"kv_len must be a contiguous int32 [B·Hkv/Hkv] "
                         f"tensor on {q.device}; got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    if exp_impl not in ("native", "maccs"):
        raise ValueError(f"unknown exp_impl {exp_impl!r}")
    rows_per_pos = r // n_pos if rows_per_pos is None else rows_per_pos
    n = _strip(splits, split_first, n_splits)
    split_len, block_k = _split_geometry(m, n, block_k)
    fn, max_rows = _partials_lib()
    if not 1 <= r <= max_rows:
        raise ValueError(f"{r} query rows per fiber; the kernel takes "
                         f"1..{max_rows}")
    _check_grid("decode_partials_cuda", r, n, bh)
    _check_smem("decode_partials_cuda", r, e, q.element_size(), 0)
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((bh, n, r), **f32)
    pl = torch.empty((bh, n, r), **f32)
    pnv = torch.empty((bh, n, r, v.shape[2]), **f32)
    err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(kv_len), _ptr(pm), _ptr(pl),
             _ptr(pnv), CUDA_DTYPES[q.dtype], e, bh, hkv, r, m, n,
             split_len, block_k, n_pos, rows_per_pos, float(scale),
             0 if window is None else int(window),
             0.0 if softcap is None else float(softcap),
             int(exp_impl == "maccs"), split_first, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"decode_partials launch failed: CUDA error {err}")
    _count(decode_partials_cuda, n_pos, strip=n < splits)
    return pm, pl, pnv


decode_partials_cuda.launches = 0
decode_partials_cuda.launches_strips = 0
decode_partials_cuda.launches_by_n_pos = {}


@functools.lru_cache(maxsize=None)
def _paged_lib():
    """(paged kernel entry point, most query rows it takes) — builds at
    first use."""
    from repro_torch.kernels import _build

    lib = _build.load("paged_decode_partials")
    fn = lib.paged_decode_partials
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    max_rows = lib.paged_decode_partials_max_rows
    max_rows.restype = ctypes.c_int
    max_rows.argtypes = []
    _check_smem_mirror(lib.paged_decode_partials_smem_bytes,
                       "paged_decode_partials", codes=True)
    return fn, _check_max_rows("paged_decode_partials", max_rows())


def paged_decode_partials_cuda(
    q: torch.Tensor,            # [BHkv, R, E]
    k_pages: torch.Tensor,      # [P, page_size, Hkv, E]
    v_pages: torch.Tensor,      # [P, page_size, Hkv, F]
    block_table: torch.Tensor,  # [B, W] int32 on the same device
    kv_len: torch.Tensor,       # [B] int32 on the same device
    *,
    scale: float,
    softcap: Optional[float] = None,
    hkv: int,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # [P, page_size, Hkv] fp16
    v_scale: Optional[torch.Tensor] = None,
):
    """Launch the CUDA paged split-K partials kernel
    (``csrc/paged_decode_partials.cu``) on the current stream (no sync).
    Same contract as :func:`paged_decode_partials_torch`; q and the pages
    start on 16-byte boundaries.  Pages of int8 or fp8 e4m3 codes take
    their scale pools and fp32 queries (``launches_by_code`` counts those
    launches by code dtype); any other combination raises."""
    name = "paged_decode_partials_cuda"
    kv_code = _check_scales(name, k_pages, (k_scale, v_scale),
                            k_pages.shape[:3])
    if kv_code:
        _check_code_pools(name, q, k_pages, v_pages)
    else:
        check_cuda_operands(name, q, k_pages, v_pages)
    _check_head_dims(name, q, k_pages, v_pages)
    _check_vectors(name, q=q, k_pages=k_pages, v_pages=v_pages)
    bh, r, e = q.shape
    n_pages, ps, hkv_p, f = v_pages.shape
    if k_pages.shape[:3] != v_pages.shape[:3] or hkv_p != hkv:
        raise ValueError(f"{name}: k_pages {tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}, hkv={hkv}")
    for label, t in (("block_table", block_table), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{label} must be a contiguous int32 tensor on "
                             f"{q.device}; got {t.dtype} on {t.device}")
    b, w = block_table.shape
    if bh != b * hkv or kv_len.shape != (b,):
        raise ValueError(f"q {tuple(q.shape)} is not B·Hkv fibers for a "
                         f"table {tuple(block_table.shape)} and kv_len "
                         f"{tuple(kv_len.shape)}")
    if exp_impl not in ("native", "maccs"):
        raise ValueError(f"unknown exp_impl {exp_impl!r}")
    rows_per_pos = r // n_pos if rows_per_pos is None else rows_per_pos
    split_pages, block_k = _paged_geometry(w, ps, splits, block_k)
    fn, max_rows = _paged_lib()
    if not 1 <= r <= max_rows:
        raise ValueError(f"{r} query rows per fiber; the kernel takes "
                         f"1..{max_rows}")
    _check_grid(name, r, splits, bh)
    _check_smem(name, r, e, k_pages.element_size(), split_pages,
                scaled=bool(kv_code))
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((bh, splits, r), **f32)
    pl = torch.empty((bh, splits, r), **f32)
    pnv = torch.empty((bh, splits, r, f), **f32)
    no_scale = ctypes.c_void_p(0)
    err = fn(_ptr(q), _ptr(k_pages), _ptr(v_pages),
             _ptr(k_scale) if kv_code else no_scale,
             _ptr(v_scale) if kv_code else no_scale, _ptr(block_table),
             _ptr(kv_len), _ptr(pm), _ptr(pl), _ptr(pnv),
             CUDA_DTYPES[q.dtype], kv_code, e, bh, hkv, r, n_pages, ps, w,
             splits, split_pages * ps, block_k, n_pos, rows_per_pos,
             float(scale), 0.0 if softcap is None else float(softcap),
             int(exp_impl == "maccs"), _stream(q.device))
    if err != 0:
        raise RuntimeError(
            f"paged_decode_partials launch failed: CUDA error {err}")
    _count(paged_decode_partials_cuda, n_pos, k_pages)
    return pm, pl, pnv


paged_decode_partials_cuda.launches = 0
paged_decode_partials_cuda.launches_by_code = {}
paged_decode_partials_cuda.launches_by_n_pos = {}


@functools.lru_cache(maxsize=None)
def _mla_lib():
    """The MLA paged kernel's entry point — builds at first use."""
    from repro_torch.kernels import _build

    lib = _build.load("mla_paged_decode_partials")
    fn = lib.mla_paged_decode_partials
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int])
    smem = lib.mla_paged_decode_partials_smem_bytes
    smem.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 4
    # hold autotune.mla_decode_smem_bytes to the kernel's own layout
    for rank, rope in CUDA_MLA_DIMS:
        for dtype, code in CUDA_DTYPES.items():
            kinds = [(code, 0, dtype.itemsize, False)]
            if dtype == torch.float32:
                kinds += [(code, kv, 1, True) for kv in QUANT_CODES.values()]
            for c, kv, eb, scaled in kinds:
                got = smem(rank, rope, c, kv)
                want = autotune.mla_decode_smem_bytes(rank, rope, eb,
                                                      scaled=scaled)
                if got != want:
                    raise RuntimeError(
                        f"mla_paged_decode_partials: kernel takes {got} B of "
                        f"shared memory at ({rank}, {rope}) dtype code {c} "
                        f"kv code {kv}, autotune.mla_decode_smem_bytes says "
                        f"{want}")
    return fn


def mla_paged_decode_partials_cuda(
    q: torch.Tensor,            # [B, R, r + rd]
    ckv_pages: torch.Tensor,    # [P, page_size, r]
    krope_pages: torch.Tensor,  # [P, page_size, rd]
    block_table: torch.Tensor,  # [B, W] int32 on the same device
    kv_len: torch.Tensor,       # [B] int32 on the same device
    *,
    scale: float,
    softcap: Optional[float] = None,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
    ckv_scale: Optional[torch.Tensor] = None,     # [P, page_size] fp16
    krope_scale: Optional[torch.Tensor] = None,
    split_first: int = 0,
    n_splits: Optional[int] = None,
):
    """Launch the CUDA paged MLA partials kernel
    (``csrc/mla_paged_decode_partials.cu``) on the current stream (no
    sync).  Same contract as :func:`mla_paged_decode_partials_torch`,
    strips included.
    Latent pools of int8 or fp8 e4m3 codes take their scale pools and
    fp32 queries (``launches_by_code`` counts those launches by code
    dtype); any other combination raises."""
    name = "mla_paged_decode_partials_cuda"
    kv_code = _check_scales(name, ckv_pages, (ckv_scale, krope_scale),
                            ckv_pages.shape[:2])
    if kv_code:
        _check_code_pools(name, q, ckv_pages, krope_pages)
    else:
        check_cuda_operands(name, q, ckv_pages, krope_pages)
    b, r, e = q.shape
    n_pages, ps, rank = ckv_pages.shape
    rope_dim = krope_pages.shape[-1]
    if (rank, rope_dim) not in CUDA_MLA_DIMS or e != rank + rope_dim \
            or krope_pages.shape[:2] != ckv_pages.shape[:2]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, ckv pages "
                         f"{tuple(ckv_pages.shape)}, krope pages "
                         f"{tuple(krope_pages.shape)} — the kernel is "
                         f"built for (rank, rope_dim) in {CUDA_MLA_DIMS}")
    for label, t in (("block_table", block_table), ("kv_len", kv_len)):
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{label} must be a contiguous int32 tensor on "
                             f"{q.device}; got {t.dtype} on {t.device}")
    for label, t in (("ckv_pages", ckv_pages), ("krope_pages", krope_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{label} must start on a 16-byte boundary (the "
                             f"kernel copies 16-byte vectors)")
    w = block_table.shape[1]
    if block_table.shape[0] != b or kv_len.shape != (b,):
        raise ValueError(f"q {tuple(q.shape)} is not one fiber per row of "
                         f"the table {tuple(block_table.shape)} and kv_len "
                         f"{tuple(kv_len.shape)}")
    if exp_impl not in ("native", "maccs"):
        raise ValueError(f"unknown exp_impl {exp_impl!r}")
    rows_per_pos = r // n_pos if rows_per_pos is None else rows_per_pos
    if r < 1 or n_pos < 1 or rows_per_pos < 1:
        raise ValueError(f"{r} query rows, n_pos={n_pos}, "
                         f"rows_per_pos={rows_per_pos}")
    split_pages, block_k = _paged_geometry(w, ps, splits, block_k)
    n = _strip(splits, split_first, n_splits)
    head_blocks = -(-r // autotune.MLA_DECODE_ROWS)
    if b > 65535 or head_blocks > 65535:
        raise ValueError(f"grid ({n}, {b}, {head_blocks}) too large")
    fn = _mla_lib()
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((b, n, r), **f32)
    pl = torch.empty((b, n, r), **f32)
    pnv = torch.empty((b, n, r, rank), **f32)
    no_scale = ctypes.c_void_p(0)
    err = fn(_ptr(q), _ptr(ckv_pages), _ptr(krope_pages),
             _ptr(ckv_scale) if kv_code else no_scale,
             _ptr(krope_scale) if kv_code else no_scale, _ptr(block_table),
             _ptr(kv_len), _ptr(pm), _ptr(pl), _ptr(pnv),
             CUDA_DTYPES[q.dtype], kv_code, rank, rope_dim, b, r, n_pages,
             ps, w, n, split_pages * ps, block_k, n_pos, rows_per_pos,
             float(scale), 0.0 if softcap is None else float(softcap),
             int(exp_impl == "maccs"), _stream(q.device), split_first)
    if err != 0:
        raise RuntimeError(
            f"mla_paged_decode_partials launch failed: CUDA error {err}")
    _count(mla_paged_decode_partials_cuda, n_pos, ckv_pages,
           strip=n < splits)
    return pm, pl, pnv


mla_paged_decode_partials_cuda.launches = 0
mla_paged_decode_partials_cuda.launches_strips = 0
mla_paged_decode_partials_cuda.launches_by_code = {}
mla_paged_decode_partials_cuda.launches_by_n_pos = {}


@functools.lru_cache(maxsize=None)
def _latent_lib():
    """The dense latent kernel's entry point — builds at first use."""
    from repro_torch.kernels import _build

    lib = _build.load("latent_decode_partials")
    fn = lib.latent_decode_partials
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int])
    smem = lib.latent_decode_partials_smem_bytes
    smem.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int] * 3
    # hold autotune.mla_decode_smem_bytes to the kernel's own layout
    for rank, rope in CUDA_LATENT_DIMS:
        for dtype, code in CUDA_DTYPES.items():
            got = smem(rank, rope, code)
            want = autotune.mla_decode_smem_bytes(rank, rope, dtype.itemsize)
            if got != want:
                raise RuntimeError(
                    f"latent_decode_partials: kernel takes {got} B of shared "
                    f"memory at ({rank}, {rope}) dtype code {code}, "
                    f"autotune.mla_decode_smem_bytes says {want}")
    return fn


def latent_decode_partials_cuda(
    q: torch.Tensor,        # [B, R, r + rd]
    ckv: torch.Tensor,      # [B, M, r]
    krope: torch.Tensor,    # [B, M, rd]
    kv_len: torch.Tensor,   # [B] int32 on the same device
    *,
    scale: float,
    softcap: Optional[float] = None,
    splits: int,
    block_k: int,
    exp_impl: str = "native",
    n_pos: int = 1,
    rows_per_pos: Optional[int] = None,
    split_first: int = 0,
    n_splits: Optional[int] = None,
):
    """Launch the CUDA dense latent partials kernel
    (``csrc/latent_decode_partials.cu``) on the current stream (no sync).
    Same contract as :func:`latent_decode_partials_torch`, strips
    included; q, ckv and
    krope are contiguous and start on 16-byte boundaries, at a latent in
    :data:`CUDA_LATENT_DIMS`; anything else raises."""
    name = "latent_decode_partials_cuda"
    check_cuda_operands(name, q, ckv, krope)
    b, r, e = q.shape
    _, m, rank = ckv.shape
    rope_dim = krope.shape[-1]
    if (rank, rope_dim) not in CUDA_LATENT_DIMS or e != rank + rope_dim:
        raise ValueError(f"{name}: q {tuple(q.shape)}, ckv "
                         f"{tuple(ckv.shape)}, krope {tuple(krope.shape)} — "
                         f"the kernel is built for (rank, rope_dim) in "
                         f"{CUDA_LATENT_DIMS}")
    if ckv.shape[0] != b or krope.shape[:2] != ckv.shape[:2]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, ckv "
                         f"{tuple(ckv.shape)}, krope {tuple(krope.shape)}")
    _check_vectors(name, q=q, ckv=ckv, krope=krope)
    if kv_len.dtype != torch.int32 or kv_len.device != q.device \
            or not kv_len.is_contiguous() or kv_len.shape != (b,):
        raise ValueError(f"kv_len must be a contiguous int32 [B] tensor on "
                         f"{q.device}; got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)} on {kv_len.device}")
    if exp_impl not in ("native", "maccs"):
        raise ValueError(f"unknown exp_impl {exp_impl!r}")
    rows_per_pos = r // n_pos if rows_per_pos is None else rows_per_pos
    if r < 1 or n_pos < 1 or rows_per_pos < 1:
        raise ValueError(f"{r} query rows, n_pos={n_pos}, "
                         f"rows_per_pos={rows_per_pos}")
    split_len, block_k = _split_geometry(m, splits, block_k)
    n = _strip(splits, split_first, n_splits)
    head_blocks = -(-r // autotune.MLA_DECODE_ROWS)
    if b > 65535 or head_blocks > 65535:
        raise ValueError(f"grid ({n}, {b}, {head_blocks}) too large")
    need = autotune.mla_decode_smem_bytes(rank, rope_dim, q.element_size())
    if need > autotune.SMEM_BUDGET:
        raise ValueError(f"{name}: ({rank}, {rope_dim}) needs {need} B of "
                         f"shared memory > {autotune.SMEM_BUDGET} B per block")
    fn = _latent_lib()
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((b, n, r), **f32)
    pl = torch.empty((b, n, r), **f32)
    pnv = torch.empty((b, n, r, rank), **f32)
    err = fn(_ptr(q), _ptr(ckv), _ptr(krope), _ptr(kv_len), _ptr(pm),
             _ptr(pl), _ptr(pnv), CUDA_DTYPES[q.dtype], rank, rope_dim, b, r,
             m, n, split_len, block_k, n_pos, rows_per_pos,
             float(scale), 0.0 if softcap is None else float(softcap),
             int(exp_impl == "maccs"), _stream(q.device), split_first)
    if err != 0:
        raise RuntimeError(
            f"latent_decode_partials launch failed: CUDA error {err}")
    _count(latent_decode_partials_cuda, n_pos, strip=n < splits)
    return pm, pl, pnv


latent_decode_partials_cuda.launches = 0
latent_decode_partials_cuda.launches_strips = 0
latent_decode_partials_cuda.launches_by_n_pos = {}
