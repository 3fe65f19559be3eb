"""Tile and split selection for the FuseMax kernels.

Port of ``repro.kernels.autotune``.  Two sources feed the decode
lookups (:func:`decode_params`, :func:`paged_decode_params`,
:func:`mla_paged_decode_params`), in priority order:

1. **Measured** entries: :func:`measure_best` times real candidate calls
   (:func:`time_fn`: the median of N after warmup, with CUDA events on
   the card) and puts the winner in the table under the lookup's key
   (:func:`decode_key`, :func:`paged_decode_key`,
   :func:`mla_paged_decode_key`: the reference's keys — the cache length
   or the table width and page size, the bucketed group, the head dims —
   never P); with ``REPRO_TORCH_AUTOTUNE_CACHE=/path.json`` the table is
   also written there, and read back by a later process before it
   models.  :func:`clear_table` drops both.
2. **Modeled** entries: a cost model seeded by the paper's 128×128 spatial
   array prices padding waste, per-tile overhead and the M-independent
   working set of each candidate.  The model is a pure function of the
   shape, so it is memoised with ``functools.lru_cache``, behind the
   table: a measured entry always wins.

Nothing measures by default: the serving paths take the modeled choice
unless a caller seeds the table.  The prefill tile is never measured
(below).

What the port changes:

* The CUDA prefill kernel (``csrc/fusemax_prefill.cu``) is compiled, per
  (E, F) pair, for one body and key tile and a few query-block plans
  (``CUDA_PREFILL``).  The plan of a call (:func:`prefill_plan`: the
  block's query rows and a split of the F output columns) is chosen from
  its fibers and rows so that the grid fills the card's SMs where the
  shape allows; every plan of a pair has the same tile, which
  ``attention_params(..., impl="cuda")`` returns after checking its
  shared-memory footprint against the card's per-block limit — the TPU's
  VMEM budget does not apply to it.  The kernel's wrapper holds each plan
  against the library's own ``fusemax_prefill_plan`` report at each
  launch.
* The split-K geometry (``decode_params``) is the reference's, for every
  impl: it is keyed on the cache length and never on P, so a later verify
  path inherits exactly the split structure of single-token decode.  The
  CUDA decode kernels' own layout (chunk, ring stages, row blocks, the
  grid) is mirrored by :func:`decode_smem_bytes` and
  :func:`decode_grid`, which their wrappers hold against ``SMEM_BUDGET``
  and the grid's limits before each launch.
* The table's keys drop the reference's backend and impl: the split
  geometry is the same for every impl.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import time
from typing import Callable, Optional, Sequence

#: the paper's 2D array edge (``SpatialArch.pe2d_rows/cols``) — the base
#: tile of the cost model
ARRAY_EDGE = 128

#: VMEM budget of the reference model (half of a 16 MiB VMEM); kept so the
#: modeled choices equal the reference's
VMEM_BUDGET = 8 * 2**20

#: per-tile fixed overhead in MACC-equivalents (reference calibration)
TILE_OVERHEAD = 4096

#: dynamic shared memory one block may use on an H100 (227 KB)
SMEM_BUDGET = 232_448

#: streaming multiprocessors of an H100 SXM: the blocks a prefill plan
#: aims to launch at least
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class PrefillKernel:
    """How ``csrc/fusemax_prefill.cu`` is compiled at one (E, F) pair:
    its ``body`` (``"wgmma"``, ``fusemax_prefill_wgmma.cuh``, or
    ``"mma_sync"``, the file's own), ``block_k`` keys a tile, the
    ``plans`` (block_q, f_split) in the order :func:`prefill_plan`
    prefers them (the default first; every plan has the same block_q),
    on the mma.sync body the warps that share one row group
    (``warp_split``, its ``WF``: each holds F / WF accumulator columns,
    and above 1 the probabilities go through shared memory), and on the
    wgmma body the split buffers each of K and of Vᵀ (``split_buffers``,
    its ``NBUF``: 2 where the next tile's split is written while the
    tensor cores read this one's, 1 where two do not fit beside Q's)."""
    body: str
    block_k: int
    plans: tuple
    warp_split: int = 1
    split_buffers: int = 2


#: (E, F) head dims → the kernel compiled there (``REPRO_WGMMA_PLANS`` with
#: its ``WgTile``, ``REPRO_DIMS`` with its ``PrefillTile``): on the wgmma
#: body (a warpgroup a 64-row block) GQA heads of 64 and 128 (32-key
#: tiles, double-buffered splits; two column blocks let a short chunk, a
#: serving quantum, come near filling the card), gemma's 256 (16-key
#: tiles, one split buffer: Q's split takes half the block) and
#: DeepSeek's MLA prefill (nope 128 + rope 64 → v 128; 32-key tiles, one
#: split buffer); on the mma.sync body its absorbed latent attention (rank
#: 512 + rope 64 → rank 512), and the smoke configs' GQA heads of 32 and
#: MLA (nope 32 + rope 16 → v 32, and rank 32 + rope 16 → rank 32)
CUDA_PREFILL = {
    (64, 64): PrefillKernel("wgmma", 32, ((64, 1), (64, 2))),
    (128, 128): PrefillKernel("wgmma", 32, ((64, 1), (64, 2))),
    (256, 256): PrefillKernel("wgmma", 16, ((64, 1),), split_buffers=1),
    (192, 128): PrefillKernel("wgmma", 32, ((64, 1),), split_buffers=1),
    (576, 512): PrefillKernel("mma_sync", 64, ((64, 1),), 4),
    (32, 32): PrefillKernel("mma_sync", 64, ((128, 1),)),
    (48, 32): PrefillKernel("mma_sync", 64, ((128, 1),)),
}

#: (E, F) → the (BQ, BK) tile of every plan at those dims
CUDA_PREFILL_TILES = {dims: (kern.plans[0][0], kern.block_k)
                      for dims, kern in CUDA_PREFILL.items()}

#: the prefill kernel's K chunk width (columns of E, the tile's ``KC``):
#: 64, or E where E is below 64 or no multiple of it
PREFILL_K_CHUNK = 64
CUDA_PREFILL_K_CHUNK = {(32, 32): 32, (48, 32): 48}

#: the prefill kernel's ring stages (``NS`` in ``fusemax_prefill.cu``)
PREFILL_STAGES = 3

#: the split-K decode kernels' (K2, K3) keys per chunk, ring stages and
#: warps that split a chunk's keys (``CK``, ``STAGES`` and ``WK`` in
#: ``csrc/decode_partials.cuh``)
DECODE_CHUNK = 16
DECODE_STAGES = 2
DECODE_KEY_WARPS = 4
#: the CUDA grid's limit on its y and z axes
GRID_YZ = 65535


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (1 for n ≤ 1).  Shared by the shape
    buckets here and the serving engine's admission-width padding."""
    return 1 << max(0, n - 1).bit_length()


def _bucket(n: int) -> int:
    """Shape bucket: next power of two — every shape in a bucket resolves
    to the same tiles regardless of call order."""
    return next_pow2(n)


@dataclasses.dataclass(frozen=True)
class AttentionParams:
    block_q: int
    block_k: int


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """One call's plan of the CUDA prefill kernel: ``block_q`` query rows
    and ``block_k`` keys a tile, the F output columns in ``f_split``
    column blocks (each recomputes its rows' scores), ``blocks`` launched
    (query tiles x fibers x column blocks)."""
    block_q: int
    block_k: int
    f_split: int
    blocks: int


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    splits: int
    block_k: int


def _prefill_v_chunk(block_k: int, f: int, k_chunk: int,
                     elem_bytes: int) -> int:
    """Keys of one V chunk (``v_chunk`` in the kernel): the largest power
    of two from 8 to ``block_k`` whose [keys x F] slab fits the ring slot
    of a [block_k x k_chunk] K chunk."""
    pad = 16 // elem_bytes
    vk = block_k
    while vk > 8 and vk * (f + pad) > block_k * (k_chunk + pad):
        vk //= 2
    return vk


def prefill_smem_bytes(block_q: int, block_k: int, e: int, f: int,
                       warp_split: int, elem_bytes: int = 4,
                       f_split: int = 1) -> int:
    """Shared memory of one prefill block.  On the wgmma body
    (``CUDA_PREFILL``) it must match ``WgLayout`` in
    ``fusemax_prefill_wgmma.cuh``: a raw K and a raw V tile of ``block_k``
    whole rows in the input's dtype, then fp32 splits (hi, and lo unless
    the input is bf16) of the block's Q, of the (E, F)'s
    ``PrefillKernel.split_buffers`` K tiles and as many Vᵀ tiles of its F
    / f_split columns, and 10 mbarriers.  On the mma.sync
    body (one column block) it must match ``Layout`` in
    ``fusemax_prefill.cu``: the Q tile, a ring of ``PREFILL_STAGES`` equal
    slots (a [block_k x KC] K chunk, KC from ``CUDA_PREFILL_K_CHUNK``, or
    a [VK x F] V chunk), every row padded by 16 bytes, and where
    ``warp_split`` warps share a row group the fp32 probability tile (rows
    padded by 8 floats) and the row-max exchange."""
    kern = CUDA_PREFILL.get((e, f))
    if kern is not None and kern.body == "wgmma":
        parts = 1 if elem_bytes == 2 else 2
        nbuf = kern.split_buffers
        return (elem_bytes * block_k * (e + f)
                + 4 * parts * (block_q * e + nbuf * block_k * e
                               + nbuf * f // f_split * block_k) + 80)
    if f_split != 1:
        raise ValueError("the mma.sync body has no column blocks")
    pad = 16 // elem_bytes
    kc = CUDA_PREFILL_K_CHUNK.get((e, f), PREFILL_K_CHUNK)
    vk = _prefill_v_chunk(block_k, f, kc, elem_bytes)
    slot = max(block_k * (kc + pad), vk * (f + pad))
    probs = (4 * block_q * (block_k + 8 + warp_split) if warp_split > 1
             else 0)
    return elem_bytes * (block_q * (e + pad) + PREFILL_STAGES * slot) + probs


def decode_row_block(rows: int) -> int:
    """Query rows one K2/K3 block serves (``row_block`` in the kernel): 4,
    or 8 when a fiber has more than 4, at every head dim: at 256 the 8-row
    block holds 128 query and accumulator floats a lane, which ptxas fits
    in 200-203 registers without a spill."""
    return 4 if rows <= 4 else 8


def decode_grid(rows: int, splits: int, fibers: int) -> tuple[int, int, int]:
    """The (x, y, z) grid of one K2/K3 launch of 128-thread blocks
    (``launch_partials`` in the kernel): ceil(rows / row block) blocks of
    rows on grid.x, so a split's blocks of rows run side by side and all
    but the first read its chunks from L2, then the splits and the
    fibers."""
    return -(-rows // decode_row_block(rows)), splits, fibers


@functools.lru_cache(maxsize=None)
def decode_smem_bytes(rows: int, d: int, elem_bytes: int = 4,
                      stages: int = DECODE_STAGES, pages: int = 0,
                      scaled: bool = False) -> int:
    """Shared memory of one K2/K3 block — must match ``smem_bytes`` in
    ``csrc/decode_partials.cuh``: the ring of ``stages`` chunks of
    ``DECODE_CHUNK`` K rows and as many V rows in the pool's dtype
    (``elem_bytes`` 1 for the codes of a quantized pool), which the
    cross-warp merge (fp32 m, l and accumulator of every key warp and row
    of the block) reuses after the walk, padded to 16 bytes; with
    ``scaled`` (a quantized pool) each stage's fp32 K and V scales of its
    chunk's keys; each warp's fp32 probabilities of a chunk and rescale
    factors of its rows; then the split's page list, ``pages`` int32 ids
    (K3: ``split_len / page_size``; K2: 0) padded to 4."""
    ring = stages * 2 * DECODE_CHUNK * d * elem_bytes
    rb = decode_row_block(rows)
    merge = 4 * DECODE_KEY_WARPS * rb * (d + 2)
    scales = 4 * stages * 2 * DECODE_CHUNK if scaled else 0
    pbuf = 4 * DECODE_KEY_WARPS * rb * (DECODE_CHUNK // DECODE_KEY_WARPS + 1)
    return (_round_up(max(ring, merge), 16) + scales + pbuf
            + 4 * _round_up(pages, 4))


#: keys per shared-memory chunk of the MLA latent decode body (K4 and
#: K2's E ≠ F branch, ``CK`` in ``csrc/mla_decode_partials.cuh``)
MLA_DECODE_CHUNK = 16
#: its cp.async ring stages (``NS``), query rows per block (the head
#: block, ``HB``) and warps splitting the score's k-steps (``ES``)
MLA_DECODE_STAGES = 3
MLA_DECODE_ROWS = 32
MLA_DECODE_SCORE_WARPS = 8


def mla_decode_smem_bytes(rank: int, rope_dim: int, elem_bytes: int = 4,
                          scaled: bool = False) -> int:
    """Shared memory of one MLA latent decode block — must match
    ``mla_smem_bytes`` in ``csrc/mla_decode_partials.cuh``: the ring of
    ``MLA_DECODE_STAGES`` chunks of ``MLA_DECODE_CHUNK`` ``[ckv | krope]``
    rows in the pool's dtype, each row padded by 16 bytes (1-byte codes
    for a quantized pool: 592 bytes a key at (512, 64)); with ``scaled``
    each stage's two fp32 scales per key (the latent's and the rope
    key's) and one chunk dequantized to fp32 (rows padded by 4 floats);
    the head block's ``MLA_DECODE_ROWS`` query rows padded by 16 bytes
    (fp32 beside a quantized pool, else the pool's dtype); then the score
    warps' fp32 partials of the head block, its fp32 P (rows of
    ``MLA_DECODE_CHUNK + 8`` words each) and its fp32 rescale factors."""
    e = rank + rope_dim
    ck, rows = MLA_DECODE_CHUNK, MLA_DECODE_ROWS
    ring = MLA_DECODE_STAGES * ck * (e + 16 // elem_bytes) * elem_bytes
    scales = (4 * MLA_DECODE_STAGES * ck * 2 + 4 * ck * (e + 4)
              if scaled else 0)
    qb = 4 if scaled else elem_bytes
    queries = rows * (e + 16 // qb) * qb
    tiles = 4 * ((MLA_DECODE_SCORE_WARPS + 1) * rows * (ck + 8) + rows)
    return ring + scales + queries + tiles


# ---------------------------------------------------------------------------
# Modeled costs (prior: the paper's 128×128 2D array)
# ---------------------------------------------------------------------------

def _attention_candidates(p: int, m: int) -> list[AttentionParams]:
    base = ARRAY_EDGE
    bqs = sorted({min(_round_up(p, 8), b) for b in (32, 64, base, 2 * base)})
    bks = sorted({min(_round_up(m, base), b)
                  for b in (base, 2 * base, 4 * base)})
    return [AttentionParams(bq, bk) for bq in bqs for bk in bks]


def _attention_cost(c: AttentionParams, p: int, m: int, e: int, f: int,
                    elem_bytes: int = 4) -> float:
    """Score = padded MACC work + per-tile overhead; ∞ if VMEM-infeasible."""
    vmem = (c.block_q * e + c.block_k * (e + f) + c.block_q * f
            + 2 * c.block_q * 128) * elem_bytes
    if vmem > VMEM_BUDGET:
        return float("inf")
    p_pad = _round_up(p, c.block_q)
    m_pad = _round_up(m, c.block_k)
    n_tiles = (p_pad // c.block_q) * (m_pad // c.block_k)
    work = p_pad * m_pad * (e + f)               # BQK + SLNV MACCs
    return work + n_tiles * TILE_OVERHEAD


def _decode_candidates(m: int) -> list[DecodeParams]:
    base = ARRAY_EDGE
    out = []
    for splits in (1, 2, 4, 8, 16):
        if splits > m:
            continue
        s = splits
        while m % s:                             # ragged M: shrink to a divisor
            s -= 1
        split_len = m // s
        if split_len < base and s > 1:
            continue
        for bk in (base, 2 * base, 4 * base):
            out.append(DecodeParams(s, min(bk, split_len)))
    return list(dict.fromkeys(out))


def _decode_cost(c: DecodeParams, m: int, g: int, e: int, f: int,
                 elem_bytes: int = 4) -> float:
    """Split-K decode: parallel sweep time + O(splits) combine cost."""
    vmem = (g * e + c.block_k * (e + f) + g * f + 2 * g * 128) * elem_bytes
    if vmem > VMEM_BUDGET:
        return float("inf")
    split_len = m // c.splits
    split_len = _round_up(split_len, min(c.block_k, split_len))
    sweep = split_len * g * (e + f)
    n_tiles = max(1, split_len // c.block_k)
    combine = c.splits * g * (f + 2)             # Eqs. 48-52 partial merge
    return sweep + n_tiles * TILE_OVERHEAD + combine


@functools.lru_cache(maxsize=None)
def _modeled_attention(pb: int, mb: int, e: int, f: int) -> AttentionParams:
    cands = _attention_candidates(pb, mb)
    return min(cands, key=lambda c: _attention_cost(c, pb, mb, e, f))


@functools.lru_cache(maxsize=None)
def prefill_plan(fibers: int, rows: int, e: int, f: int) -> PrefillPlan:
    """The CUDA prefill kernel's plan for ``fibers`` (B·Hkv) x ``rows``
    (P·G) folded query rows at head dims (E, F): the first of
    ``CUDA_PREFILL[(e, f)].plans`` whose grid reaches ``H100_SMS``
    blocks, else the one that launches the most (the first of equals).
    A plan with column blocks counts only while it launches at most
    ``H100_SMS`` blocks: each block recomputes its rows' scores, and on
    the card more blocks than SMs cost more than the SMs the default plan
    leaves idle, even at (64, 64), where two blocks fit an SM's shared
    memory (PERF.md).  The key tile, and
    with it a row's arithmetic, is the same under every plan of (E, F);
    M never enters.  Raises for head dims the kernel is not compiled
    for."""
    if (e, f) not in CUDA_PREFILL:
        raise ValueError(
            f"the CUDA prefill kernel is compiled for head dims (E, F) "
            f"in {sorted(CUDA_PREFILL)}, not ({e}, {f})")
    kern = CUDA_PREFILL[(e, f)]
    plans = [PrefillPlan(bq, kern.block_k, fs, -(-rows // bq) * fibers * fs)
             for bq, fs in kern.plans]
    plans = [p for p in plans if p.f_split == 1 or p.blocks <= H100_SMS]
    return next((p for p in plans if p.blocks >= H100_SMS),
                max(plans, key=lambda p: p.blocks))


def attention_params(p: int, m: int, e: int, f: int, *,
                     impl: str = "torch") -> AttentionParams:
    """Pick (block_q, block_k) for a prefill-shaped attention call.

    ``impl="cuda"`` returns the tile the CUDA kernel is compiled for at
    head dims (E, F) (every plan of :func:`prefill_plan` has it), and
    raises for a pair it is not compiled for or a plan that does not fit
    one block's shared memory; every other impl takes the reference's
    modeled choice from the power-of-two bucketed shape."""
    if impl == "cuda":
        if (e, f) not in CUDA_PREFILL:
            raise ValueError(
                f"the CUDA prefill kernel is compiled for head dims (E, F) "
                f"in {sorted(CUDA_PREFILL)}, not ({e}, {f})")
        kern = CUDA_PREFILL[(e, f)]
        bq, bk = CUDA_PREFILL_TILES[(e, f)]
        need = max(prefill_smem_bytes(pq, bk, e, f, kern.warp_split,
                                      f_split=fs) for pq, fs in kern.plans)
        if need > SMEM_BUDGET:
            raise ValueError(
                f"prefill tile {bq}x{bk} at head dims E={e}, F={f} needs "
                f"{need} B of shared memory > {SMEM_BUDGET} B per block")
        return AttentionParams(bq, bk)
    return _modeled_attention(_bucket(p), _bucket(m), e, f)


@functools.lru_cache(maxsize=None)
def _modeled_decode(m: int, g: int, e: int, f: int) -> DecodeParams:
    cands = _decode_candidates(m)
    return min(cands, key=lambda c: _decode_cost(c, m, g, e, f))


def decode_params(m: int, g: int, e: int, f: int) -> DecodeParams:
    """Pick (splits, block_k) for a split-K decode against an M-slot cache:
    the measured entry of :func:`decode_key`, else the model's.

    Keyed by the exact cache length (split validity depends on M's
    divisors) and never by P or the impl."""
    return _lookup(decode_key(m, g, e, f)) or _modeled_decode(m, g, e, f)


def _paged_decode_candidates(n_pages: int,
                             page_size: int) -> list[DecodeParams]:
    """Page-aligned split-K candidates: ``splits`` divides the table width
    (split boundaries fall on page boundaries) and ``block_k`` divides
    ``page_size`` (a key tile never straddles two pages)."""
    base = ARRAY_EDGE
    out = []
    for splits in (1, 2, 4, 8, 16):
        if splits > n_pages or n_pages % splits:
            continue
        split_tokens = (n_pages // splits) * page_size
        if split_tokens < base and splits > 1:
            continue
        for bk in (base, 2 * base, 4 * base):
            bk = min(bk, page_size)
            if page_size % bk:
                bk = page_size
            out.append(DecodeParams(splits, bk))
    return list(dict.fromkeys(out)) or [DecodeParams(1, page_size)]


@functools.lru_cache(maxsize=None)
def _modeled_paged_decode(n_pages: int, page_size: int, g: int, e: int,
                          f: int, elem_bytes: int) -> DecodeParams:
    m = n_pages * page_size
    cands = _paged_decode_candidates(n_pages, page_size)
    return min(cands, key=lambda c: _decode_cost(c, m, g, e, f,
                                                 elem_bytes=elem_bytes))


def paged_decode_params(n_pages: int, page_size: int, g: int, e: int,
                        f: int, elem_bytes: int = 4) -> DecodeParams:
    """Pick (splits, block_k) for a paged split-K decode over a block table
    ``n_pages`` wide: the measured entry of :func:`paged_decode_key`, else
    the cost model of :func:`decode_params` at M = n_pages·page_size,
    restricted to page-aligned candidates."""
    return (_lookup(paged_decode_key(n_pages, page_size, g, e, f,
                                     elem_bytes))
            or _modeled_paged_decode(n_pages, page_size, g, e, f,
                                     elem_bytes))


def mla_paged_decode_params(n_pages: int, page_size: int, g: int,
                            rank: int, rope_dim: int,
                            elem_bytes: int = 4) -> DecodeParams:
    """Pick (splits, block_k) for the paged *latent-space* MLA decode
    (K4): the measured entry of :func:`mla_paged_decode_key`, else the
    cost model of :func:`paged_decode_params` with e = rank + rope_dim,
    f = rank (the K stream is the concatenated latent page pair, the V
    stream the rank-wide latent itself) over the same page-aligned
    candidates — the reference's ``mla_paged_decode_params``, for every
    impl."""
    return (_lookup(mla_paged_decode_key(n_pages, page_size, g, rank,
                                         rope_dim, elem_bytes))
            or _modeled_paged_decode(n_pages, page_size, g,
                                     rank + rope_dim, rank, elem_bytes))


def verify_block_k(block_k: int, *, p: int, g: int, e: int, f: int,
                   elem_bytes: int = 4) -> int:
    """The reference's VMEM clamp for P > 1 verify rows: halve ``block_k``
    until the p-fold q tile fits ``VMEM_BUDGET``.  ``block_k`` is the
    granularity of the key tiles a split sweeps, which decides which tiles
    run for a row with no valid key, so the port applies the same clamp
    to keep those rows equal to the reference's; ``splits`` is never
    touched."""
    if p <= 1:
        return block_k
    rows = p * g
    while block_k > ARRAY_EDGE:
        vmem = (rows * e + block_k * (e + f) + rows * f
                + 2 * rows * 128) * elem_bytes
        if vmem <= VMEM_BUDGET:
            break
        block_k //= 2
    return block_k


# ---------------------------------------------------------------------------
# Table: measured > cached on disk > modeled
# ---------------------------------------------------------------------------

#: the environment variable naming the on-disk cache (a JSON file)
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"

_MEASURED: dict[tuple, tuple] = {}
_DISK: dict[tuple, tuple] = {}
_DISK_LOADED = False


def decode_key(m: int, g: int, e: int, f: int) -> tuple:
    """The table key of :func:`decode_params`."""
    return tuple(map(str, ("decode", m, _bucket(g), e, f)))


def paged_decode_key(n_pages: int, page_size: int, g: int, e: int, f: int,
                     elem_bytes: int = 4) -> tuple:
    """The table key of :func:`paged_decode_params`."""
    return tuple(map(str, ("pdecode", n_pages, page_size, _bucket(g), e, f,
                           elem_bytes)))


def mla_paged_decode_key(n_pages: int, page_size: int, g: int, rank: int,
                         rope_dim: int, elem_bytes: int = 4) -> tuple:
    """The table key of :func:`mla_paged_decode_params`."""
    return tuple(map(str, ("mla-pdecode", n_pages, page_size, _bucket(g),
                           rank, rope_dim, elem_bytes)))


def _load_disk_cache() -> None:
    global _DISK_LOADED
    if _DISK_LOADED:
        return
    _DISK_LOADED = True
    path = os.environ.get(CACHE_ENV)
    if not path or not os.path.exists(path):
        return
    with open(path) as fh:
        _DISK.update({tuple(k.split("|")): tuple(v)
                      for k, v in json.load(fh).items()})


def _save_disk_cache() -> None:
    path = os.environ.get(CACHE_ENV)
    if not path:
        return
    _load_disk_cache()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"|".join(k): list(v)
                   for k, v in {**_DISK, **_MEASURED}.items()}, fh, indent=1)


def _lookup(key: tuple) -> Optional[DecodeParams]:
    """The measured entry of ``key``, else the disk cache's, else None."""
    hit = _MEASURED.get(key)
    if hit is None:
        _load_disk_cache()
        hit = _DISK.get(key)
    return None if hit is None else DecodeParams(int(hit[0]), int(hit[1]))


def clear_table() -> None:
    """Drop every measured entry and the loaded disk cache (the file stays
    and is read again at the next lookup)."""
    global _DISK_LOADED
    _MEASURED.clear()
    _DISK.clear()
    _DISK_LOADED = False


# ---------------------------------------------------------------------------
# Measured mode
# ---------------------------------------------------------------------------

def _device_of(*objs):
    """The device of the first tensor in ``objs`` (nested in tuples or
    lists), or None."""
    import torch

    for o in objs:
        if isinstance(o, torch.Tensor):
            return o.device
        if isinstance(o, (tuple, list)):
            dev = _device_of(*o)
            if dev is not None:
                return dev
    return None


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    """Median seconds per ``fn(*args)`` call after ``warmup`` untimed ones.
    On a CUDA tensor's device (the first among ``args``, or else in the
    warmup's result) each call is timed with CUDA events on the current
    stream and synchronized; otherwise with the host clock."""
    import torch

    out = None
    for _ in range(warmup):
        out = fn(*args)
    dev = _device_of(*args, out)
    ts = []
    if dev is not None and dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def measure_best(
    make_fn: Callable[..., Callable],
    candidates: Sequence,
    *args,
    key: Optional[tuple] = None,
    iters: int = 5,
    warmup: int = 2,
):
    """Time each candidate with :func:`time_fn` and return
    ``(best_candidate, {candidate: seconds})``; a candidate whose call
    raises ``ValueError`` or ``RuntimeError`` (a geometry its kernel
    refuses) times as infinite.  ``make_fn(candidate)`` returns a callable
    taking ``*args``.  With ``key`` (one of :func:`decode_key`,
    :func:`paged_decode_key`, :func:`mla_paged_decode_key`) the winner goes
    into the table, and into the disk cache where ``CACHE_ENV`` names one,
    so that the key's lookup returns it."""
    timings: dict = {}
    for cand in candidates:
        try:
            timings[cand] = time_fn(make_fn(cand), *args, iters=iters,
                                    warmup=warmup)
        except (ValueError, RuntimeError):
            timings[cand] = float("inf")
    best = min(timings, key=timings.get)
    if timings[best] == float("inf"):
        raise RuntimeError(
            "measure_best: every candidate failed; nothing to return "
            f"(candidates={list(candidates)!r})")
    if key is not None:
        _MEASURED[tuple(map(str, key))] = dataclasses.astuple(best)
        _save_disk_cache()
    return best, timings
