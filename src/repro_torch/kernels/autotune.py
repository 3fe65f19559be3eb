"""Tile and split selection for the FuseMax kernels.

Port of the *modeled* half of ``repro.kernels.autotune``: the cost model
seeded by the paper's 128×128 spatial array prices padding waste,
per-tile overhead and the M-independent working set of each candidate,
and :func:`attention_params` / :func:`decode_params` /
:func:`paged_decode_params` / :func:`mla_paged_decode_params` return the
cheapest.
The model is a pure function of the (bucketed) shape, so it is memoised
with ``functools.lru_cache`` instead of a mutable table.

What the port changes:

* The CUDA prefill kernel (``csrc/fusemax_prefill.cu``) is compiled for
  one tile per (E, F) pair, so ``attention_params(..., impl="cuda")``
  returns that pair's tile (``CUDA_PREFILL_TILES``, the declaration the
  kernel's wrapper holds against the library's own
  ``fusemax_prefill_tile`` at each launch) after checking its
  shared-memory footprint against the card's per-block limit — the TPU's
  VMEM budget does not apply to it.
* The split-K geometry (``decode_params``) is the reference's, for every
  impl: it is keyed on the cache length and never on P, so a later verify
  path inherits exactly the split structure of single-token decode.  The
  CUDA decode kernels' own layout (chunk, ring stages, row blocks) is
  mirrored by :func:`decode_smem_bytes`, which their wrappers hold
  against ``SMEM_BUDGET`` before each launch.

The measured mode and its on-disk cache are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools

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

#: (E, F) head dims → the (BQ, BK) tile ``csrc/fusemax_prefill.cu`` is
#: compiled for at those dims (its ``PrefillTile``): GQA heads of 64, 128
#: and 256 (gemma), DeepSeek's MLA prefill (nope 128 + rope 64 → v 128)
#: and its absorbed latent attention (rank 512 + rope 64 → rank 512), and
#: the smoke configs' GQA heads of 32 and MLA (nope 32 + rope 16 → v 32,
#: and rank 32 + rope 16 → rank 32)
CUDA_PREFILL_TILES = {
    (64, 64): (128, 64),
    (128, 128): (128, 64),
    (192, 128): (128, 64),
    (576, 512): (64, 64),
    (256, 256): (64, 64),
    (32, 32): (128, 64),
    (48, 32): (128, 64),
}

#: (E, F) → the warps that share one row group of that tile (its ``WF``):
#: each holds F / WF accumulator columns, and above 1 the probabilities
#: go through shared memory
CUDA_PREFILL_WARP_SPLIT = {
    (64, 64): 1,
    (128, 128): 2,
    (192, 128): 2,
    (576, 512): 4,
    (256, 256): 4,
    (32, 32): 1,
    (48, 32): 1,
}

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
                       warp_split: int, elem_bytes: int = 4) -> int:
    """Shared memory of one prefill block — must match ``Layout`` in
    ``fusemax_prefill.cu``: the Q tile, a ring of ``PREFILL_STAGES`` equal
    slots (a [block_k x KC] K chunk, KC from ``CUDA_PREFILL_K_CHUNK``, or
    a [VK x F] V chunk), every row padded by 16 bytes, and where
    ``warp_split`` warps share a row group the fp32 probability tile (rows
    padded by 8 floats) and the row-max exchange."""
    pad = 16 // elem_bytes
    kc = CUDA_PREFILL_K_CHUNK.get((e, f), PREFILL_K_CHUNK)
    vk = _prefill_v_chunk(block_k, f, kc, elem_bytes)
    slot = max(block_k * (kc + pad), vk * (f + pad))
    probs = (4 * block_q * (block_k + 8 + warp_split) if warp_split > 1
             else 0)
    return elem_bytes * (block_q * (e + pad) + PREFILL_STAGES * slot) + probs


def decode_row_block(rows: int) -> int:
    """Query rows one K2/K3 block serves (``row_block`` in the kernel): 4,
    or 8 when a fiber has more than 4 (a fiber of R rows takes
    ceil(R / block) blocks per split), at every head dim: at 256 the 8-row
    block holds 128 query and accumulator floats a lane, which ptxas fits
    in 200-203 registers without a spill."""
    return 4 if rows <= 4 else 8


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
    chunk's keys; then the split's page list, ``pages`` int32 ids (K3:
    ``split_len / page_size``; K2: 0) padded to 4."""
    ring = stages * 2 * DECODE_CHUNK * d * elem_bytes
    merge = 4 * DECODE_KEY_WARPS * decode_row_block(rows) * (d + 2)
    scales = 4 * stages * 2 * DECODE_CHUNK if scaled else 0
    return _round_up(max(ring, merge), 16) + scales + 4 * _round_up(pages, 4)


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


def attention_params(p: int, m: int, e: int, f: int, *,
                     impl: str = "torch") -> AttentionParams:
    """Pick (block_q, block_k) for a prefill-shaped attention call.

    ``impl="cuda"`` returns the tile the CUDA kernel is compiled for at
    head dims (E, F), and raises for a pair it is not compiled for or a
    tile that does not fit one block's shared memory; every other impl
    takes the reference's modeled choice from the power-of-two bucketed
    shape."""
    if impl == "cuda":
        if (e, f) not in CUDA_PREFILL_TILES:
            raise ValueError(
                f"the CUDA prefill kernel is compiled for head dims (E, F) "
                f"in {sorted(CUDA_PREFILL_TILES)}, not ({e}, {f})")
        bq, bk = CUDA_PREFILL_TILES[(e, f)]
        need = prefill_smem_bytes(bq, bk, e, f,
                                  CUDA_PREFILL_WARP_SPLIT[(e, f)])
        if need > SMEM_BUDGET:
            raise ValueError(
                f"prefill tile {bq}x{bk} at head dims E={e}, F={f} needs "
                f"{need} B of shared memory > {SMEM_BUDGET} B per block")
        return AttentionParams(bq, bk)
    return _modeled_attention(_bucket(p), _bucket(m), e, f)


@functools.lru_cache(maxsize=None)
def decode_params(m: int, g: int, e: int, f: int) -> DecodeParams:
    """Pick (splits, block_k) for a split-K decode against an M-slot cache.

    Keyed by the exact cache length (split validity depends on M's
    divisors) and never by P or the impl."""
    cands = _decode_candidates(m)
    return min(cands, key=lambda c: _decode_cost(c, m, g, e, f))


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
def paged_decode_params(n_pages: int, page_size: int, g: int, e: int,
                        f: int, elem_bytes: int = 4) -> DecodeParams:
    """Pick (splits, block_k) for a paged split-K decode over a block table
    ``n_pages`` wide: the cost model of :func:`decode_params` at
    M = n_pages·page_size, restricted to page-aligned candidates."""
    m = n_pages * page_size
    cands = _paged_decode_candidates(n_pages, page_size)
    return min(cands, key=lambda c: _decode_cost(c, m, g, e, f,
                                                 elem_bytes=elem_bytes))


@functools.lru_cache(maxsize=None)
def mla_paged_decode_params(n_pages: int, page_size: int, g: int,
                            rank: int, rope_dim: int,
                            elem_bytes: int = 4) -> DecodeParams:
    """Pick (splits, block_k) for the paged *latent-space* MLA decode
    (K4): the K stream is the concatenated (rank + rope_dim) latent page
    pair and the V stream is the rank-wide latent itself, so the cost
    model of :func:`paged_decode_params` runs with e = rank + rope_dim,
    f = rank over the same page-aligned candidates — the reference's
    ``mla_paged_decode_params``, for every impl."""
    m = n_pages * page_size
    cands = _paged_decode_candidates(n_pages, page_size)
    return min(cands, key=lambda c: _decode_cost(
        c, m, g, rank + rope_dim, rank, elem_bytes=elem_bytes))


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
