// FuseMax paged split-K decode partials for Hopper (K3).
//
// Replaces: src/repro/kernels/decode.py:_paged_decode_partials_kernel,
// launched by fusemax_decode_paged_pallas (the TPU kernel behind
// ops.fusemax_decode_paged), unquantized pools.  The quantized branch
// (per-token k/v scale tiles) lands with the quantized pools.  The combine
// stays plain torch ops, as for the dense kernel.
//
// The TPU kernel finds each K/V tile's page in its BlockSpec index_map
// (scalar-prefetched block table).  Here each block loads its own split's
// page ids once, into shared memory (splits are page-aligned: split_len /
// page_size ids, the sentinel id n_pages clamped to the last page, whose
// keys lie past kv_len and are masked), and the body in
// decode_partials.cuh (shared with K2, so the same splits give the same
// bits) reads key row kpos at offset (kpos - split0) % ps of list entry
// (kpos - split0) / ps: a chunk's addresses are arithmetic, and a chunk
// may span several pages.  Pages are [n_pages, ps, Hkv, D], so
// consecutive tokens of one head are Hkv * D elements apart while each key
// row stays D contiguous elements, copied in 16-byte vectors.  The
// gathered [B, W * ps, ...] view is never materialized.
//
// What bounds it on this card: bytes — the valid K/V rows plus the block
// table over 3.35 TB/s (decode_partials.cuh).

#include "decode_partials.cuh"

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32, 64, 128 or 256 (E == F).
// q [B*Hkv, rows, D]; k_pages / v_pages [n_pages, page_size, hkv, D];
// block_table [B, w] int32 (sentinel = n_pages); kv_len [B] int32.
// Splits are page-aligned: split_len = (w / splits) * page_size, and
// page_size % block_k == 0.  q and the pages start on 16-byte boundaries.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_partials(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* kv_len, void* pm, void* pl,
    void* pnv, int dtype, int head_dim, int bh, int hkv, int rows,
    int n_pages, int page_size, int w, int splits, int split_len,
    int block_k, int n_pos, int rows_per_pos, float scale, float softcap,
    int exp_maccs, void* stream) {
  const DecodeArgs a{hkv,   rows,         splits, split_len, block_k,
                     n_pos, rows_per_pos, scale,  0,         softcap};
  KVSource src{};
  src.k = k_pages;
  src.v = v_pages;
  src.block_table = static_cast<const int*>(block_table);
  src.w = w;
  src.ps = page_size;
  src.n_pages = n_pages;
  src.hkv = hkv;
  return static_cast<int>(dispatch_partials<PagedKV>(
      dtype, head_dim, exp_maccs, q, src, kv_len, pm, pl, pnv, bh, a,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int paged_decode_partials_max_rows() { return MAXR; }

// Dynamic shared memory one launch takes: `pages` = split_len / page_size
// page-list entries (autotune.decode_smem_bytes mirrors it).
extern "C" int paged_decode_partials_smem_bytes(int rows, int head_dim,
                                                int dtype, int pages) {
  return smem_bytes(rows, head_dim, elem_bytes_of(dtype), pages);
}
