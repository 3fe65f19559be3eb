// FuseMax paged split-K decode partials for Hopper (K3).
//
// Replaces: src/repro/kernels/decode.py:_paged_decode_partials_kernel,
// launched by fusemax_decode_paged_pallas (the TPU kernel behind
// ops.fusemax_decode_paged), both of its branches: pools in the queries'
// dtype, and quantized pools (int8 or fp8 e4m3 codes with fp16 scales per
// token and kv head, the TPU kernel's `quantized` scale tiles).  The
// combine of the partials stays plain torch ops, as for the dense kernel.
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
// gathered [B, W * ps, ...] view is never materialized.  A quantized
// pool's codes take the same ring, 16 codes a copy, and its scales a
// per-stage slot; each feature is dequantized on its shared-memory read
// (decode_partials.cuh).
//
// What bounds it on this card: bytes — the valid K/V rows (and, for
// codes, their 2-byte scales) plus the block table over 3.35 TB/s
// (decode_partials.cuh); 1-byte codes move a quarter of fp32's bytes.

#include "decode_partials.cuh"

// dtype: 0 = float32, 1 = bfloat16 (the queries').  kv_code: 0 = the
// pages hold the queries' dtype; 1 = int8 codes, 2 = fp8 e4m3 codes, with
// fp16 scale pools k_scale / v_scale [n_pages, page_size, hkv] (float32
// queries only; null otherwise).  head_dim: 32, 64, 128 or 256 (E == F).
// q [B*Hkv, rows, D]; k_pages / v_pages [n_pages, page_size, hkv, D];
// block_table [B, w] int32 (sentinel = n_pages); kv_len [B] int32.
// Splits are page-aligned: split_len = (w / splits) * page_size, and
// page_size % block_k == 0.  q and the pages start on 16-byte boundaries.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_partials(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* block_table,
    const void* kv_len, void* pm, void* pl, void* pnv, int dtype,
    int kv_code, int head_dim, int bh, int hkv, int rows, int n_pages,
    int page_size, int w, int splits, int split_len, int block_k,
    int n_pos, int rows_per_pos, float scale, float softcap, int exp_maccs,
    void* stream) {
  const DecodeArgs a{hkv,   rows,         splits, split_len, block_k,
                     n_pos, rows_per_pos, scale,  0,         softcap,
                     0};
  KVSource src{};
  src.k = k_pages;
  src.v = v_pages;
  src.k_scale = k_scale;
  src.v_scale = v_scale;
  src.block_table = static_cast<const int*>(block_table);
  src.w = w;
  src.ps = page_size;
  src.n_pages = n_pages;
  src.hkv = hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_code == 0)
    return static_cast<int>(dispatch_partials<PagedKV>(
        dtype, head_dim, exp_maccs, q, src, kv_len, pm, pl, pnv, bh, a, st));
  if (dtype != 0 || !k_scale || !v_scale)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_code == 1)
    return static_cast<int>(dispatch_partials<PagedInt8KV, false>(
        dtype, head_dim, exp_maccs, q, src, kv_len, pm, pl, pnv, bh, a, st));
  if (kv_code == 2)
    return static_cast<int>(dispatch_partials<PagedFp8KV, false>(
        dtype, head_dim, exp_maccs, q, src, kv_len, pm, pl, pnv, bh, a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Most folded query rows a fiber takes (max_rows() in decode_partials.cuh).
extern "C" int paged_decode_partials_max_rows() { return max_rows(); }

// Dynamic shared memory one launch takes: `pages` = split_len / page_size
// page-list entries; kv_code as for the launch (1-byte codes and their
// scale slots) (autotune.decode_smem_bytes mirrors it).
extern "C" int paged_decode_partials_smem_bytes(int rows, int head_dim,
                                                int dtype, int pages,
                                                int kv_code) {
  return smem_bytes(rows, head_dim, kv_code ? 1 : elem_bytes_of(dtype),
                    pages, kv_code != 0);
}
