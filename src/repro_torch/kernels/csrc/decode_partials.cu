// FuseMax split-K decode partials for Hopper, dense cache (K2).
//
// Replaces: src/repro/kernels/decode.py:_decode_partials_kernel, launched
// by fusemax_decode_pallas (the TPU kernel behind ops.fusemax_decode).
// The combine of the partials (decode.py:_combine_partials) stays plain
// torch ops, as the reference keeps it in jnp outside the pallas_call.
//
// The kernel body, what bounds it and what its design does about that are
// in decode_partials.cuh, which the paged kernel (K3) shares; this file
// binds it to the dense layout: k / v are [B*Hkv, M, D], key row kpos of
// fiber bh at (bh * M + kpos) * D.

#include "decode_partials.cuh"

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32, 64, 128 or 256 (E == F).
// rows: folded query rows per fiber, 1..max_rows().  window <= 0: no window;
// softcap <= 0: no softcap.  q, k and v start on 16-byte boundaries (the
// body copies 16-byte vectors).  A strip of a sequence-sharded cache:
// splits split_first .. split_first + splits - 1 of a longer sweep, whose
// k / v hold only their m = splits * split_len keys (global keys from
// split_first * split_len); a whole sweep has split_first 0.  Returns
// cudaGetLastError() after the launch.
extern "C" int decode_partials(const void* q, const void* k, const void* v,
                               const void* kv_len, void* pm, void* pl,
                               void* pnv, int dtype, int head_dim, int bh,
                               int hkv, int rows, int m, int splits,
                               int split_len, int block_k, int n_pos,
                               int rows_per_pos, float scale, int window,
                               float softcap, int exp_maccs, int split_first,
                               void* stream) {
  const DecodeArgs a{hkv,   rows,         splits, split_len, block_k,
                     n_pos, rows_per_pos, scale,  window,    softcap,
                     split_first};
  KVSource src{};
  src.k = k;
  src.v = v;
  src.m = m;
  src.k0 = split_first * split_len;
  return static_cast<int>(dispatch_partials<DenseKV>(
      dtype, head_dim, exp_maccs, q, src, kv_len, pm, pl, pnv, bh, a,
      static_cast<cudaStream_t>(stream)));
}

// Most folded query rows a fiber takes (max_rows() in decode_partials.cuh).
extern "C" int decode_partials_max_rows() { return max_rows(); }

// Dynamic shared memory one launch with `rows` query rows per fiber takes
// (autotune.decode_smem_bytes mirrors it; the dense layout has no page
// list, so `pages` is 0 on its launches).
extern "C" int decode_partials_smem_bytes(int rows, int head_dim, int dtype,
                                          int pages) {
  return smem_bytes(rows, head_dim, elem_bytes_of(dtype), pages, false);
}
