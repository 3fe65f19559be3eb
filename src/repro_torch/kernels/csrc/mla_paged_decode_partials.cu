// FuseMax paged split-K MLA decode partials in latent space, for Hopper
// (K4).
//
// Replaces: src/repro/kernels/decode.py:_mla_paged_decode_partials_kernel,
// launched by fusemax_mla_decode_paged_pallas (the TPU kernel behind
// ops.fusemax_mla_decode_paged), both of its branches: latent pools in the
// queries' dtype, and quantized pools (int8 or fp8 e4m3 codes with one
// fp16 scale per token for the latent and one for the rope key, the TPU
// kernel's `quantized` ckv_scale / krope_scale tiles).  The combine of the
// partials stays plain torch ops, as for K2 and K3.
//
// The kernel body (both products on the tensor cores in 3xTF32), what
// bounds it and what its design does about that are in
// mla_decode_partials.cuh, which the dense latent kernel
// (latent_decode_partials.cu) shares; this file binds it to the latent
// page pools ckv [P, ps, r] and krope [P, ps, rd] behind a block table
// [B, W] (PagedLatent): each split of split_len = (W / splits) * ps
// tokens, every key looked up in the table, as a chunk may straddle pages.

#include "mla_decode_partials.cuh"

namespace {

// T: the queries' element; S: the stored one (T, or an int8 / fp8 e4m3
// code, whose per-token fp16 scales sit in ckv_scale / krope_scale).
template <typename T, typename S, int RL, int RR, bool MACCS>
__global__ void __launch_bounds__(NT)
mla_paged_decode_partials_kernel(const T* __restrict__ q,
                                 const S* __restrict__ ckv,
                                 const S* __restrict__ krope,
                                 const __half* __restrict__ ckv_scale,
                                 const __half* __restrict__ krope_scale,
                                 const int* __restrict__ block_table,
                                 const int* __restrict__ kv_len,
                                 float* __restrict__ pm,
                                 float* __restrict__ pl,
                                 float* __restrict__ pnv, const MlaArgs a) {
  mla_partials_body<T, S, RL, RR, MACCS>(q, ckv, krope, ckv_scale,
                                         krope_scale, PagedLatent{block_table},
                                         kv_len, pm, pl, pnv, a);
}

// Where the pools live, as the C entry point receives them.
struct MlaSource {
  const void* ckv;
  const void* krope;
  const void* ckv_scale;    // code pools only: fp16 [n_pages, ps]
  const void* krope_scale;
  const void* block_table;
  const void* kv_len;
};

template <typename T, typename S, int RL, int RR, bool MACCS>
cudaError_t launch(const void* q, const MlaSource& src, void* pm, void* pl,
                   void* pnv, int b, const MlaArgs& a, cudaStream_t stream) {
  constexpr int smem = mla_smem_bytes(RL, RR, static_cast<int>(sizeof(S)),
                                      !std::is_same<T, S>::value);
  auto kern = mla_paged_decode_partials_kernel<T, S, RL, RR, MACCS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.splits, b, (a.rows + HB - 1) / HB);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const S*>(src.ckv),
      static_cast<const S*>(src.krope),
      static_cast<const __half*>(src.ckv_scale),
      static_cast<const __half*>(src.krope_scale),
      static_cast<const int*>(src.block_table),
      static_cast<const int*>(src.kv_len), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<float*>(pnv), a);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t dispatch(int rank, int rope_dim, int maccs, const void* q,
                     const MlaSource& src, void* pm, void* pl, void* pnv,
                     int b, const MlaArgs& a, cudaStream_t st) {
#define REPRO_DIMS(RL, RR)                                                    \
  if (rank == RL && rope_dim == RR)                                           \
    return maccs ? launch<T, S, RL, RR, true>(q, src, pm, pl, pnv, b, a, st)  \
                 : launch<T, S, RL, RR, false>(q, src, pm, pl, pnv, b, a, st);
  REPRO_DIMS(512, 64)
  REPRO_DIMS(32, 16)
#undef REPRO_DIMS
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the queries').  kv_code: 0 = the
// pools hold the queries' dtype; 1 = int8 codes, 2 = fp8 e4m3 codes, with
// fp16 scale pools ckv_scale / krope_scale [n_pages, page_size] (float32
// queries only; null otherwise).  (rank, rope_dim): (512, 64), the
// DeepSeek-V3 latent, or (32, 16), its smoke config's.  q [b, rows, rank +
// rope_dim] (rows = n_pos * G); ckv_pages [n_pages, page_size, rank];
// krope_pages [n_pages, page_size, rope_dim]; block_table [b, w] int32
// (sentinel = n_pages); kv_len [b] int32 -> pm, pl [b, splits, rows], pnv
// [b, splits, rows, rank] fp32.  Splits are page-aligned: split_len is a
// multiple of page_size (the whole sweep's (w / its splits) * page_size),
// and page_size % block_k == 0; the launch sweeps splits [split_first,
// split_first + splits), which lie inside the table (a whole sweep:
// split_first = 0).  softcap <= 0: no softcap.  split_first comes last,
// so an earlier build's interface is a prefix of this one.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mla_paged_decode_partials(
    const void* q, const void* ckv_pages, const void* krope_pages,
    const void* ckv_scale, const void* krope_scale, const void* block_table,
    const void* kv_len, void* pm, void* pl, void* pnv, int dtype,
    int kv_code, int rank, int rope_dim, int b, int rows, int n_pages,
    int page_size, int w, int splits, int split_len, int block_k, int n_pos,
    int rows_per_pos, float scale, float softcap, int exp_maccs,
    void* stream, int split_first) {
  const MlaArgs a{rows,      n_pages, page_size, w,            splits,
                  split_len, block_k, n_pos,     rows_per_pos, scale,
                  softcap,   split_first};
  const MlaSource src{ckv_pages, krope_pages, ckv_scale,
                      krope_scale, block_table, kv_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_code != 0 && (dtype != 0 || !ckv_scale || !krope_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_code == 0 && dtype == 0)
    err = dispatch<float, float>(rank, rope_dim, exp_maccs, q, src, pm, pl,
                                 pnv, b, a, st);
  else if (kv_code == 0 && dtype == 1)
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(
        rank, rope_dim, exp_maccs, q, src, pm, pl, pnv, b, a, st);
  else if (kv_code == 1)
    err = dispatch<float, int8_t>(rank, rope_dim, exp_maccs, q, src, pm, pl,
                                  pnv, b, a, st);
  else if (kv_code == 2)
    err = dispatch<float, __nv_fp8_e4m3>(rank, rope_dim, exp_maccs, q, src,
                                         pm, pl, pnv, b, a, st);
  return static_cast<int>(err);
}

// Dynamic shared memory of one launch at (rank, rope_dim), dtype and
// kv_code as for the launch (autotune.mla_decode_smem_bytes mirrors it).
extern "C" int mla_paged_decode_partials_smem_bytes(int rank, int rope_dim,
                                                    int dtype, int kv_code) {
  const int elem = kv_code ? 1 : (dtype == 1 ? 2 : 4);
  return mla_smem_bytes(rank, rope_dim, elem, kv_code != 0);
}
