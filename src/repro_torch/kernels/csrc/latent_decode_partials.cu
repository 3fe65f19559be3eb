// FuseMax split-K decode partials on a dense latent cache, for Hopper
// (K2's E != F branch).
//
// Replaces: src/repro/kernels/decode.py:_decode_partials_kernel at the
// only E != F call sites the reference has, its dense MLA decode and
// verify (model/attention.py: mla_decode, mla_verify), which launch it
// through fusemax_decode_pallas as fusemax_decode(q_cat [B, H, P, r + rd],
// k_cat = [ckv | krope] [B, 1, M, r + rd], v = ckv [B, 1, M, r]): Hkv = 1,
// every head in one group, and V the first r features of K.  This kernel
// computes that function, not the TPU kernel's block structure: it reads
// the latents ckv [B, M, r] and krope [B, M, rd] where they lie (the
// concatenation is never built) and uses each latent row as both key and
// value.  A general E != F kernel with an independent V would serve no
// call site.  The combine of the partials stays plain torch ops, as for
// K2.
//
// The kernel body (both products on the tensor cores in 3xTF32), what
// bounds it (bytes at DeepSeek's decode step: the latents and the fp32
// partials) and what its design does about that are in
// mla_decode_partials.cuh, which the paged latent kernel (K4) shares; this
// file binds it to the dense layout (DenseLatent: token kpos of sequence b
// is row b * M + kpos), so on a pool whose pages hold these rows K4 at the
// same splits gives the same bits.  Splits are K2's: split_len = M /
// splits, block_k dividing it.  The reference's dense layout stores no
// quantized latents, so this kernel has no code branch.

#include "mla_decode_partials.cuh"

namespace {

template <typename T, int RL, int RR, bool MACCS>
__global__ void __launch_bounds__(NT)
latent_decode_partials_kernel(const T* __restrict__ q,
                              const T* __restrict__ ckv,
                              const T* __restrict__ krope,
                              const int* __restrict__ kv_len,
                              float* __restrict__ pm, float* __restrict__ pl,
                              float* __restrict__ pnv, const int m,
                              const MlaArgs a) {
  mla_partials_body<T, T, RL, RR, MACCS>(q, ckv, krope, nullptr, nullptr,
                                         DenseLatent{m}, kv_len, pm, pl, pnv,
                                         a);
}

template <typename T, int RL, int RR, bool MACCS>
cudaError_t launch(const void* q, const void* ckv, const void* krope,
                   const void* kv_len, void* pm, void* pl, void* pnv, int b,
                   int m, const MlaArgs& a, cudaStream_t stream) {
  constexpr int smem =
      mla_smem_bytes(RL, RR, static_cast<int>(sizeof(T)), false);
  auto kern = latent_decode_partials_kernel<T, RL, RR, MACCS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.splits, b, (a.rows + HB - 1) / HB);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ckv),
      static_cast<const T*>(krope), static_cast<const int*>(kv_len),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<float*>(pnv), m, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int rank, int rope_dim, int maccs, const void* q,
                     const void* ckv, const void* krope, const void* kv_len,
                     void* pm, void* pl, void* pnv, int b, int m,
                     const MlaArgs& a, cudaStream_t st) {
#define REPRO_DIMS(RL, RR)                                                  \
  if (rank == RL && rope_dim == RR)                                         \
    return maccs ? launch<T, RL, RR, true>(q, ckv, krope, kv_len, pm, pl,   \
                                           pnv, b, m, a, st)                \
                 : launch<T, RL, RR, false>(q, ckv, krope, kv_len, pm, pl,  \
                                            pnv, b, m, a, st);
  REPRO_DIMS(512, 64)
  REPRO_DIMS(32, 16)
#undef REPRO_DIMS
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (queries and latents alike).  (rank,
// rope_dim): (512, 64), the DeepSeek-V3 latent, or (32, 16), its smoke
// config's.  q [b, rows, rank + rope_dim] (rows = n_pos * G, any count);
// ckv [b, m, rank]; krope [b, m, rope_dim], contiguous; kv_len [b] int32
// -> pm, pl [b, splits, rows], pnv [b, splits, rows, rank] fp32.
// split_len = m / splits, split_len % block_k == 0.  softcap <= 0: no
// softcap.  q, ckv and krope start on 16-byte boundaries.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int latent_decode_partials(
    const void* q, const void* ckv, const void* krope, const void* kv_len,
    void* pm, void* pl, void* pnv, int dtype, int rank, int rope_dim, int b,
    int rows, int m, int splits, int split_len, int block_k, int n_pos,
    int rows_per_pos, float scale, float softcap, int exp_maccs,
    void* stream) {
  const MlaArgs a{rows,      0,       0,     0,            splits,
                  split_len, block_k, n_pos, rows_per_pos, scale,
                  softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = dispatch<float>(rank, rope_dim, exp_maccs, q, ckv, krope, kv_len,
                          pm, pl, pnv, b, m, a, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(rank, rope_dim, exp_maccs, q, ckv, krope,
                                  kv_len, pm, pl, pnv, b, m, a, st);
  return static_cast<int>(err);
}

// Dynamic shared memory of one launch at (rank, rope_dim) and dtype (the
// same layout as K4's unquantized one: autotune.mla_decode_smem_bytes
// mirrors both).
extern "C" int latent_decode_partials_smem_bytes(int rank, int rope_dim,
                                                 int dtype) {
  return mla_smem_bytes(rank, rope_dim, dtype == 1 ? 2 : 4, false);
}
