// FuseMax 1-pass prefill attention (Cascade 5, Mapping 1) for Hopper.
//
// Replaces: src/repro/kernels/fusemax.py:_fusemax_kernel, launched by
// fusemax_attention_pallas (the TPU kernel behind ops.fusemax_attention).
//
// What it computes (the TPU kernel's function, not its block structure):
//   q [BH, PG, E] (GQA group folded into query rows: row r is query
//   position r / group + q_offset), k [BH, M, E], v [BH, M, F]; per row
//   the running max / denominator / numerator·V (RM, RD, RNV, Eqs. 39-41)
//   over the key tiles the TPU kernel runs, masks for causal, window and
//   m_valid, optional softcap, exp native or by 6 MACCs (Horner), and one
//   deferred division at the end (Eq. 53) with the l = 0 -> 1 guard.
//   NEG_INF is the finite -1e30 of the reference: a row that is fully
//   masked inside a tile that runs picks up exp(0) = 1 terms, which the
//   next valid tile's correction factor exp(-1e30 - m) erases.
//
// What bounds it on this card: operations.  At prefill sizes each K/V
// tile is reused by a BQ-row Q tile, so the two matrix products
// (PG * M * (E + F) multiply-adds per fiber, halved by the causal bound)
// outweigh the bytes read; in fp32 the ceiling is the 67 TFLOP/s of the
// non-tensor FP32 units.
//
// What the simple design does about it: one block per (BQ-row query
// tile, batch*kv-head fiber), 256 threads.  The Q tile stays in shared
// memory for the whole sweep (output-stationary), K/V tiles of BK keys
// stream through shared memory, and each thread keeps a (BQ/16)x(BK/16)
// block of scores and a (BQ/16)x(F/16) block of the accumulator in
// registers, so every shared-memory read feeds several FMAs.
//
// The tile is chosen per (E, F) instantiation (PrefillTile below) so that
// one block's fp32 tiles fit the 227 KB of shared memory:
//   (64, 64), (128, 128) -- GQA heads (granite): 64 x 64;
//   (192, 128)           -- DeepSeek MLA prefill (nope 128 + rope 64 ->
//                           v 128, mla_forward): 64 x 64, 148 KB;
//   (576, 512)           -- DeepSeek absorbed latent attention (rank 512 +
//                           rope 64 -> rank 512, _mla_absorbed_attend):
//                           32 x 32, 212 KB, 64 accumulator floats a
//                           thread (64 x 64 would need 459 KB).
// Rows of Q and K are padded by one float so that column reads are free
// of bank conflicts.  The TPU's
// sequential M1 grid axis becomes the loop over key tiles, and the TPU's
// per-tile skip becomes the loop bounds.  All arithmetic is true fp32
// FMA (no TF32); bf16 inputs are widened on load.  Tensor cores (wgmma),
// TMA and warp specialisation are left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 256;       // threads: 16 x 16
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// exp(x) for x <= 0 with 6 multiply-adds: 2^n by building the exponent
// field, 2^f on [0, 1) by a Horner chain (fusemax.py:_EXP2_COEFFS).
__device__ __forceinline__ float exp_maccs(float x) {
  float t = fmaxf(x * LOG2E, -126.0f);
  float n = floorf(t);
  float f = t - n;
  float p = 0.00015403530393381608f;
  p = p * f + 0.0013333558146428443f;
  p = p * f + 0.009618129107628477f;
  p = p * f + 0.05550410866482158f;
  p = p * f + 0.24022650695910072f;
  p = p * f + 0.6931471805599453f;
  p = p * f + 1.0f;
  return p * __int_as_float((static_cast<int>(n) + 127) << 23);
}

template <bool MACCS>
__device__ __forceinline__ float fexp(float x) {
  return MACCS ? exp_maccs(x) : expf(x);
}

// The tile of each (E, F) instantiation: BQ query rows x BK keys, both
// multiples of 16 (each of the 16 x 16 threads takes BQ/16 rows and BK/16
// keys); F a multiple of 16 (BQ/16 x F/16 accumulator floats a thread).
template <int E, int F> struct PrefillTile;
template <> struct PrefillTile<64, 64> { static constexpr int BQ = 64, BK = 64; };
template <> struct PrefillTile<128, 128> { static constexpr int BQ = 64, BK = 64; };
template <> struct PrefillTile<192, 128> { static constexpr int BQ = 64, BK = 64; };
template <> struct PrefillTile<576, 512> { static constexpr int BQ = 32, BK = 32; };

template <int E, int F>
__host__ __device__ constexpr int prefill_smem_bytes() {
  constexpr int BQ = PrefillTile<E, F>::BQ, BK = PrefillTile<E, F>::BK;
  return 4 * (BQ * (E + 1) + BK * (E + 1) + BK * F + BQ * (BK + 1));
}

template <typename T, int E, int F, bool MACCS>
__global__ void __launch_bounds__(NT)
fusemax_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int pg,
                       int m, float scale, int causal, int window,
                       float softcap, int q_offset, int group, int m_valid) {
  constexpr int BQ = PrefillTile<E, F>::BQ;
  constexpr int BK = PrefillTile<E, F>::BK;
  constexpr int RI = BQ / 16;  // query rows per thread
  constexpr int KJ = BK / 16;  // keys per thread
  constexpr int ES = E + 1;    // padded row stride of the Q and K tiles
  constexpr int PS = BK + 1;   // padded row stride of the probability tile
  constexpr int FC = F / 16;   // accumulator columns per thread
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && F % 16 == 0,
                "16 x 16 threads tile rows, keys and features");
  static_assert(prefill_smem_bytes<E, F>() <= 232448,
                "the tiles exceed one block's shared memory");
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][ES]
  float* ks = qs + BQ * ES;   // [BK][ES]
  float* vs = ks + BK * ES;   // [BK][F]
  float* ps = vs + BK * F;    // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid % 16;    // key / feature columns tx + 16 j
  const int ty = tid / 16;    // query rows ty + 16 i
  const int r0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int rows = min(BQ, pg - r0);
  const T* qb = q + (static_cast<size_t>(bh) * pg + r0) * E;
  const T* kb = k + static_cast<size_t>(bh) * m * E;
  const T* vb = v + static_cast<size_t>(bh) * m * F;

  for (int i = tid; i < BQ * E; i += NT) {
    const int r = i / E, c = i % E;
    qs[r * ES + c] = r < rows ? to_f(qb[static_cast<size_t>(r) * E + c])
                              : 0.f;
  }

  // Key tiles this query tile runs: the TPU kernel's block-level skip
  // (k_lo < m_valid, causal k_lo <= q_hi, window k_hi > q_lo - window)
  // as loop bounds.
  const int q_lo = r0 / group + q_offset;
  const int q_hi = (r0 + rows - 1) / group + q_offset;
  const int kstart = window > 0 ? max(0, q_lo - window + 1) : 0;
  int kend = m_valid;
  if (causal) kend = min(kend, q_hi + 1);
  const int t_begin = kstart / BK;
  const int t_end = kend > 0 ? (kend + BK - 1) / BK : 0;

  int qpos[RI];
  float m_i[RI], l_i[RI], acc[RI][FC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    qpos[i] = (r0 + ty + 16 * i) / group + q_offset;
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < FC; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile's readers are done
    if constexpr (E == F) {
      for (int i = tid; i < BK * E; i += NT) {
        const int r = i / E, c = i % E;
        const int kr = k0 + r;
        const bool in = kr < m;
        ks[r * ES + c] = in ? to_f(kb[static_cast<size_t>(kr) * E + c])
                            : 0.f;
        vs[r * F + c] = in ? to_f(vb[static_cast<size_t>(kr) * F + c]) : 0.f;
      }
    } else {
      for (int i = tid; i < BK * E; i += NT) {
        const int r = i / E, c = i % E;
        const int kr = k0 + r;
        ks[r * ES + c] = kr < m ? to_f(kb[static_cast<size_t>(kr) * E + c])
                                : 0.f;
      }
      for (int i = tid; i < BK * F; i += NT) {
        const int r = i / F, c = i % F;
        const int kr = k0 + r;
        vs[r * F + c] = kr < m ? to_f(vb[static_cast<size_t>(kr) * F + c])
                               : 0.f;
      }
    }
    __syncthreads();

    // BQK (Eq. 42)
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < E; ++e) {
      float qv[RI], kv[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * ES + e];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = ks[(tx + 16 * j) * ES + e];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // masks, LM/RM (Eqs. 43-44), SLN/SLD (Eqs. 45-46), PRM/RD (48-50)
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float lm = NEG_INF;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < m_valid;
        if (causal) ok = ok && kpos <= qpos[i];
        if (window > 0) ok = ok && kpos > qpos[i] - window;
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        lm = fmaxf(lm, x);
      }
      // the 16 threads of a row group are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        lm = fmaxf(lm, __shfl_xor_sync(0xffffffffu, lm, off));
      const float m_new = fmaxf(m_i[i], lm);
      float sld = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = fexp<MACCS>(s[i][j] - m_new);
        s[i][j] = p;
        sld += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sld += __shfl_xor_sync(0xffffffffu, sld, off);
      const float prm = fexp<MACCS>(m_i[i] - m_new);
      l_i[i] = l_i[i] * prm + sld;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < FC; ++j) acc[i][j] *= prm;
#pragma unroll
      for (int j = 0; j < KJ; ++j) ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // SLNV / RNV (Eqs. 47, 51-52)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        const float vv = vs[kk * F + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // AV (Eq. 53): deferred division; rows no tile reached emit 0
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty + 16 * i;
    if (row >= rows) continue;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
    T* orow = o + (static_cast<size_t>(bh) * pg + r0 + row) * F;
#pragma unroll
    for (int j = 0; j < FC; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int E, int F, bool MACCS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int pg, int m, float scale, int causal, int window,
                   float softcap, int q_offset, int group, int m_valid,
                   cudaStream_t stream) {
  constexpr int BQ = PrefillTile<E, F>::BQ;
  constexpr int smem = prefill_smem_bytes<E, F>();
  auto kern = fusemax_prefill_kernel<T, E, F, MACCS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((pg + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), pg, m, scale, causal,
      window, softcap, q_offset, group, m_valid);
  return cudaGetLastError();
}

template <typename T, int E, int F>
cudaError_t launch_exp(int maccs, const void* q, const void* k, const void* v,
                       void* o, int bh, int pg, int m, float scale,
                       int causal, int window, float softcap, int q_offset,
                       int group, int m_valid, cudaStream_t stream) {
  return maccs ? launch<T, E, F, true>(q, k, v, o, bh, pg, m, scale, causal,
                                       window, softcap, q_offset, group,
                                       m_valid, stream)
               : launch<T, E, F, false>(q, k, v, o, bh, pg, m, scale, causal,
                                        window, softcap, q_offset, group,
                                        m_valid, stream);
}

template <typename T>
cudaError_t dispatch_dims(int e, int f, int maccs, const void* q,
                          const void* k, const void* v, void* o, int bh,
                          int pg, int m, float scale, int causal, int window,
                          float softcap, int q_offset, int group, int m_valid,
                          cudaStream_t st) {
#define REPRO_DIMS(E, F)                                                      \
  if (e == E && f == F)                                                       \
    return launch_exp<T, E, F>(maccs, q, k, v, o, bh, pg, m, scale, causal,   \
                               window, softcap, q_offset, group, m_valid, st);
  REPRO_DIMS(128, 128)
  REPRO_DIMS(64, 64)
  REPRO_DIMS(192, 128)
  REPRO_DIMS(576, 512)
#undef REPRO_DIMS
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (e, f): q/k head dim and v head dim,
// one of (64, 64), (128, 128), (192, 128), (576, 512).
// window <= 0 means no window; softcap <= 0 means no softcap.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fusemax_prefill(const void* q, const void* k, const void* v,
                               void* o, int dtype, int e, int f, int bh,
                               int pg, int m, float scale, int causal,
                               int window, float softcap, int q_offset,
                               int group, int m_valid, int exp_maccs,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_dims<float>(
        e, f, exp_maccs, q, k, v, o, bh, pg, m, scale, causal, window,
        softcap, q_offset, group, m_valid, st));
  if (dtype == 1)
    return static_cast<int>(dispatch_dims<__nv_bfloat16>(
        e, f, exp_maccs, q, k, v, o, bh, pg, m, scale, causal, window,
        softcap, q_offset, group, m_valid, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The (BQ, BK) tile of the (e, f) instantiation; returns
// cudaErrorInvalidValue (outputs untouched) for a pair not compiled.
extern "C" int fusemax_prefill_tile(int e, int f, int* block_q,
                                    int* block_k) {
#define REPRO_TILE(E, F)                                                      \
  if (e == E && f == F) {                                                     \
    *block_q = PrefillTile<E, F>::BQ;                                         \
    *block_k = PrefillTile<E, F>::BK;                                         \
    return 0;                                                                 \
  }
  REPRO_TILE(128, 128)
  REPRO_TILE(64, 64)
  REPRO_TILE(192, 128)
  REPRO_TILE(576, 512)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}
