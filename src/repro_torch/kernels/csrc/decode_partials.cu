// FuseMax split-K decode partials for Hopper.
//
// Replaces: src/repro/kernels/decode.py:_decode_partials_kernel, launched
// by fusemax_decode_pallas (the TPU kernel behind ops.fusemax_decode).
// The combine of the partials (decode.py:_combine_partials) stays plain
// torch ops, as the reference keeps it in jnp outside the pallas_call.
//
// What it computes: for every batch*kv-head fiber and every split of the
// dense cache, the running (m, l, acc) of Cascade 5 over the key tiles of
// that split which the TPU kernel runs — tiles with k_lo < kv_len + P - 1
// and, with a window, k_hi > kv_len - 1 - window — for all folded query
// rows of the fiber at once.  Row r is draft position r / rows_per_pos
// and attends keys < kv_len + position (P = 1: keys < kv_len).  A split
// in which no tile runs emits (NEG_INF, 0, 0), so a slot with kv_len = 0
// decodes to exactly 0 after the combine, as on the TPU.
//
// What bounds it on this card: bytes.  One query row per kv head meets
// each cached key once, so the kernel does ~2 * rows * D multiply-adds
// per key against 2 * D * sizeof(T) bytes of K and V — far below the
// H100's ~20 FLOP per byte fp32 balance point.  The least time is the
// K/V bytes of the valid prefix over 3.35 TB/s.
//
// What the simple design does about it: one block per (split, fiber)
// reads kv_len itself and streams only the tiles that run, 32 keys at a
// time, through shared memory with coalesced row loads; every key is read
// from device memory exactly once and no query row is padded.  The
// partials are written without the TPU's 128-lane padding.  Scores,
// softmax and the accumulator update are true fp32 FMA.  Overlapping the
// next chunk's loads with this chunk's arithmetic (cp.async / TMA) is
// left for a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 128;       // threads per block (4 warps)
constexpr int CK = 32;        // keys per shared-memory chunk
constexpr int MAXR = 64;      // most folded query rows per fiber
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

__host__ __device__ constexpr int smem_floats(int rows, int d) {
  // q [rows][d], K chunk [CK][d+1], V chunk [CK][d], scores [rows][CK+1],
  // acc [rows][d], m / l / correction [rows]
  return rows * d + CK * (d + 1) + CK * d + rows * (CK + 1) + rows * d +
         3 * rows;
}

template <typename T, int D, bool MACCS>
__global__ void __launch_bounds__(NT)
decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ kv_len,
                       float* __restrict__ pm, float* __restrict__ pl,
                       float* __restrict__ pnv, int hkv, int R, int m,
                       int splits, int split_len, int block_k, int n_pos,
                       int rows_per_pos, float scale, int window,
                       float softcap) {
  constexpr int DS = D + 1;
  constexpr int SS = CK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                 // [R][D]
  float* ks = qs + R * D;           // [CK][DS]
  float* vs = ks + CK * DS;         // [CK][D]
  float* ss = vs + CK * D;          // [R][SS]
  float* acc = ss + R * SS;         // [R][D]
  float* ms = acc + R * D;          // [R]
  float* ls = ms + R;               // [R]
  float* cf = ls + R;               // [R]

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int kvl = kv_len[bh / hkv];
  const int q_pos = kvl - 1;        // the query is the newest token

  // tiles of this split the TPU kernel runs (its per-tile skip)
  const int split0 = split * split_len;
  const int n_tiles = split_len / block_k;
  const int lim = kvl + n_pos - 1 - split0;
  const int t1 = lim <= 0 ? 0 : min(n_tiles, (lim + block_k - 1) / block_k);
  int t0 = 0;
  if (window > 0) {
    const int need = q_pos - window + 1 - split0;
    t0 = need <= 0 ? 0 : need / block_k;
  }
  const int kbeg = split0 + t0 * block_k;
  const int kfin = split0 + max(t0, t1) * block_k;

  const T* qb = q + static_cast<size_t>(bh) * R * D;
  const T* kb = k + static_cast<size_t>(bh) * m * D;
  const T* vb = v + static_cast<size_t>(bh) * m * D;
  for (int i = tid; i < R * D; i += NT) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += NT) {
    ms[r] = NEG_INF;
    ls[r] = 0.f;
  }

  for (int c0 = kbeg; c0 < kfin; c0 += CK) {
    const int nk = min(CK, kfin - c0);
    __syncthreads();  // previous chunk's readers are done
    for (int i = tid; i < nk * D; i += NT) {
      const int r = i / D, c = i % D;
      const size_t g = static_cast<size_t>(c0 + r) * D + c;
      ks[r * DS + c] = to_f(kb[g]);
      vs[r * D + c] = to_f(vb[g]);
    }
    __syncthreads();

    // scores, scale, softcap, masks
    for (int i = tid; i < R * CK; i += NT) {
      const int r = i / CK, c = i % CK;
      if (c >= nk) continue;
      float dot = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) dot = fmaf(qs[r * D + e], ks[c * DS + e], dot);
      float x = dot * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int kpos = c0 + c;
      bool ok = n_pos == 1 ? kpos < kvl : kpos < kvl + r / rows_per_pos;
      if (window > 0) ok = ok && kpos > q_pos - window;
      ss[r * SS + c] = ok ? x : NEG_INF;
    }
    __syncthreads();

    // running max, exp, denominator: one warp per row
    for (int r = warp; r < R; r += NT / 32) {
      float lm = NEG_INF;
      for (int c = lane; c < nk; c += 32) lm = fmaxf(lm, ss[r * SS + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lm = fmaxf(lm, __shfl_xor_sync(0xffffffffu, lm, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, lm);
      float sum = 0.f;
      for (int c = lane; c < nk; c += 32) {
        const float p = fexp<MACCS>(ss[r * SS + c] - m_new);
        ss[r * SS + c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float f = fexp<MACCS>(m_prev - m_new);
        cf[r] = f;
        ls[r] = ls[r] * f + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // accumulator: acc = acc * correction + p . V
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, f = i % D;
      float a = acc[i] * cf[r];
      for (int c = 0; c < nk; ++c) a = fmaf(ss[r * SS + c], vs[c * D + f], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  const size_t base = (static_cast<size_t>(bh) * splits + split) * R;
  for (int r = tid; r < R; r += NT) {
    pm[base + r] = ms[r];
    pl[base + r] = ls[r];
  }
  for (int i = tid; i < R * D; i += NT) pnv[base * D + i] = acc[i];
}

template <typename T, int D, bool MACCS>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* pm, void* pl, void* pnv, int bh,
                   int hkv, int R, int m, int splits, int split_len,
                   int block_k, int n_pos, int rows_per_pos, float scale,
                   int window, float softcap, cudaStream_t stream) {
  const int smem = 4 * smem_floats(R, D);
  auto kern = decode_partials_kernel<T, D, MACCS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      4 * smem_floats(MAXR, D));
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, bh);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<float*>(pnv), hkv, R, m, splits, split_len, block_k, n_pos,
      rows_per_pos, scale, window, softcap);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_exp(int maccs, const void* q, const void* k, const void* v,
                       const void* kv_len, void* pm, void* pl, void* pnv,
                       int bh, int hkv, int R, int m, int splits,
                       int split_len, int block_k, int n_pos,
                       int rows_per_pos, float scale, int window,
                       float softcap, cudaStream_t stream) {
  return maccs ? launch<T, D, true>(q, k, v, kv_len, pm, pl, pnv, bh, hkv, R,
                                    m, splits, split_len, block_k, n_pos,
                                    rows_per_pos, scale, window, softcap,
                                    stream)
               : launch<T, D, false>(q, k, v, kv_len, pm, pl, pnv, bh, hkv, R,
                                     m, splits, split_len, block_k, n_pos,
                                     rows_per_pos, scale, window, softcap,
                                     stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128 (E == F).
// rows: folded query rows per fiber, 1..64.  window <= 0: no window;
// softcap <= 0: no softcap.  Returns cudaGetLastError() after the launch.
extern "C" int decode_partials(const void* q, const void* k, const void* v,
                               const void* kv_len, void* pm, void* pl,
                               void* pnv, int dtype, int head_dim, int bh,
                               int hkv, int rows, int m, int splits,
                               int split_len, int block_k, int n_pos,
                               int rows_per_pos, float scale, int window,
                               float softcap, int exp_maccs, void* stream) {
  if (rows < 1 || rows > MAXR) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 128)
    return launch_exp<float, 128>(exp_maccs, q, k, v, kv_len, pm, pl, pnv,
                                  bh, hkv, rows, m, splits, split_len,
                                  block_k, n_pos, rows_per_pos, scale, window,
                                  softcap, st);
  if (dtype == 0 && head_dim == 64)
    return launch_exp<float, 64>(exp_maccs, q, k, v, kv_len, pm, pl, pnv, bh,
                                 hkv, rows, m, splits, split_len, block_k,
                                 n_pos, rows_per_pos, scale, window, softcap,
                                 st);
  if (dtype == 1 && head_dim == 128)
    return launch_exp<__nv_bfloat16, 128>(exp_maccs, q, k, v, kv_len, pm, pl,
                                          pnv, bh, hkv, rows, m, splits,
                                          split_len, block_k, n_pos,
                                          rows_per_pos, scale, window,
                                          softcap, st);
  if (dtype == 1 && head_dim == 64)
    return launch_exp<__nv_bfloat16, 64>(exp_maccs, q, k, v, kv_len, pm, pl,
                                         pnv, bh, hkv, rows, m, splits,
                                         split_len, block_k, n_pos,
                                         rows_per_pos, scale, window, softcap,
                                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int decode_partials_max_rows() { return MAXR; }
