// Split-K decode partials body shared by the dense (K2,
// decode_partials.cu) and paged (K3, paged_decode_partials.cu) kernels.
//
// One block per (split, batch*kv-head fiber) computes the running
// (m, l, acc) of Cascade 5 over the key tiles of its split that the TPU
// kernels run — tiles with k_lo < kv_len + P - 1 and, with a window,
// k_hi > kv_len - 1 - window — for all folded query rows of the fiber at
// once.  Row r is draft position r / rows_per_pos and attends keys
// < kv_len + position (P = 1: keys < kv_len).  A split in which no tile
// runs emits (NEG_INF, 0, 0), so a slot with kv_len = 0 decodes to
// exactly 0 after the combine, as on the TPU.
//
// The two layouts differ only in where key row `kpos` of a fiber lives,
// which a KV policy answers (DenseKV: row kpos of the fiber's [M, D]
// slab; PagedKV: offset kpos % ps of page block_table[b][kpos / ps],
// sentinel clamped to the last page, Hkv * D elements per token).  The
// chunk walk, the masks and the fp32 FMA order are one template, so on a
// pool whose pages hold a dense cache's rows the two kernels at the same
// splits give the same bits: block_k only decides how far a split walks
// past kv_len, and keys past kv_len add exact zeros to a row that has
// seen a valid key.
//
// What bounds it on this card: bytes.  One query row per kv head meets
// each cached key once, so the kernel does ~2 * rows * D multiply-adds
// per key against 2 * D * sizeof(T) bytes of K and V — far below the
// H100's ~20 FLOP per byte fp32 balance point.  The least time is the
// K/V bytes of the valid prefix over 3.35 TB/s.
//
// What the simple design does about it: each block reads kv_len itself
// and streams only the tiles that run, 32 keys at a time, through shared
// memory with coalesced row loads (a key row is D contiguous elements in
// both layouts; the paged layout resolves the chunk's 32 rows once, one
// per lane, and broadcasts them with a warp shuffle); every key is read
// from device memory exactly once and no query row is padded.  The partials are written without the TPU's
// 128-lane padding.  Scores, softmax and the accumulator update are true
// fp32 FMA.  Overlapping the next chunk's loads with this chunk's
// arithmetic (cp.async / TMA) is left for a later change.

#pragma once

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

// Scalar arguments of one launch.
struct DecodeArgs {
  int hkv, R, splits, split_len, block_k, n_pos, rows_per_pos;
  float scale;
  int window;       // <= 0: no window
  float softcap;    // <= 0: no softcap
};

// Where K and V live, as the C entry points receive it; each KV policy
// below takes what it needs.
struct KVSource {
  const void* k;
  const void* v;
  const int* block_table;   // paged only
  int m;                    // dense: cache slots per fiber
  int w, ps, n_pages, hkv;  // paged: table width, page size, pool pages
};

// Dense cache [B*Hkv, M, D]: key row kpos of fiber bh.
template <typename T, int D>
struct DenseKV {
  static constexpr bool kIndirect = false;  // row() is plain arithmetic
  const T* k;
  const T* v;
  int m;
  static DenseKV from(const KVSource& s) {
    return {static_cast<const T*>(s.k), static_cast<const T*>(s.v), s.m};
  }
  __device__ __forceinline__ size_t row(int bh, int kpos) const {
    return (static_cast<size_t>(bh) * m + kpos) * D;
  }
};

// Page pool [n_pages, ps, Hkv, D] behind a block table [B, W]: the page is
// resolved per key (a 32-key chunk may straddle pages), the sentinel id
// n_pages clamped to the last page (such keys lie past kv_len, masked).
template <typename T, int D>
struct PagedKV {
  // row() divides by the page size and loads a table entry: each key's
  // row is resolved once per chunk (by one lane) and broadcast, not once
  // per loaded element
  static constexpr bool kIndirect = true;
  const T* k;
  const T* v;
  const int* block_table;
  int w, ps, n_pages, hkv;
  static PagedKV from(const KVSource& s) {
    return {static_cast<const T*>(s.k), static_cast<const T*>(s.v),
            s.block_table, s.w, s.ps, s.n_pages, s.hkv};
  }
  __device__ __forceinline__ size_t row(int bh, int kpos) const {
    const int b = bh / hkv;
    const int h = bh - b * hkv;
    const int page = min(block_table[b * w + kpos / ps], n_pages - 1);
    return ((static_cast<size_t>(page) * ps + kpos % ps) * hkv + h) * D;
  }
};

template <typename T, int D, bool MACCS, class KV>
__global__ void __launch_bounds__(NT)
decode_partials_kernel(const T* __restrict__ q, const KV kv,
                       const int* __restrict__ kv_len,
                       float* __restrict__ pm, float* __restrict__ pl,
                       float* __restrict__ pnv, const DecodeArgs a) {
  constexpr int DS = D + 1;
  constexpr int SS = CK + 1;
  const int R = a.R;
  extern __shared__ float smem[];
  float* qs = smem;                 // [R][D]
  float* ks = qs + R * D;           // [CK][DS]
  float* vs = ks + CK * DS;         // [CK][D]
  float* ss = vs + CK * D;          // [R][SS]
  float* acc = ss + R * SS;         // [R][D]
  float* ms = acc + R * D;          // [R]
  float* ls = ms + R;               // [R]
  float* cf = ls + R;               // [R]
  static_assert(CK == 32 && D % 32 == 0,
                "a chunk's key rows are one per lane; a warp's loads share a "
                "row");

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int kvl = kv_len[bh / a.hkv];
  const int q_pos = kvl - 1;        // the query is the newest token

  // tiles of this split the TPU kernel runs (its per-tile skip)
  const int split0 = split * a.split_len;
  const int n_tiles = a.split_len / a.block_k;
  const int lim = kvl + a.n_pos - 1 - split0;
  const int t1 =
      lim <= 0 ? 0 : min(n_tiles, (lim + a.block_k - 1) / a.block_k);
  int t0 = 0;
  if (a.window > 0) {
    const int need = q_pos - a.window + 1 - split0;
    t0 = need <= 0 ? 0 : need / a.block_k;
  }
  const int kbeg = split0 + t0 * a.block_k;
  const int kfin = split0 + max(t0, t1) * a.block_k;

  const T* qb = q + static_cast<size_t>(bh) * R * D;
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
    // indirect layouts: lane l of every warp resolves key row c0 + l
    unsigned long long lane_row = 0;
    if constexpr (KV::kIndirect) {
      if (lane < nk) lane_row = kv.row(bh, c0 + lane);
    }
    __syncthreads();  // previous chunk's readers are done
    for (int i = tid; i < nk * D; i += NT) {
      const int r = i / D, c = i % D;
      size_t row;
      if constexpr (KV::kIndirect) {
        // r is the same on every lane of a warp (D % 32 == 0), and so is
        // the trip count of this loop: the whole warp shuffles
        row = __shfl_sync(0xffffffffu, lane_row, r);
      } else {
        row = kv.row(bh, c0 + r);
      }
      const size_t g = row + c;
      ks[r * DS + c] = to_f(__ldg(kv.k + g));
      vs[r * D + c] = to_f(__ldg(kv.v + g));
    }
    __syncthreads();

    // scores, scale, softcap, masks
    for (int i = tid; i < R * CK; i += NT) {
      const int r = i / CK, c = i % CK;
      if (c >= nk) continue;
      float dot = 0.f;
#pragma unroll 8
      for (int e = 0; e < D; ++e) dot = fmaf(qs[r * D + e], ks[c * DS + e], dot);
      float x = dot * a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      const int kpos = c0 + c;
      bool ok = a.n_pos == 1 ? kpos < kvl : kpos < kvl + r / a.rows_per_pos;
      if (a.window > 0) ok = ok && kpos > q_pos - a.window;
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
      float a_ = acc[i] * cf[r];
      for (int c = 0; c < nk; ++c) a_ = fmaf(ss[r * SS + c], vs[c * D + f], a_);
      acc[i] = a_;
    }
  }
  __syncthreads();

  const size_t base = (static_cast<size_t>(bh) * a.splits + split) * R;
  for (int r = tid; r < R; r += NT) {
    pm[base + r] = ms[r];
    pl[base + r] = ls[r];
  }
  for (int i = tid; i < R * D; i += NT) pnv[base * D + i] = acc[i];
}

// Launch one instantiation on `stream`; returns cudaGetLastError().
template <typename T, int D, bool MACCS, class KV>
cudaError_t launch_partials(const void* q, const KV& kv, const void* kv_len,
                            void* pm, void* pl, void* pnv, int bh,
                            const DecodeArgs& a, cudaStream_t stream) {
  auto kern = decode_partials_kernel<T, D, MACCS, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      4 * smem_floats(MAXR, D));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.splits, bh);
  kern<<<grid, NT, 4 * smem_floats(a.R, D), stream>>>(
      static_cast<const T*>(q), kv, static_cast<const int*>(kv_len),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<float*>(pnv), a);
  return cudaGetLastError();
}

// Dispatch on (dtype: 0 = float32, 1 = bfloat16) x (head_dim: 64, 128) x
// exp variant, with the K/V layout KVT.
template <template <typename, int> class KVT>
cudaError_t dispatch_partials(int dtype, int head_dim, int maccs,
                              const void* q, const KVSource& src,
                              const void* kv_len, void* pm, void* pl,
                              void* pnv, int bh, const DecodeArgs& a,
                              cudaStream_t st) {
  if (a.R < 1 || a.R > MAXR) return cudaErrorInvalidValue;
#define REPRO_DISPATCH(T, D)                                                  \
  {                                                                           \
    const KVT<T, D> kv = KVT<T, D>::from(src);                                \
    return maccs ? launch_partials<T, D, true>(q, kv, kv_len, pm, pl, pnv,    \
                                               bh, a, st)                     \
                 : launch_partials<T, D, false>(q, kv, kv_len, pm, pl, pnv,   \
                                                bh, a, st);                   \
  }
  if (dtype == 0 && head_dim == 128) REPRO_DISPATCH(float, 128)
  if (dtype == 0 && head_dim == 64) REPRO_DISPATCH(float, 64)
  if (dtype == 1 && head_dim == 128) REPRO_DISPATCH(__nv_bfloat16, 128)
  if (dtype == 1 && head_dim == 64) REPRO_DISPATCH(__nv_bfloat16, 64)
#undef REPRO_DISPATCH
  return cudaErrorInvalidValue;
}

}  // namespace
