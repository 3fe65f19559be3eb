// Split-K MLA decode partials in latent space: the body shared by the
// paged latent kernel (K4, mla_paged_decode_partials.cu) and the dense
// one (K2's E != F branch, latent_decode_partials.cu).
//
// What it computes: DeepSeek's absorbed-form decode with Hkv = 1 and
// every query head in one group.  q [B, R, r + rd] holds R = n_pos * G
// folded query rows (row = position * G + head; the first r features are
// the W_uk-absorbed query, the last rd the rope query) against a latent
// history ckv [r] and krope [rd] per token.  Per key the score is
// q[:r] . ckv + q[r:] . krope, and the latent row ckv is also the value,
// so the accumulator is [R, r] (the caller applies W_uv).  Each split of
// split_len tokens sweeps the block_k-key tiles the TPU kernels run
// (k_lo < kv_len + n_pos - 1, as loop bounds), with the running (m, l,
// acc) of Cascade 5 and the finite NEG_INF = -1e30; a key is valid for
// row r if kpos < kv_len + r / rows_per_pos (n_pos verify positions;
// n_pos = 1: kpos < kv_len).  A split in which no tile runs emits
// (NEG_INF, 0, 0), so a slot with kv_len = 0 decodes to exactly 0 after
// the combine, as on the TPU.
//
// The two layouts differ only in where token kpos of sequence b lives,
// which a latent-source policy answers: PagedLatent looks its page up in
// the block table per key (a chunk may straddle pages; the sentinel id
// clamped to the last page, whose keys lie past kv_len and are masked),
// DenseLatent takes row b * M + kpos of a contiguous [B, M, r] / [B, M,
// rd] pair.  The walk, the masks and the FMA order are one template, so
// on a pool whose pages hold the dense rows the two kernels at the same
// splits give the same bits: block_k only decides how far a split walks
// past kv_len, and a chunk of masked keys after a valid one adds exact
// zeros (p = 0, a rescale by exp(0) = 1).
//
// What bounds it on this card: operations, unlike K2/K3.  All G = 128
// heads of DeepSeek-V3 share each latent row, so every key costs
// G * (r + rd + r) = 128 * 1088 multiply-adds against (r + rd) * 4 bytes:
// ~70 FLOP per byte in fp32, above the H100's ~20 FLOP/byte balance.
// The least time is 2 * G * sum(kv_len) * (2r + rd) FLOP at 67 TFLOP/s.
//
// What the design does about it: the 128 query rows do not fit one block
// (128 x 576 fp32 = 295 KB), so the grid is (split, batch, head block)
// with 32 rows per block, 4 per warp.  Each warp keeps its 4 query rows
// in registers, each lane holding every 32nd feature (72 floats; where
// the rope width is below 32, as the smoke latent's 16, the lanes past it
// hold no rope feature and add zeros), and its 4 x 512 accumulator
// likewise (64 floats a lane: lane l owns features l,
// l + 32, ...), so only the latent chunk lives in shared memory: 16 keys
// of [ckv | krope] in the stored dtype, double-buffered (2 x 37 KB fp32)
// and filled by 16-byte cp.async copies (16 threads per key, one address
// computation each) while the previous chunk is computed; every warp of
// the block reads it, each shared-memory read feeding 4 FMAs.  Scores go
// 4 keys at a time: a warp's 16 (row, key) dot products are summed across
// the lanes by a transposed butterfly (16 shuffles, after which lane l
// holds row l >> 3, key (l >> 1) & 3), so the running max and denominator
// are 2-step shuffles over the lanes of a row, and the value pass
// broadcasts each probability from its lane.  Each latent tile is read
// once per head block (4 at G = 128), mostly from L2.  True fp32 FMA
// throughout; bf16 widened on the shared-memory read.  Tensor cores
// (wgmma on the [32 x 576] x [576 x 16] score tile and the [32 x 16] x
// [16 x 512] value tile) and TMA are left for a later change.
//
// Quantized pools (paged only; the reference's dense layout has none):
// the codes ride the same chunk loader, 16 codes a 16-byte copy (a (512,
// 64) key is 576 bytes, the smoke (32, 16) one 48; both halves stay
// multiples of 16, so no vector straddles them), and the two per-token
// scales of each key are plain loads by the key's first copy thread — per
// key and page, as a chunk may straddle pages — into a per-buffer slot
// the chunk's barrier publishes.  Every warp reads every feature of a
// chunk, so the block dequantizes each chunk once, after it lands: each
// thread turns 4-code words into float(code) * float(scale) (exact in
// fp32) in an fp32 tile, and the score and value passes read that tile as
// they read an fp32 pool's chunk, in the unchanged FMA order: a quantized
// launch gives the bits of an unquantized one on the dequantized pool.
// The bound stays operations (the FMAs do not change); the bytes fall to
// a quarter.

#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>

namespace {

constexpr int NT = 256;        // threads per block (8 warps)
constexpr int RW = 4;          // query rows per warp
constexpr int HB = RW * (NT / 32);  // query rows per block (head block)
constexpr int CK = 16;         // keys per shared-memory chunk
constexpr int KG = 4;          // keys per score group (4 rows x 4 keys)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  const __nv_fp8_storage_t bits =
      *reinterpret_cast<const __nv_fp8_storage_t*>(&x);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(bits, __NV_E4M3)));
}
// The code whose byte is b.
template <typename S>
__device__ __forceinline__ S code_of(unsigned b) {
  const unsigned char byte = static_cast<unsigned char>(b);
  S s;
  memcpy(&s, &byte, 1);
  return s;
}

// exp(x) for x <= 0 with 6 multiply-adds (fusemax.py:_EXP2_COEFFS).
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

// Scalar arguments of one launch.
struct MlaArgs {
  int rows;                 // folded query rows R = n_pos * G
  int n_pages, ps, w;       // paged: pool pages, page size, table width
  int splits, split_len, block_k;
  int n_pos, rows_per_pos;
  float scale;
  float softcap;            // <= 0: no softcap
};

// Latent page pools [n_pages, ps, r] / [n_pages, ps, rd] behind a block
// table [B, w] (K4): token kpos of sequence b sits at offset kpos % ps of
// page table[b, kpos / ps], the sentinel id n_pages clamped to the last
// page.
struct PagedLatent {
  const int* block_table;
  __device__ __forceinline__ long long token(const MlaArgs& a, int b,
                                             int kpos) const {
    const int page = min(
        __ldg(block_table + static_cast<size_t>(b) * a.w + kpos / a.ps),
        a.n_pages - 1);
    return static_cast<long long>(page) * a.ps + kpos % a.ps;
  }
};

// A dense latent cache [B, M, r] / [B, M, rd] (K2's E != F branch): token
// kpos of sequence b is row b * M + kpos.
struct DenseLatent {
  int m;
  __device__ __forceinline__ long long token(const MlaArgs&, int b,
                                             int kpos) const {
    return static_cast<long long>(b) * m + kpos;
  }
};

// 16-byte asynchronous copy global -> shared (sm_80+), bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Sum 16 per-lane values v[0..15] across the warp in 16 shuffles (a
// transposed butterfly: each step sends half of the live values and keeps
// the other half).  Lane l returns the warp-wide sum of v[(l >> 1) & 15].
__device__ __forceinline__ float reduce16(const float (&v)[16], int lane) {
  constexpr unsigned FULL = 0xffffffffu;
  float w8[8], w4[4], w2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w8[i] = (b4 ? v[i + 8] : v[i]) +
            __shfl_xor_sync(FULL, b4 ? v[i] : v[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w4[i] = (b3 ? w8[i + 4] : w8[i]) +
            __shfl_xor_sync(FULL, b3 ? w8[i] : w8[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    w2[i] = (b2 ? w4[i + 2] : w4[i]) +
            __shfl_xor_sync(FULL, b2 ? w4[i] : w4[i + 2], 4);
  const float w1 = (b1 ? w2[1] : w2[0]) +
                   __shfl_xor_sync(FULL, b1 ? w2[0] : w2[1], 2);
  return w1 + __shfl_xor_sync(FULL, w1, 1);
}

// Issue the asynchronous copy of chunk [c0, c0 + nk) of [ckv | krope] rows
// of element type S into the shared buffer kt [CK][E]: 16 threads per key,
// one token lookup each (the policy Src), 16-byte copies (a vector never
// straddles ckv and krope).  For code pools (SCALED) the key's first
// thread also loads its two fp16 scales into sc [CK][2] (latent, rope) as
// fp32.
template <typename S, int RL, int RR, bool SCALED, class Src>
__device__ __forceinline__ void issue_chunk(
    S* kt, float* sc, const S* __restrict__ ckv, const S* __restrict__ krope,
    const __half* __restrict__ ckv_scale,
    const __half* __restrict__ krope_scale, const Src& src, int b, int c0,
    int nk, const MlaArgs& a) {
  constexpr int E = RL + RR;
  constexpr int VEC = 16 / sizeof(S);
  const int c = threadIdx.x >> 4;
  if (c >= nk) return;
  const long long tok = src.token(a, b, c0 + c);
  const S* src_c = ckv + tok * RL;
  const S* src_r = krope + tok * RR;
  for (int v = threadIdx.x & 15; v < E / VEC; v += 16) {
    const int e = v * VEC;
    cp_async16(kt + c * E + e, e < RL ? src_c + e : src_r + (e - RL));
  }
  if constexpr (SCALED) {
    if ((threadIdx.x & 15) == 0) {
      sc[2 * c] = __half2float(ckv_scale[tok]);
      sc[2 * c + 1] = __half2float(krope_scale[tok]);
    }
  }
}

// Shared memory of one block (autotune.mla_decode_smem_bytes is its twin):
// two chunks of CK [ckv | krope] rows of the stored element, then, for
// code pools, two chunks of CK (latent, rope) fp32 scales and one
// dequantized fp32 chunk.
__host__ __device__ constexpr int mla_smem_bytes(int rank, int rope,
                                                 int elem_bytes, bool scaled) {
  return 2 * CK * (rank + rope) * elem_bytes +
         (scaled ? 2 * CK * 2 * 4 + CK * (rank + rope) * 4 : 0);
}

// Dequantize the first nk keys of a landed code chunk kb [CK][E] with its
// scales sc [CK][2] (latent, rope) into the fp32 tile out [CK][E]: each
// thread takes 4-code words (a word never straddles a key or the
// latent/rope boundary: E, RL and RR are multiples of 16).
template <typename S, int RL, int RR>
__device__ __forceinline__ void dequant_chunk(float* out, const S* kb,
                                              const float* sc, int nk) {
  constexpr int E = RL + RR;
  static_assert(sizeof(S) == 1 && E % 4 == 0 && RL % 4 == 0, "4-code words");
  const unsigned* words = reinterpret_cast<const unsigned*>(kb);
  for (int w = threadIdx.x; w < nk * E / 4; w += NT) {
    const int c = 4 * w / E, e = 4 * w - c * E;
    const float s = sc[2 * c + (e < RL ? 0 : 1)];
    const unsigned x = words[w];
    float4 f;
    f.x = to_f(code_of<S>(x & 0xffu)) * s;
    f.y = to_f(code_of<S>((x >> 8) & 0xffu)) * s;
    f.z = to_f(code_of<S>((x >> 16) & 0xffu)) * s;
    f.w = to_f(code_of<S>(x >> 24)) * s;
    *reinterpret_cast<float4*>(out + 4 * w) = f;
  }
}

// The block's work: T is the queries' element, S the stored one (T, or
// an int8 / fp8 e4m3 code, whose per-token fp16 scales sit in ckv_scale
// / krope_scale), Src the latent-source policy.  Each kernel is a
// __global__ of its own that calls this with its policy, so the two keep
// their own names in the profiler and the ptxas report.
template <typename T, typename S, int RL, int RR, bool MACCS, class Src>
__device__ __forceinline__ void mla_partials_body(
    const T* __restrict__ q, const S* __restrict__ ckv,
    const S* __restrict__ krope, const __half* __restrict__ ckv_scale,
    const __half* __restrict__ krope_scale, const Src& src,
    const int* __restrict__ kv_len, float* __restrict__ pm,
    float* __restrict__ pl, float* __restrict__ pnv, const MlaArgs& a) {
  constexpr int E = RL + RR;    // score features: latent + rope
  constexpr int FC = RL / 32;   // accumulator features per lane and row
  constexpr int RC = (RR + 31) / 32;  // rope features per lane and row
  constexpr int EC = FC + RC;   // query features per lane and row
  constexpr int NG = CK / KG;   // key groups per chunk
  constexpr bool SCALED = !std::is_same<T, S>::value;
  static_assert(RL % 32 == 0, "lanes stride the latent features by 32");
  static_assert(RW * KG == 16, "reduce16 sums one (row, key) pair a lane");
  static_assert(RL % (16 / sizeof(S)) == 0 && RR % (16 / sizeof(S)) == 0,
                "16-byte copies tile the latent and rope rows");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* kt = reinterpret_cast<S*>(smem_raw);   // [2][CK][E] [ckv | krope] rows
  // code pools: [2][CK][2] fp32 (latent, rope) scales of each chunk's keys,
  // then the chunk being computed, dequantized: [CK][E] fp32
  float* sct = reinterpret_cast<float*>(smem_raw + 2 * CK * E * sizeof(S));
  float* kdq = sct + 2 * CK * 2;
  // what the score and value passes read: the landed chunk, or for code
  // pools its dequantized tile
  using Rd = typename std::conditional<SCALED, float, S>::type;

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.z * HB + warp * RW;
  const int R = a.rows;
  const int kvl = kv_len[b];

  // tiles of this split the TPU kernel runs (its per-tile skip)
  const int split0 = split * a.split_len;
  const int n_tiles = a.split_len / a.block_k;
  const int lim = kvl + a.n_pos - 1 - split0;
  const int t1 =
      lim <= 0 ? 0 : min(n_tiles, (lim + a.block_k - 1) / a.block_k);
  const int kfin = split0 + t1 * a.block_k;
  const int n_chunks = (kfin - split0 + CK - 1) / CK;

  // query feature j of this lane: latent lane + 32 j, then rope lane +
  // 32 (j - FC), which exists only below RR
  auto feat = [&](int j) {
    return j < FC ? lane + 32 * j : RL + lane + 32 * (j - FC);
  };
  auto has = [&](int j) {
    return RR % 32 == 0 || j < FC || lane + 32 * (j - FC) < RR;
  };
  float qr[RW][EC], acc[RW][FC];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = row0 + i;
    const T* qrow = q + (static_cast<size_t>(b) * R + row) * E;
#pragma unroll
    for (int j = 0; j < EC; ++j)
      qr[i][j] = row < R && has(j) ? to_f(qrow[feat(j)]) : 0.f;
#pragma unroll
    for (int j = 0; j < FC; ++j) acc[i][j] = 0.f;
  }
  // after the score reduction lane l holds row (l >> 3) of the warp's 4
  // and key 4 g + ((l >> 1) & 3) of key group g; its row's running state:
  const int my_row = row0 + (lane >> 3);
  const int my_key = (lane >> 1) & 3;
  const int my_lim = a.n_pos == 1 ? kvl : kvl + my_row / a.rows_per_pos;
  float m_i = NEG_INF, l_i = 0.f;

  if (n_chunks > 0)
    issue_chunk<S, RL, RR, SCALED>(kt, sct, ckv, krope, ckv_scale,
                                   krope_scale, src, b, split0,
                                   min(CK, kfin - split0), a);
  cp_async_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = split0 + ch * CK;
    const int nk = min(CK, kfin - c0);
    const S* kc = kt + (ch & 1) * CK * E;
    // the next chunk's copy overlaps this chunk's arithmetic
    if (ch + 1 < n_chunks)
      issue_chunk<S, RL, RR, SCALED>(
          kt + ((ch + 1) & 1) * CK * E, sct + ((ch + 1) & 1) * CK * 2, ckv,
          krope, ckv_scale, krope_scale, src, b, c0 + CK,
          min(CK, kfin - c0 - CK), a);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // this chunk's rows have landed for every thread
    const Rd* kb;
    if constexpr (SCALED) {
      dequant_chunk<S, RL, RR>(kdq, kc, sct + (ch & 1) * CK * 2, nk);
      __syncthreads();  // the dequantized chunk is complete
      kb = kdq;
    } else {
      kb = kc;
    }

    // scores, 4 keys at a time: the lanes split the features, the warp's
    // 4 rows share each key row, and reduce16 sums the 16 (row, key) dot
    // products across the lanes
    float sc[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      sc[g] = 0.f;
      if (g * KG >= nk) continue;           // warp-uniform
      float part[RW * KG];
#pragma unroll
      for (int t = 0; t < RW * KG; ++t) part[t] = 0.f;
#pragma unroll
      for (int j = 0; j < EC; ++j) {
        float kv[KG];
#pragma unroll
        for (int k = 0; k < KG; ++k)
          kv[k] = has(j) ? to_f(kb[(g * KG + k) * E + feat(j)]) : 0.f;
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int k = 0; k < KG; ++k)
            part[i * KG + k] = fmaf(qr[i][j], kv[k], part[i * KG + k]);
      }
      sc[g] = reduce16(part, lane);
    }

    // scale, softcap, masks; the row's running max, exp and denominator
    // over the chunk's 16 keys (lanes differing in bits 1-2 hold them)
    float x[NG], lm = NEG_INF;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      float s = sc[g] * a.scale;
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      const int key = g * KG + my_key;
      x[g] = c0 + key < my_lim ? s : NEG_INF;
      if (key < nk) lm = fmaxf(lm, x[g]);
    }
    lm = fmaxf(lm, __shfl_xor_sync(0xffffffffu, lm, 2));
    lm = fmaxf(lm, __shfl_xor_sync(0xffffffffu, lm, 4));
    const float m_new = fmaxf(m_i, lm);
    float p[NG], sum = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      p[g] = g * KG + my_key < nk ? fexp<MACCS>(x[g] - m_new) : 0.f;
      sum += p[g];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const float prm = fexp<MACCS>(m_i - m_new);
    l_i = l_i * prm + sum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float f = __shfl_sync(0xffffffffu, prm, 8 * i);
#pragma unroll
      for (int j = 0; j < FC; ++j) acc[i][j] *= f;
    }

    // accumulator += p . ckv: the latent tile is the value stream
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const int c = g * KG + k;
        if (c >= nk) break;                 // warp-uniform
        float pc[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i)
          pc[i] = __shfl_sync(0xffffffffu, p[g], 8 * i + 2 * k);
#pragma unroll
        for (int j = 0; j < FC; ++j) {
          const float v = to_f(kb[c * E + lane + 32 * j]);
#pragma unroll
          for (int i = 0; i < RW; ++i) acc[i][j] = fmaf(pc[i], v, acc[i][j]);
        }
      }
    }
    __syncthreads();  // every reader is done before the buffer refills
  }

  const size_t base = (static_cast<size_t>(b) * a.splits + split) * R;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = row0 + i;
    if (row >= R) continue;
    if (lane == 8 * i) {
      pm[base + row] = m_i;
      pl[base + row] = l_i;
    }
    float* out = pnv + (base + row) * RL;
#pragma unroll
    for (int j = 0; j < FC; ++j) out[lane + 32 * j] = acc[i][j];
  }
}

}  // namespace
