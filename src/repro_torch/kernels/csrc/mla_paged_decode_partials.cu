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
// What it computes (the TPU kernel's function, not its block structure):
// DeepSeek's absorbed-form decode with Hkv = 1 and every query head in
// one group.  q [B, R, r + rd] holds R = n_pos * G folded query rows
// (row = position * G + head; the first r features are the W_uk-absorbed
// query, the last rd the rope query); the pools are ckv [P, ps, r] and
// krope [P, ps, rd] behind a block table [B, W].  Per key the score is
// q[:r] . ckv + q[r:] . krope, and the latent row ckv is also the value,
// so the accumulator is [R, r] (the caller applies W_uv).  Each split of
// split_len = (W / splits) * ps tokens sweeps the block_k-key tiles the
// TPU kernel runs (k_lo < kv_len + n_pos - 1, as loop bounds), with the
// running (m, l, acc) of Cascade 5 and the finite NEG_INF = -1e30; a key
// is valid for row r if kpos < kv_len + r / rows_per_pos (n_pos verify
// positions; n_pos = 1: kpos < kv_len).  A split in which no tile runs
// emits (NEG_INF, 0, 0), so a slot with kv_len = 0 decodes to exactly 0
// after the combine, as on the TPU.  Pages are looked up per key (a chunk
// may straddle pages), the sentinel id P clamped to P - 1 (those keys lie
// past kv_len and are masked).
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
// of [ckv | krope] in the pool's dtype, double-buffered (2 x 37 KB fp32)
// and filled by 16-byte cp.async copies (16 threads per key, one page
// lookup each) while the previous chunk is computed; every warp of the
// block reads it, each shared-memory read feeding 4 FMAs.  Scores go 4
// keys at a time: a warp's 16 (row, key) dot products are summed across
// the lanes by a transposed butterfly (16 shuffles, after which lane l
// holds row l >> 3, key (l >> 1) & 3), so the running max and denominator
// are 2-step shuffles over the lanes of a row, and the value pass
// broadcasts each probability from its lane.  Each latent tile is read
// once per head block (4 at G = 128), mostly from L2.  True fp32 FMA
// throughout; bf16 widened on the shared-memory read.  Tensor cores
// (wgmma on the [32 x 576] x [576 x 16] score tile and the [32 x 16] x
// [16 x 512] value tile) and TMA are left for a later change.
//
// Quantized pools: the codes ride the same chunk loader, 16 codes a
// 16-byte copy (a (512, 64) key is 576 bytes, the smoke (32, 16) one 48;
// both halves stay multiples of 16, so no vector straddles them), and the
// two per-token scales of each key are plain loads by the key's first
// copy thread — per key and page, as a chunk may straddle pages — into a
// per-buffer slot the chunk's barrier publishes.  Every warp reads every
// feature of a chunk, so the block dequantizes each chunk once, after it
// lands: each thread turns 4-code words into float(code) * float(scale)
// (exact in fp32) in an fp32 tile, and the score and value passes read
// that tile as they read an fp32 pool's chunk, in the unchanged FMA order:
// a quantized launch gives the bits of an unquantized one on the
// dequantized pool.  The bound stays operations (the FMAs do not change);
// the bytes fall to a quarter.

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
  int n_pages, ps, w;       // pool pages, page size, table width
  int splits, split_len, block_k;
  int n_pos, rows_per_pos;
  float scale;
  float softcap;            // <= 0: no softcap
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
// one page lookup each, 16-byte copies (a vector never straddles ckv and
// krope).  For code pools (SCALED) the key's first thread also loads its
// two fp16 scales into sc [CK][2] (latent, rope) as fp32.
template <typename S, int RL, int RR, bool SCALED>
__device__ __forceinline__ void issue_chunk(
    S* kt, float* sc, const S* __restrict__ ckv, const S* __restrict__ krope,
    const __half* __restrict__ ckv_scale,
    const __half* __restrict__ krope_scale,
    const int* __restrict__ block_table, int b, int c0, int nk,
    const MlaArgs& a) {
  constexpr int E = RL + RR;
  constexpr int VEC = 16 / sizeof(S);
  const int c = threadIdx.x >> 4;
  if (c >= nk) return;
  const int kpos = c0 + c;
  const int page = min(block_table[static_cast<size_t>(b) * a.w + kpos / a.ps],
                       a.n_pages - 1);
  const long long tok = static_cast<long long>(page) * a.ps + kpos % a.ps;
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
                                   krope_scale, block_table, b, split0,
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
          krope, ckv_scale, krope_scale, block_table, b, c0 + CK,
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
// [b, splits, rows, rank] fp32.  Splits are page-aligned: split_len = (w /
// splits) * page_size, and page_size % block_k == 0.  softcap <= 0: no
// softcap.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mla_paged_decode_partials(
    const void* q, const void* ckv_pages, const void* krope_pages,
    const void* ckv_scale, const void* krope_scale, const void* block_table,
    const void* kv_len, void* pm, void* pl, void* pnv, int dtype,
    int kv_code, int rank, int rope_dim, int b, int rows, int n_pages,
    int page_size, int w, int splits, int split_len, int block_k, int n_pos,
    int rows_per_pos, float scale, float softcap, int exp_maccs,
    void* stream) {
  const MlaArgs a{rows,   n_pages,   page_size, w,            splits,
                  split_len, block_k, n_pos,     rows_per_pos, scale,
                  softcap};
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
