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
// rd] pair.  The walk, the masks and the reduction order are one
// template, and a chunk holds CK keys whatever block_k is, so on a pool
// whose pages hold the dense rows the two kernels at the same splits give
// the same bits: block_k only decides how far a split walks past kv_len,
// and a chunk of masked keys after a valid one adds exact zeros (p = 0,
// a rescale by exp(0) = 1).
//
// Replaces the first body of these kernels (true fp32 FMA on the FP32
// units, 4 query rows a warp in registers, a 16-shuffle butterfly per 4
// keys), which ran at 30 % of its FP32-units bound with one 228-register
// block per SM.
//
// What bounds it on this card: bytes at DeepSeek's decode step, operations
// at long contexts.  All G = 128 heads of DeepSeek-V3 share each latent
// row, so every key costs G * (r + rd + r) = 128 * 1088 multiply-adds; in
// error-compensated 3xTF32 (three TF32 products per fp32 product,
// tf32x3.cuh) that is 3 * 2 * G * sum(kv_len) * (2r + rd) FLOP at 495
// TFLOP/s.  At the decode step (8 slots, 2048-slot cache, 16 splits) that
// is 12.7 us, below the 15.9 us its bytes take at 3.35 TB/s: the latents
// read once (17.4 MB), the fp32 partials written once (16 splits x 128
// rows x 514 floats x 8 slots = 33.7 MB) and the queries.  At 8 x 16384
// tokens the operations (0.22 ms) outweigh the bytes (0.10 ms).
//
// What the design does about it:
// * Both products on mma.sync m16n8k8 TF32 in the 3-term split of
//   tf32x3.cuh (K1's helpers): Q.[ckv | krope]^T and P.ckv.  bf16
//   queries and latents are exact in TF32 and skip their lo products;
//   quantized pools are dequantized once per chunk into an fp32 tile and
//   take the fp32 path.  Score partials take at most KDEPTH k-steps on
//   the tensor cores before they are added in IEEE fp32; the value
//   product accumulates into the accumulator rescaled in fp32 (K1's
//   value product), so its 2 x 4 accumulator tiles a warp are
//   independent mma chains.
// * A head block of HB = 32 query rows (two m16 tiles) and 16 warps, no
//   spill.  Each warp holds 32 accumulator columns (8 warps of 64
//   columns with the query in registers took 255 registers and spilled;
//   16 warps with it in registers, 128, and spilled too).  The 32 x 576
//   query tile sits in shared memory (74 KB fp32) beside the ring; a
//   64-row block would need 147 KB for it and 128 accumulator registers
//   a thread, so it would read each latent chunk twice at G = 128
//   instead of four times (from L2), but leave no room for a 3-stage
//   ring of 37 KB chunks and the score partials.
// * The score of a chunk is split over E: 8 warps own the k-steps es,
//   es + 8, ... (9 of the 72) for one m16 tile each, and their partials
//   [32 rows x CK keys] go to shared memory, summed in a fixed order (es
//   = 0..7), so every launch gives the same bits.  The 16 threads of a
//   row then mask, take the running max and denominator by 4-step
//   shuffles, and publish P in fp32 (split into hi / lo once instead,
//   it is twice the bytes every value warp reads, and measured slower).
// * The value product's A fragment takes key 2t as k index t and key 2t +
//   1 as t + 4 (K1's permutation), so P loads as float2 pairs and the V
//   rows of the B fragment fall on distinct banks.
// * One shared-memory copy of each key feeds both products: a ring of NS
//   = 3 chunks of CK = 16 [ckv | krope] rows in the stored dtype, each
//   row padded by 16 bytes (conflict-free fragment loads), filled by
//   16-byte cp.async copies (32 threads per key, one token lookup each)
//   two chunks ahead of the one computed; the first r features of a row
//   are its value row, as the TPU kernel's latent pages double as its V
//   stream.  Rows of a chunk past the walk's end are zero-filled, so a
//   zero probability never meets a stale NaN pattern.
// * Where the time goes (benchmarks/torch_mla_variants.py, PERF.md): the
//   mma.sync issue of the three products is the largest part (single-pass
//   TF32 would take 28-37 % less), the operand splits 12-15 %, the
//   softmax's exponentials nothing; a 2-stage ring, one score partial,
//   16 score warps, or overlapping one chunk's value product with the
//   next chunk's score measured the same, and the query in registers
//   (which spilled) 10-17 % slower.  wgmma
//   would take its operands from shared memory, but 3xTF32 needs them
//   pre-split there (the query's hi and lo alone 147 KB at 32 rows), and
//   its 64-row minimum doubles that.
//
// Quantized pools (paged only; the reference's dense layout has none):
// the codes ride the same chunk loader, 16 codes a 16-byte copy (a (512,
// 64) key is 576 bytes, the smoke (32, 16) one 48; both halves stay
// multiples of 16, so no vector straddles them), and the two per-token
// scales of each key are plain loads by the key's first copy thread — per
// key and page, as a chunk may straddle pages — into a per-stage slot the
// chunk's barrier publishes.  The block dequantizes each chunk once, after
// it lands: each thread turns 4-code words into float(code) * float(scale)
// (exact in fp32) in an fp32 tile (zeros past the walk's end), and both
// products read that tile as they read an fp32 pool's chunk: a quantized
// launch gives the bits of an unquantized one on the dequantized pool.

#pragma once

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

constexpr int NT = 512;        // threads per block
constexpr int NW = NT / 32;    // warps
constexpr int HB = 32;         // query rows per block (head block)
constexpr int MT = HB / 16;    // m16 tiles of the head block
constexpr int CK = 16;         // keys per shared-memory chunk
constexpr int NS = 3;          // ring stages
constexpr int ES = 8;          // warps splitting the score's k-steps
constexpr int MTS = MT * ES / NW;  // m16 tiles of a warp's score
constexpr int SP = CK + 8;     // row stride (words) of the score / P tiles
constexpr int TPK = NT / CK;   // copy threads per key of a chunk
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(HB * CK == NT, "softmax: one (row, key) a thread");
static_assert(CK % 8 == 0 && HB % 16 == 0 && NW % ES == 0 &&
                  (MT * ES) % NW == 0,
              "m16n8k8 tiles");

// A code's value (the dequantizing read of int8 / fp8 e4m3 pools).
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

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src
// must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row stride, in elements, of a tile of rows of E features of element
// type X padded by 16 bytes (the ring's [ckv | krope] rows and the query
// tile), and of the fp32 tile a code chunk is dequantized into.
template <typename X>
__host__ __device__ constexpr int row_stride(int e) {
  return e + 16 / static_cast<int>(sizeof(X));
}
__host__ __device__ constexpr int deq_stride(int e) { return e + 4; }

// Shared memory of one block (autotune.mla_decode_smem_bytes is its twin):
// the ring of NS chunks of CK [ckv | krope] rows of the stored element
// (elem_bytes); for code pools each stage's CK (latent, rope) fp32 scales
// and one dequantized fp32 chunk; the HB query rows (fp32 beside code
// pools, else the stored element); then the ES score partials [HB][SP],
// P [HB][SP] and the HB rows' rescale factors, all fp32.  Every region is
// a multiple of 16 bytes.
__host__ __device__ constexpr int mla_smem_bytes(int rank, int rope,
                                                 int elem_bytes, bool scaled) {
  return NS * CK * (rank + rope + 16 / elem_bytes) * elem_bytes +
         (scaled ? NS * CK * 2 * 4 + CK * deq_stride(rank + rope) * 4 : 0) +
         HB * (rank + rope + 16 / (scaled ? 4 : elem_bytes)) *
             (scaled ? 4 : elem_bytes) +
         4 * ((ES + 1) * HB * SP + HB);
}

// Issue the asynchronous copy of chunk [c0, c0 + nk) of [ckv | krope] rows
// of element type S into the ring slot kt [CK][row_stride]: TPK threads
// per key, one token lookup each (the policy Src), 16-byte copies (a
// vector never straddles ckv and krope); the rows past nk are zero-filled.
// For code pools (SCALED) the key's first thread also loads its two fp16
// scales into sc [CK][2] (latent, rope) as fp32.
template <typename S, int RL, int RR, bool SCALED, class Src>
__device__ __forceinline__ void issue_chunk(
    S* kt, float* sc, const S* __restrict__ ckv, const S* __restrict__ krope,
    const __half* __restrict__ ckv_scale,
    const __half* __restrict__ krope_scale, const Src& src, int b, int c0,
    int nk, const MlaArgs& a) {
  constexpr int E = RL + RR;
  constexpr int VEC = 16 / sizeof(S);
  const int c = threadIdx.x / TPK;
  const bool live = c < nk;
  const long long tok = live ? src.token(a, b, c0 + c) : 0;
  const S* src_c = ckv + tok * RL;
  const S* src_r = krope + tok * RR;
  S* row = kt + c * row_stride<S>(E);
  for (int v = threadIdx.x % TPK; v < E / VEC; v += TPK) {
    const int e = v * VEC;
    cp_async16(row + e, e < RL ? src_c + e : src_r + (e - RL), live);
  }
  if constexpr (SCALED) {
    if (live && threadIdx.x % TPK == 0) {
      sc[2 * c] = __half2float(ckv_scale[tok]);
      sc[2 * c + 1] = __half2float(krope_scale[tok]);
    }
  }
}

// Dequantize a landed code chunk kb [CK][row_stride] with its scales sc
// [CK][2] (latent, rope) into the fp32 tile out [CK][deq_stride]: each
// thread takes 4-code words (a word never straddles a key or the
// latent/rope boundary: E, RL and RR are multiples of 16); the keys past
// nk become zeros.
template <typename S, int RL, int RR>
__device__ __forceinline__ void dequant_chunk(float* out, const S* kb,
                                              const float* sc, int nk) {
  constexpr int E = RL + RR;
  constexpr int WR = E / 4;     // words a key
  static_assert(sizeof(S) == 1 && E % 4 == 0 && RL % 4 == 0, "4-code words");
  for (int w = threadIdx.x; w < CK * WR; w += NT) {
    const int c = w / WR, e = 4 * (w - c * WR);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < nk) {
      const float s = sc[2 * c + (e < RL ? 0 : 1)];
      const unsigned x = *reinterpret_cast<const unsigned*>(
          kb + c * row_stride<S>(E) + e);
      f.x = to_f(code_of<S>(x & 0xffu)) * s;
      f.y = to_f(code_of<S>((x >> 8) & 0xffu)) * s;
      f.z = to_f(code_of<S>((x >> 16) & 0xffu)) * s;
      f.w = to_f(code_of<S>(x >> 24)) * s;
    }
    *reinterpret_cast<float4*>(out + c * deq_stride(E) + e) = f;
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
  constexpr int E = RL + RR;          // score features: latent + rope
  constexpr int KSTEPS = E / 8;       // k-steps of the score
  constexpr int KPW = (KSTEPS + ES - 1) / ES;  // score k-steps a warp owns
  constexpr int NSB = CK / 8;         // score n-blocks (8 keys each)
  constexpr int VW = RL / 8 < NW ? RL / 8 : NW;  // value-product warps
  constexpr int FW = RL / VW;         // accumulator columns a value warp owns
  constexpr int NOB = FW / 8;         // its accumulator n-blocks
  constexpr int PK = CK / 8;          // k-steps of the value product
  constexpr bool SCALED = !std::is_same<T, S>::value;
  // what both products read: the landed chunk, or for code pools its
  // dequantized tile
  using Rd = typename std::conditional<SCALED, float, S>::type;
  constexpr int RS = SCALED ? deq_stride(E) : row_stride<S>(E);
  constexpr int QS = row_stride<T>(E);
  constexpr bool Q_EXACT = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool K_EXACT = std::is_same<Rd, __nv_bfloat16>::value;
  static_assert(E % 8 == 0 && RL % (8 * VW) == 0, "m16n8k8 tiles");
  static_assert(RL % (16 / sizeof(S)) == 0 && RR % (16 / sizeof(S)) == 0,
                "16-byte copies tile the latent and rope rows");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ring = reinterpret_cast<S*>(smem_raw);      // [NS][CK][row_stride]
  constexpr int SLOT = CK * row_stride<S>(E);    // elements of one stage
  float* sct = reinterpret_cast<float*>(ring + NS * SLOT);  // [NS][CK][2]
  float* kdq = sct + (SCALED ? NS * CK * 2 : 0);  // [CK][deq_stride]
  T* qs = reinterpret_cast<T*>(kdq + (SCALED ? CK * deq_stride(E) : 0));
  float* red = reinterpret_cast<float*>(qs + HB * QS);  // [ES][HB][SP]
  float* pt = red + ES * HB * SP;                 // [HB][SP] P
  float* prm_s = pt + HB * SP;                    // [HB]

  const int sid = blockIdx.x;     // this block's split
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.z * HB;
  const int R = a.rows;
  const int kvl = kv_len[b];

  // tiles of this split the TPU kernel runs (its per-tile skip)
  const int split0 = sid * a.split_len;
  const int n_tiles = a.split_len / a.block_k;
  const int lim = kvl + a.n_pos - 1 - split0;
  const int t1 =
      lim <= 0 ? 0 : min(n_tiles, (lim + a.block_k - 1) / a.block_k);
  const int kfin = split0 + t1 * a.block_k;
  const int n_chunks = (kfin - split0 + CK - 1) / CK;

  // the head block's query rows (rows past R zero-filled) join the first
  // copy group
  if (n_chunks > 0) {
    constexpr int QV = E * sizeof(T) / 16;       // 16-byte vectors a row
    for (int i = tid; i < HB * QV; i += NT) {
      const int r = i / QV, v = i - r * QV;
      const bool live = row0 + r < R;
      cp_async16(qs + r * QS + v * (16 / sizeof(T)),
                 q + (static_cast<size_t>(b) * R + (live ? row0 + r : 0)) *
                         E + v * (16 / sizeof(T)),
                 live);
    }
  }
  auto issue = [&](int i) {
    if (i < n_chunks) {
      const int c0 = split0 + i * CK;
      issue_chunk<S, RL, RR, SCALED>(ring + (i % NS) * SLOT,
                                     sct + (i % NS) * CK * 2, ckv, krope,
                                     ckv_scale, krope_scale, src, b, c0,
                                     min(CK, kfin - c0), a);
    }
    cp_commit();  // an empty group keeps the wait count uniform
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);

  // the score role: warp w sums the k-steps es, es + ES, ... of the
  // score (es = w % ES) for the MTS m-tiles from m-tile mt0
  const int es = warp % ES;
  const int mt0 = warp / ES * MTS;
  // the softmax role: row sr of the block, key sk of each chunk, and the
  // row's running max and denominator (held by its CK threads)
  const int sr = tid / CK, sk = tid % CK;
  const int my_lim =
      a.n_pos == 1 ? kvl : kvl + (row0 + sr) / a.rows_per_pos;
  float m_i = NEG_INF, l_i = 0.f;
  // the value role: accumulator columns warp * FW + 8 n + 2 t4, + 1 of
  // rows g, g + 8 of each m-tile
  float acc[MT][NOB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NOB; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mt][n][x] = 0.f;

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = split0 + ch * CK;
    const int nk = min(CK, kfin - c0);
    cp_wait<NS - 2>();
    __syncthreads();  // chunk ch landed; the slot of chunk ch - 1 is free
    issue(ch + NS - 1);
    const Rd* kb;
    if constexpr (SCALED) {
      dequant_chunk<S, RL, RR>(kdq, ring + (ch % NS) * SLOT,
                               sct + (ch % NS) * CK * 2, nk);
      __syncthreads();  // the dequantized chunk is complete
      kb = kdq;
    } else {
      kb = ring + (ch % NS) * SLOT;
    }

    // scores: this warp's share of Q.K^T over its k-steps, in partials of
    // at most KDEPTH k-steps added in fp32; s[mt][j] = rows g, g + 8 of
    // m-tile mt0 + mt x keys 8 j + 2 t4, + 1
    {
      float s[MTS][NSB][4];
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
        for (int j = 0; j < NSB; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x) s[mt][j][x] = 0.f;
#pragma unroll
      for (int ip = 0; ip < KPW; ip += KDEPTH) {
        float part[MTS][NSB][4];
#pragma unroll
        for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
          for (int j = 0; j < NSB; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) part[mt][j][x] = 0.f;
#pragma unroll
        for (int i = ip; i < ip + KDEPTH && i < KPW; ++i) {
          const int kk = es + i * ES;
          if (KSTEPS % ES != 0 && kk >= KSTEPS) break;  // warp-uniform
          uint32_t qh[MTS][4], ql[MTS][4];
#pragma unroll
          for (int mt = 0; mt < MTS; ++mt) {
            const T* qr = qs + ((mt0 + mt) * 16 + g) * QS + 8 * kk + t4;
            load_split(qr[0], qh[mt][0], ql[mt][0]);
            load_split(qr[8 * QS], qh[mt][1], ql[mt][1]);
            load_split(qr[4], qh[mt][2], ql[mt][2]);
            load_split(qr[8 * QS + 4], qh[mt][3], ql[mt][3]);
          }
#pragma unroll
          for (int j = 0; j < NSB; ++j) {
            const Rd* kr = kb + (8 * j + g) * RS + 8 * kk + t4;
            uint32_t kh0, kl0, kh1, kl1;
            load_split(kr[0], kh0, kl0);
            load_split(kr[4], kh1, kl1);
#pragma unroll
            for (int mt = 0; mt < MTS; ++mt)
              mma3<Q_EXACT, K_EXACT>(part[mt][j], qh[mt], ql[mt], kh0, kh1,
                                     kl0, kl1);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
          for (int j = 0; j < NSB; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) s[mt][j][x] += part[mt][j][x];
      }
#pragma unroll
      for (int mt = 0; mt < MTS; ++mt)
#pragma unroll
        for (int j = 0; j < NSB; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                red + (es * HB + (mt0 + mt) * 16 + g + 8 * h) * SP + 8 * j +
                2 * t4) = make_float2(s[mt][j][2 * h], s[mt][j][2 * h + 1]);
    }
    __syncthreads();  // every warp's score partial is in shared memory

    // the row's score (the ES partials in order), scale, softcap, masks;
    // its running max, exp and denominator over the chunk's keys (the CK
    // lanes of a row are adjacent), then P
    {
      float x = red[sr * SP + sk];
#pragma unroll
      for (int w = 1; w < ES; ++w) x += red[(w * HB + sr) * SP + sk];
      x *= a.scale;
      if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
      x = c0 + sk < my_lim ? x : NEG_INF;
      float lm = sk < nk ? x : NEG_INF;
#pragma unroll
      for (int off = 1; off < CK; off <<= 1)
        lm = fmaxf(lm, __shfl_xor_sync(0xffffffffu, lm, off));
      const float m_new = fmaxf(m_i, lm);
      const float p = sk < nk ? fexp<MACCS>(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 1; off < CK; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float prm = fexp<MACCS>(m_i - m_new);
      l_i = l_i * prm + sum;
      m_i = m_new;
      pt[sr * SP + sk] = p;
      if (sk == 0) prm_s[sr] = prm;
    }
    __syncthreads();  // P and the rescale factors are published

    // accumulator = accumulator * prm + P.ckv: the latent chunk is the
    // value stream.  k index t of k-step kk is key 8 kk + 2 t, t + 4 is
    // key 8 kk + 2 t + 1.  The mma accumulates into the rescaled
    // accumulator (K1's value product), so the warp's MT x NOB
    // accumulator tiles are independent chains.
    if (warp < VW) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float f = prm_s[mt * 16 + g + 8 * h];
#pragma unroll
          for (int n = 0; n < NOB; ++n) {
            acc[mt][n][2 * h] *= f;
            acc[mt][n][2 * h + 1] *= f;
          }
        }
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) {
        uint32_t pfh[MT][4], pfl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 pv = *reinterpret_cast<const float2*>(
                pt + (mt * 16 + g + 8 * h) * SP + 8 * kk + 2 * t4);
            split(pv.x, pfh[mt][h], pfl[mt][h]);          // a0 / a1: key 2 t
            split(pv.y, pfh[mt][h + 2], pfl[mt][h + 2]);  // a2 / a3: 2 t + 1
          }
        const Rd* vr = kb + (8 * kk + 2 * t4) * RS + warp * FW + g;
#pragma unroll
        for (int n = 0; n < NOB; ++n) {
          uint32_t vh0, vl0, vh1, vl1;
          load_split(vr[8 * n], vh0, vl0);
          load_split(vr[RS + 8 * n], vh1, vl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma3<false, K_EXACT>(acc[mt][n], pfh[mt], pfl[mt], vh0, vh1,
                                 vl0, vl1);
        }
      }
    }
  }
  cp_wait<0>();

  const size_t base = (static_cast<size_t>(b) * a.splits + sid) * R;
  if (sk == 0 && row0 + sr < R) {
    pm[base + row0 + sr] = m_i;
    pl[base + row0 + sr] = l_i;
  }
  if (warp < VW) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + g + 8 * h;
        if (row >= R) continue;
        float* out = pnv + (base + row) * RL + warp * FW + 2 * t4;
#pragma unroll
        for (int n = 0; n < NOB; ++n)
          *reinterpret_cast<float2*>(out + 8 * n) =
              make_float2(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
      }
  }
}

}  // namespace
