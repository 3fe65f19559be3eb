// Split-K decode partials body shared by the dense (K2,
// decode_partials.cu) and paged (K3, paged_decode_partials.cu) kernels.
//
// One block per (split, batch*kv-head fiber, block of RB query rows)
// computes the running (m, l, acc) of Cascade 5 over the key tiles of its
// split that the TPU kernels run — tiles with k_lo < kv_len + P - 1 and,
// with a window, k_hi > kv_len - 1 - window, as loop bounds — for its
// rows of the fiber.  Row r is draft position r / rows_per_pos and
// attends keys < kv_len + position (P = 1: keys < kv_len).  A split in
// which no tile runs emits (NEG_INF, 0, 0), so a slot with kv_len = 0
// decodes to exactly 0 after the combine, as on the TPU.
//
// The two layouts differ only in where key row `kpos` of a fiber lives,
// which a KV policy answers (DenseKV: row kpos of the fiber's [M, D]
// slab; PagedKV: offset kpos % ps of the split's page (kpos - split0) /
// ps, from a page list the block loads once into shared memory, the
// sentinel id clamped to the last page, Hkv * D elements per token).  The
// walk, the masks and the fp32 FMA order are one template, so on a pool
// whose pages hold a dense cache's rows the two kernels at the same
// splits give the same bits: with P = 1 and no window both walks end at
// kv_len (see below), and elsewhere block_k only decides how far a split
// walks past kv_len, which adds exact zeros to a row that has seen a
// valid key.
//
// What bounds it on this card: bytes.  One query row per kv head meets
// each cached key once, so the kernel does ~2 * rows * D multiply-adds
// per key against 2 * D * sizeof(T) bytes of K and V — far below the
// H100's ~20 FLOP per byte fp32 balance point.  The least time is the
// K/V bytes of the valid prefix over 3.35 TB/s.  A split holds only a
// few chunks (8 pages of 16 keys at granite's decode shape), so what
// keeps a block from that rate is the latency of each chunk's loads, and
// what keeps the card at it is enough blocks resident on each SM.
//
// What the design does about it:
// * the split's page ids are loaded into shared memory once, beside the
//   kv_len load, so a chunk's row addresses are arithmetic;
// * K and V rows stream through a ring of STAGES chunks of CK keys with
//   16-byte cp.async.cg copies (NT / CK threads per key row, one address
//   computation per thread and chunk); chunk c + STAGES - 1 is requested
//   before chunk c is computed, one barrier per chunk.  A small ring (2 x
//   16 keys, 32 KB at fp32 d128) leaves registers, not shared memory, to
//   bound the blocks per SM; benchmarks/torch_decode_variants.py measures
//   it against 3 stages and 32- or 64-key chunks;
// * each lane owns D / 32 contiguous features (1 at D = 32, 8 at D =
//   256) of every query row its warp serves, and of their accumulators,
//   in registers; a chunk's keys are split between WK warps, each with
//   its own (m, l, acc), merged
//   once per split in shared memory (exact where a warp saw only masked
//   keys: its m = NEG_INF meets a real maximum with a factor 0); scores
//   are per-lane partial dots summed across the warp by a transposed
//   butterfly (NP (row, key) dots in NP - 1 shuffles when NP = 32), the
//   running max and sum are shuffles over the lanes of a row, and the
//   value pass broadcasts each probability from its lane;
// * with P = 1 and no window the walk stops at kv_len: every tile that
//   runs starts below kv_len, so each row has a valid key in the split's
//   first chunk and a later chunk past kv_len would add exact zeros.
//   With P > 1 or a window a row can have no valid key in a tile that
//   runs, and its output then depends on how many masked keys the walk
//   crosses, so there the walk is the whole tile-run range.
// Scores, softmax and the accumulator update are true fp32 FMA; bf16 is
// widened on the shared-memory read.  The partials are written without
// the TPU's 128-lane padding.
//
// Quantized pools (K3 only, the TPU kernel's `quantized` branch): a
// PagedKVT whose element type E differs from the queries' T holds int8
// or fp8 e4m3 codes, with fp16 scale pools [n_pages, ps, Hkv] beside
// them.  The codes ride the same 16-byte cp.async ring, 16 codes a copy
// (VPR and TPK follow from bytes: a d32 code row is two copies).  A
// token's scales are Hkv * 2 bytes apart, too narrow for cp.async, so
// each chunk's CK K and V scales are plain loads into a per-stage slot
// that the barrier publishing the chunk also publishes.  Each feature is
// dequantized on its shared-memory read, float(code) * float(scale) —
// exact in fp32 — and the fp32 FMA order is unchanged, so a quantized
// launch gives the bits of an unquantized one on the dequantized pool.

#pragma once

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>

namespace {

constexpr int NT = 128;       // threads per block (4 warps)
constexpr int NW = NT / 32;   // warps per block
constexpr int CK = 16;        // keys per chunk (one ring stage)
constexpr int STAGES = 2;     // chunks the ring holds
constexpr int WK = 4;         // warps that split a chunk's keys
constexpr int MAX_ROW_BLOCKS = 65535;  // grid.z: row blocks of one fiber
constexpr int SMEM_BUDGET = 232448;  // dynamic shared memory of one block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

static_assert(NW % WK == 0 && CK % WK == 0 && NT % CK == 0,
              "warps split a chunk's keys evenly, threads its key rows");

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

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Query rows a block serves: 4, or 8 when a fiber has more than 4 (at D =
// 256 the 8-row block holds 128 query and accumulator floats a lane:
// ptxas gives it 200-203 registers and no spill).
__host__ __device__ constexpr int row_block(int rows) {
  return rows <= 4 ? 4 : 8;
}

// Most folded query rows (P * G) a fiber takes: one block per RB of them on
// grid.z, whose limit is the only bound.  Nothing in the body assumes fewer:
// the merge's [WK][RB] state, the query load and the chain limit
// kvl + row / rows_per_pos all index by row_base + (row within the block),
// and the partials by (bh * splits + split) * R + row.
__host__ __device__ constexpr int max_rows() {
  return MAX_ROW_BLOCKS * row_block(MAX_ROW_BLOCKS);
}

// Shared memory of one block (autotune.decode_smem_bytes is its twin):
// the ring, STAGES x [K rows | V rows] of CK x D elements, which the
// cross-warp merge ([WK][RB] m, [WK][RB] l, [WK][RB][D] acc, fp32)
// reuses after the walk; on a quantized pool the scale slots, STAGES x
// [K | V] x CK fp32; then the split's page list.
__host__ __device__ constexpr int ring_bytes(int rb, int d, int elem_bytes) {
  return round16(STAGES * 2 * CK * d * elem_bytes > 4 * WK * rb * (d + 2)
                     ? STAGES * 2 * CK * d * elem_bytes
                     : 4 * WK * rb * (d + 2));
}
__host__ __device__ constexpr int scale_bytes(bool scaled) {
  return scaled ? 4 * STAGES * 2 * CK : 0;
}
__host__ __device__ constexpr int smem_bytes(int rows, int d, int elem_bytes,
                                             int pages, bool scaled) {
  return ring_bytes(row_block(rows), d, elem_bytes) + scale_bytes(scaled) +
         4 * ((pages + 3) / 4 * 4);
}

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// Scalar arguments of one launch.  `splits` is the launch's split count;
// a strip of a longer sweep starts at global split `split_first` (0 for a
// whole sweep), so split s of the grid covers keys from
// (split_first + s) * split_len, and its partials land at local index s.
struct DecodeArgs {
  int hkv, R, splits, split_len, block_k, n_pos, rows_per_pos;
  float scale;
  int window;       // <= 0: no window
  float softcap;    // <= 0: no softcap
  int split_first;  // strip: the first global split (whole sweep: 0)
};

// Where K and V live, as the C entry points receive it; each KV policy
// below takes what it needs.
struct KVSource {
  const void* k;
  const void* v;
  const void* k_scale;      // paged code pools only: fp16 [n_pages, ps, Hkv]
  const void* v_scale;
  const int* block_table;   // paged only
  int m;                    // dense: cache slots per fiber held
  int k0;                   // dense: global index of the first key held
  int w, ps, n_pages, hkv;  // paged: table width, page size, pool pages
};

// Dense cache [B*Hkv, M, D] holding keys k0 .. k0 + M - 1 (a strip of a
// sequence-sharded cache; k0 = 0 for a whole one): key row kpos (a global
// key index) of fiber bh.
template <typename T, int D>
struct DenseKV {
  using Elem = T;                        // stored element
  static constexpr bool kPaged = false;
  static constexpr bool kScaled = false;
  const T* k;
  const T* v;
  int m;
  int k0;
  static DenseKV from(const KVSource& s, int) {
    return {static_cast<const T*>(s.k), static_cast<const T*>(s.v), s.m,
            s.k0};
  }
  int pages() const { return 0; }  // no page list
  __device__ __forceinline__ void load_pages(int*, int, int) const {}
  __device__ __forceinline__ size_t row(const int*, int bh, int,
                                        int kpos) const {
    return (static_cast<size_t>(bh) * m + (kpos - k0)) * D;
  }
};

// Page pool [n_pages, ps, Hkv, D] behind a block table [B, W]: the split's
// split_len / ps page ids (splits are page-aligned) sit in shared memory,
// the sentinel id n_pages clamped to the last page (such keys lie past
// kv_len, masked).  E is the stored element: T, or the int8 / fp8 e4m3
// code of a quantized pool, whose fp16 scale of key row r (an element
// offset, as row() returns it) is k_scale[r / D].
template <typename T, int D, typename E>
struct PagedKVT {
  using Elem = E;
  static constexpr bool kPaged = true;
  static constexpr bool kScaled = !std::is_same<T, E>::value;
  const E* k;
  const E* v;
  const __half* k_scale;
  const __half* v_scale;
  const int* block_table;
  int w, ps, n_pages, hkv;
  int split_pages;  // page-list entries
  static PagedKVT from(const KVSource& s, int split_len) {
    return {static_cast<const E*>(s.k), static_cast<const E*>(s.v),
            static_cast<const __half*>(s.k_scale),
            static_cast<const __half*>(s.v_scale), s.block_table, s.w, s.ps,
            s.n_pages, s.hkv, split_len / s.ps};
  }
  int pages() const { return split_pages; }
  __device__ __forceinline__ void load_pages(int* list, int bh,
                                             int split0) const {
    const int* ids =
        block_table + static_cast<size_t>(bh / hkv) * w + split0 / ps;
    for (int i = threadIdx.x; i < split_pages; i += NT)
      list[i] = min(ids[i], n_pages - 1);
  }
  __device__ __forceinline__ size_t row(const int* list, int bh, int split0,
                                        int kpos) const {
    const int b = bh / hkv;
    const int h = bh - b * hkv;
    const int kq = kpos - split0;
    const int pi = kq / ps;
    const int page = list[pi];
    return ((static_cast<size_t>(page) * ps + (kq - pi * ps)) * hkv + h) * D;
  }
};

// The layouts dispatch_partials instantiates: pages in the queries'
// dtype, and the two code pools.
template <typename T, int D>
using PagedKV = PagedKVT<T, D, T>;
template <typename T, int D>
using PagedInt8KV = PagedKVT<T, D, int8_t>;
template <typename T, int D>
using PagedFp8KV = PagedKVT<T, D, __nv_fp8_e4m3>;

// 16-byte asynchronous copy global -> shared (sm_80+), bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// FPL contiguous features of a key row in shared memory, as fp32.
__device__ __forceinline__ void load_feats(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load_feats(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load_feats(const float* p, float (&o)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  o[0] = t.x; o[1] = t.y;
}
__device__ __forceinline__ void load_feats(const float* p, float (&o)[1]) {
  o[0] = *p;
}
__device__ __forceinline__ void load_feats(const __nv_bfloat16* p,
                                           float (&o)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_feats(const __nv_bfloat16* p,
                                           float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load_feats(const __nv_bfloat16* p,
                                           float (&o)[2]) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = a.x; o[1] = a.y;
}
__device__ __forceinline__ void load_feats(const __nv_bfloat16* p,
                                           float (&o)[1]) {
  o[0] = __bfloat162float(*p);
}

// N contiguous 1-byte codes of a key row in shared memory (N-byte
// aligned), as fp32: one vector load, then each byte converted exactly.
__device__ __forceinline__ float code_to_f(int8_t, unsigned b) {
  return static_cast<float>(static_cast<signed char>(b));
}
__device__ __forceinline__ float code_to_f(__nv_fp8_e4m3, unsigned b) {
  const __half_raw h =
      __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b), __NV_E4M3);
  return __half2float(__half(h));
}
template <typename C, int N>
__device__ __forceinline__ void load_codes(const C* p, float (&o)[N]) {
  static_assert(sizeof(C) == 1 && N <= 8, "1-byte codes, up to 8 a lane");
  unsigned w[2] = {0u, 0u};
  if constexpr (N == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned char*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    o[i] = code_to_f(C{}, (w[i / 4] >> (8 * (i % 4))) & 0xffu);
}
template <int N>
__device__ __forceinline__ void load_feats(const int8_t* p, float (&o)[N]) {
  load_codes(p, o);
}
template <int N>
__device__ __forceinline__ void load_feats(const __nv_fp8_e4m3* p,
                                           float (&o)[N]) {
  load_codes(p, o);
}

// Sum N per-lane values v[0..N-1] across the warp (a transposed
// butterfly: each of the log2(N) first steps sends half of the live values
// and keeps the other half, the remaining steps are plain).  Lane l
// returns the warp-wide sum of v[l >> (5 - log2 N)].
template <int N>
__device__ __forceinline__ float lane_sum(float (&v)[N], int lane) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int LOGN = ilog2(N);
  // every index below is a constant once the loops unroll, so v stays in
  // registers
#pragma unroll
  for (int st = 0; st < LOGN; ++st) {
    const int h = N >> (st + 1);
    const int mask = 16 >> st;
    const bool up = lane & mask;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (i < h) {
        const float keep = up ? v[i + h] : v[i];
        const float send = up ? v[i] : v[i + h];
        v[i] = keep + __shfl_xor_sync(FULL, send, mask);
      }
    }
  }
  float s = v[0];
#pragma unroll
  for (int st = LOGN; st < 5; ++st)
    s += __shfl_xor_sync(FULL, s, 16 >> st);
  return s;
}

template <typename T, int D, bool MACCS, int RB, class KV>
__global__ void __launch_bounds__(NT)
decode_partials_kernel(const T* __restrict__ q, const KV kv,
                       const int* __restrict__ kv_len,
                       float* __restrict__ pm, float* __restrict__ pl,
                       float* __restrict__ pnv, const DecodeArgs a) {
  constexpr unsigned FULL = 0xffffffffu;
  using S = typename KV::Elem;           // stored K/V element
  constexpr bool SCALED = KV::kScaled;   // codes with fp16 scales
  constexpr int FPL = D / 32;            // features per lane
  constexpr int VEC = 16 / sizeof(S);    // elements per 16-byte copy
  constexpr int VPR = D / VEC;           // copies per key row
  constexpr int TPK = NT / CK;           // threads that copy one key row
  // copies per thread and key row; at bf16 D = 32 a row is 4 copies for
  // 8 threads, and the upper half of them copies nothing
  constexpr int CPT = (VPR + TPK - 1) / TPK;
  constexpr int RW = RB / (NW / WK);     // query rows per warp
  constexpr int KW = CK / WK;            // keys per warp and chunk
  constexpr int KG = KW < 32 / RW ? KW : 32 / RW;  // keys per score group
  constexpr int NP = RW * KG;            // (row, key) dots per lane_sum
  constexpr int NG = KW / KG;            // score groups per warp and chunk
  constexpr int SH = 5 - ilog2(NP);      // lane >> SH: a lane's dot
  constexpr int STAGE = 2 * CK * D;      // elements per ring stage
  static_assert(D % 32 == 0 && (FPL == 1 || FPL == 2 || FPL == 4 ||
                                 FPL == 8),
                "lanes own 1, 2, 4 or 8 contiguous features");
  static_assert(VPR % TPK == 0 || TPK % VPR == 0,
                "a key row's copies split evenly over its threads");
  static_assert(RB % (NW / WK) == 0 && NP <= 32 && (NP & (NP - 1)) == 0 &&
                    KW % KG == 0,
                "warps tile the rows; a score group fits the lanes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* ring = reinterpret_cast<S*>(smem_raw);
  // quantized pools: [STAGES][K | V][CK] fp32 scales of each chunk's keys
  float* scales =
      reinterpret_cast<float*>(smem_raw + ring_bytes(RB, D, sizeof(S)));
  int* page_list = reinterpret_cast<int*>(
      smem_raw + ring_bytes(RB, D, sizeof(S)) + scale_bytes(SCALED));

  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int row_base = blockIdx.z * RB;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int split0 = (a.split_first + split) * a.split_len;

  kv.load_pages(page_list, bh, split0);
  const int kvl = kv_len[bh / a.hkv];
  const int q_pos = kvl - 1;        // the query is the newest token

  // tiles of this split the TPU kernel runs (its per-tile skip)
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
  // P = 1 without a window: chunks wholly past kv_len add exact zeros
  const bool skip = a.n_pos == 1 && a.window <= 0;
  const int kend = skip ? min(kfin, kvl) : kfin;
  const int n_chunks = kend > kbeg ? (kend - kbeg + CK - 1) / CK : 0;

  // copy role: thread tid copies vectors cvec, cvec + TPK, ... of key row
  // ckey of each chunk, K and V
  const int ckey = tid / TPK, cvec = tid % TPK;
  auto fetch = [&](int ch) {
    const int c0 = kbeg + ch * CK;
    if (ch < n_chunks && ckey < kend - c0 && cvec < VPR) {
      const size_t r = kv.row(page_list, bh, split0, c0 + ckey);
      S* dst = ring + (ch % STAGES) * STAGE + ckey * D;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int e = (cvec + TPK * i) * VEC;
        cp_async16(dst + e, kv.k + r + e);
        cp_async16(dst + CK * D + e, kv.v + r + e);
      }
    }
    if constexpr (SCALED) {
      // thread t < CK loads key t's K scale, CK <= t < 2 CK key t - CK's
      // V scale: plain loads, published by the barrier that publishes
      // the chunk
      const int key = tid % CK;
      if (ch < n_chunks && tid < 2 * CK && key < kend - c0) {
        const size_t r = kv.row(page_list, bh, split0, c0 + key) / D;
        scales[(ch % STAGES) * 2 * CK + tid] =
            __half2float(tid < CK ? kv.k_scale[r] : kv.v_scale[r]);
      }
    }
    cp_async_commit();  // always: one group per chunk slot
  };

  // compute role: warp serves block rows r0 .. r0 + RW - 1 and keys
  // kw0 .. kw0 + KW - 1 of every chunk; after a score group's lane_sum,
  // lane l holds row my_i, key my_k of the group
  const int kw0 = (warp % WK) * KW;
  const int r0 = (warp / WK) * RW;
  const int my_i = (lane >> SH) / KG, my_k = (lane >> SH) % KG;
  const int my_row = row_base + r0 + my_i;
  const int my_lim = a.n_pos == 1 ? kvl : kvl + my_row / a.rows_per_pos;
  const bool windowed = a.window > 0;
  float qr[RW][FPL], acc[RW][FPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = row_base + r0 + i;
    const T* qrow = q + (static_cast<size_t>(bh) * a.R + row) * D + lane * FPL;
#pragma unroll
    for (int j = 0; j < FPL; ++j) {
      qr[i][j] = row < a.R ? to_f(qrow[j]) : 0.f;
      acc[i][j] = 0.f;
    }
  }
  float m_i = NEG_INF, l_i = 0.f;

  if constexpr (KV::kPaged) __syncthreads();  // the page list has landed
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1's readers are done
    fetch(ch + STAGES - 1);
    const int c0 = kbeg + ch * CK;
    const int nk = min(CK, kend - c0);
    if (kw0 >= nk) continue;  // warp-uniform: none of its keys, no update
    const S* kb = ring + (ch % STAGES) * STAGE;
    const S* vb = kb + CK * D;
    const float* ksc = scales + (ch % STAGES) * 2 * CK;  // SCALED only
    const float* vsc = ksc + CK;

    // scores: the lanes split the features, the warp's rows share each
    // key row, lane_sum sums a group's NP (row, key) dots across the lanes
    float x[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      x[g] = 0.f;
      if (kw0 + g * KG >= nk) continue;  // warp-uniform
      float part[NP];
#pragma unroll
      for (int t = 0; t < NP; ++t) part[t] = 0.f;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        float kf[FPL];
        load_feats(kb + (kw0 + g * KG + k) * D + lane * FPL, kf);
        if constexpr (SCALED) {
          const float sk = ksc[kw0 + g * KG + k];
#pragma unroll
          for (int j = 0; j < FPL; ++j) kf[j] *= sk;
        }
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int j = 0; j < FPL; ++j)
            part[i * KG + k] = fmaf(qr[i][j], kf[j], part[i * KG + k]);
      }
      x[g] = lane_sum<NP>(part, lane);
    }

    // scale, softcap, masks; the row's running max, exp and denominator
    // over the warp's keys of the chunk (lanes differing in bits SH ..
    // SH + log2 KG - 1 hold them); keys past nk are not in the walk
    float lm = NEG_INF;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int key = kw0 + g * KG + my_k;
      const int kpos = c0 + key;
      float s = x[g] * a.scale;
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      const bool ok = kpos < my_lim && (!windowed || kpos > q_pos - a.window);
      x[g] = ok ? s : NEG_INF;
      if (key < nk) lm = fmaxf(lm, x[g]);
    }
#pragma unroll
    for (int o = 1 << SH; o < (KG << SH); o <<= 1)
      lm = fmaxf(lm, __shfl_xor_sync(FULL, lm, o));
    const float m_new = fmaxf(m_i, lm);
    float p[NG], sum = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      p[g] = kw0 + g * KG + my_k < nk ? fexp<MACCS>(x[g] - m_new) : 0.f;
      sum += p[g];
    }
#pragma unroll
    for (int o = 1 << SH; o < (KG << SH); o <<= 1)
      sum += __shfl_xor_sync(FULL, sum, o);
    const float prm = fexp<MACCS>(m_i - m_new);
    l_i = l_i * prm + sum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float f = __shfl_sync(FULL, prm, (i * KG) << SH);
#pragma unroll
      for (int j = 0; j < FPL; ++j) acc[i][j] *= f;
    }

    // accumulator += p . V, key by key in order
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      if (kw0 + kk >= nk) break;  // warp-uniform
      float pc[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        pc[i] = __shfl_sync(FULL, p[kk / KG], (i * KG + kk % KG) << SH);
      float vf[FPL];
      load_feats(vb + (kw0 + kk) * D + lane * FPL, vf);
      if constexpr (SCALED) {
        const float sv = vsc[kw0 + kk];
#pragma unroll
        for (int j = 0; j < FPL; ++j) vf[j] *= sv;
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < FPL; ++j) acc[i][j] = fmaf(pc[i], vf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  const int nr = min(RB, a.R - row_base);
  const size_t base =
      (static_cast<size_t>(bh) * a.splits + split) * a.R + row_base;
  const bool holds_row = (lane & ((1 << SH) - 1)) == 0 && my_k == 0;
  if constexpr (WK > 1) {
    // merge the WK warps' states of each row: M = max m_w, every state
    // scaled by exp(m_w - M), summed in warp order
    float* mm = reinterpret_cast<float*>(smem_raw);  // [WK][RB]
    float* ml = mm + WK * RB;                        // [WK][RB]
    float* ma = ml + WK * RB;                        // [WK][RB][D]
    const int kwi = warp % WK;
    __syncthreads();  // every warp is done with the ring the merge reuses
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int j = 0; j < FPL; ++j)
        ma[(kwi * RB + r0 + i) * D + lane * FPL + j] = acc[i][j];
    if (holds_row) {
      mm[kwi * RB + r0 + my_i] = m_i;
      ml[kwi * RB + r0 + my_i] = l_i;
    }
    __syncthreads();
    for (int idx = tid; idx < nr * D; idx += NT) {
      const int r = idx / D, e = idx - r * D;
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < WK; ++w) mx = fmaxf(mx, mm[w * RB + r]);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w)
        s = fmaf(fexp<MACCS>(mm[w * RB + r] - mx), ma[(w * RB + r) * D + e],
                 s);
      pnv[(base + r) * D + e] = s;
    }
    for (int r = tid; r < nr; r += NT) {
      float mx = NEG_INF;
#pragma unroll
      for (int w = 0; w < WK; ++w) mx = fmaxf(mx, mm[w * RB + r]);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WK; ++w)
        s = fmaf(fexp<MACCS>(mm[w * RB + r] - mx), ml[w * RB + r], s);
      pm[base + r] = mx;
      pl[base + r] = s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      if (r0 + i >= nr) break;
      float* out = pnv + (base + r0 + i) * D + lane * FPL;
#pragma unroll
      for (int j = 0; j < FPL; ++j) out[j] = acc[i][j];
    }
    if (holds_row && r0 + my_i < nr) {
      pm[base + r0 + my_i] = m_i;
      pl[base + r0 + my_i] = l_i;
    }
  }
}

// Launch one instantiation on `stream`; returns cudaGetLastError().
template <typename T, int D, bool MACCS, int RB, class KV>
cudaError_t launch_partials(const void* q, const KV& kv, const void* kv_len,
                            void* pm, void* pl, void* pnv, int bh, int smem,
                            const DecodeArgs& a, cudaStream_t stream) {
  auto kern = decode_partials_kernel<T, D, MACCS, RB, KV>;
  if (smem > 48 * 1024) {
    // opened up once per instantiation and device, not on every launch
    static std::atomic<unsigned> opened{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (!bit || !(opened.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
      if (err != cudaSuccess) return err;
      opened.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const dim3 grid(a.splits, bh, (a.R + RB - 1) / RB);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), kv, static_cast<const int*>(kv_len),
      static_cast<float*>(pm), static_cast<float*>(pl),
      static_cast<float*>(pnv), a);
  return cudaGetLastError();
}

constexpr int elem_bytes_of(int dtype) { return dtype == 1 ? 2 : 4; }

// Dispatch on (dtype: 0 = float32, 1 = bfloat16; BF16 = false builds
// float32 only) x (head_dim: 32, 64, 128, 256) x exp variant x row block,
// with the K/V layout KVT.
template <template <typename, int> class KVT, bool BF16 = true>
cudaError_t dispatch_partials(int dtype, int head_dim, int maccs,
                              const void* q, const KVSource& src,
                              const void* kv_len, void* pm, void* pl,
                              void* pnv, int bh, const DecodeArgs& a,
                              cudaStream_t st) {
  if (a.R < 1 || a.R > max_rows()) return cudaErrorInvalidValue;
#define REPRO_LAUNCH(T, D, RB)                                                \
  (maccs ? launch_partials<T, D, true, RB>(q, kv, kv_len, pm, pl, pnv, bh,    \
                                           smem, a, st)                       \
         : launch_partials<T, D, false, RB>(q, kv, kv_len, pm, pl, pnv, bh,   \
                                            smem, a, st))
#define REPRO_DISPATCH(T, D)                                                  \
  {                                                                           \
    using KV = KVT<T, D>;                                                     \
    const KV kv = KV::from(src, a.split_len);                                 \
    const int smem = smem_bytes(a.R, D, sizeof(typename KV::Elem),            \
                                kv.pages(), KV::kScaled);                     \
    if (smem > SMEM_BUDGET) return cudaErrorInvalidValue;                     \
    return row_block(a.R) == 4 ? REPRO_LAUNCH(T, D, 4)                        \
                               : REPRO_LAUNCH(T, D, 8);                       \
  }
  if (dtype == 0 && head_dim == 128) REPRO_DISPATCH(float, 128)
  if (dtype == 0 && head_dim == 64) REPRO_DISPATCH(float, 64)
  if (dtype == 0 && head_dim == 256) REPRO_DISPATCH(float, 256)
  if (dtype == 0 && head_dim == 32) REPRO_DISPATCH(float, 32)
  if constexpr (BF16) {
    if (dtype == 1 && head_dim == 128) REPRO_DISPATCH(__nv_bfloat16, 128)
    if (dtype == 1 && head_dim == 64) REPRO_DISPATCH(__nv_bfloat16, 64)
    if (dtype == 1 && head_dim == 256) REPRO_DISPATCH(__nv_bfloat16, 256)
    if (dtype == 1 && head_dim == 32) REPRO_DISPATCH(__nv_bfloat16, 32)
  }
#undef REPRO_DISPATCH
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace
