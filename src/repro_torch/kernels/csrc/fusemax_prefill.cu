// FuseMax 1-pass prefill attention (Cascade 5, Mapping 1) for Hopper.
//
// Replaces: src/repro/kernels/fusemax.py:_fusemax_kernel, launched by
// fusemax_attention_pallas (the TPU kernel behind ops.fusemax_attention).
// Two bodies; the one C entry below dispatches each call's plan to its
// body.  The GQA head dims (64, 64), (128, 128) and (256, 256),
// DeepSeek's MLA prefill (192, 128) and the smoke configs' (32, 32) and
// (48, 32) run the `wgmma` body of fusemax_prefill_wgmma.cuh; this file's
// `mma.sync` body keeps DeepSeek's absorbed (576, 512), whose Q split
// alone would take 288 KB at 64 rows.  A thread-block cluster body for
// that dim (two blocks a 64-row block, each with half of E and F) ran
// 3 % slower than this body in the same call (PERF.md); it is not part
// of this library: benchmarks/torch_k1_variants.py splices it in as a
// variant.  The mma.sync body also stays the parent that chip_smoke.py
// and the variants bench build at the dims the wgmma body took and hold
// it against.
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
//   next valid tile's correction factor exp(-1e30 - m) erases.  Keys past
//   the end of k (a partial last tile) do not exist for the plain version
//   and add nothing here either.
//
// What bounds it on this card: operations.  At prefill sizes each K/V
// tile is reused by a BQ-row Q tile, so the two matrix products
// (PG * M * (E + F) multiply-adds per fiber, halved by the causal bound)
// outweigh the bytes read.  Both products run on the tensor cores in
// error-compensated 3xTF32: each fp32 operand x is split into
// hi = rna_tf32(x) and lo = rna_tf32(x - hi) (cvt.rna.tf32.f32's
// rounding, done on the integer pipe), and mma.sync m16n8k8 accumulates
// lo·hi + hi·lo + hi·hi (small terms first) in fp32, which keeps the
// products about as accurate as fp32 FMA.  The ceiling is therefore
// 3 x FLOPs / 495 TFLOP/s (dense TF32), 2.7x above the 67 TFLOP/s of the
// FP32 units.  bf16 inputs are exact in TF32: their lo parts are zero
// and those products are skipped (1 mma for Q·K, 2 for P·V).
// Single-pass TF32 is never used.
//
// What the design does about it:
// * A warp owns MT = 2 m16 tiles (32 query rows), so every K and V
//   fragment it loads and splits feeds 2 x 3 mma; its scores live in
//   m16n8 accumulator fragments, a row's max needs only the 4-lane quad
//   shuffles, and the row sum stays a per-lane partial until the end.
// * 32 rows x F accumulators do not fit a warp's registers at F >= 128,
//   so WF warps share a 32-row group: each computes the scores of BK / WF
//   of the tile's keys and holds F / WF accumulator columns; the row max
//   is combined through shared memory and P goes through shared memory
//   once per key tile.
// * At F <= 64 one warp holds a row group (WF = 1) and P stays in
//   registers between the two products: the accumulator holds columns
//   {2t, 2t+1} where the A operand wants {t, t+4}, so the V rows of the
//   B fragment are permuted to match (key 2t <-> k index t, 2t+1 <->
//   t+4) instead of moving P.  At F >= 128 that design needs 16-row
//   warps, which split each fragment for half as many mma, and it ran
//   slower than the shared P of 32-row warps (PERF.md).
// * K/V arrive by 16-byte cp.async into a 3-stage ring of equal slots:
//   a key tile is E/KC K chunks [BK keys x KC] then BK/VK V chunks
//   [VK keys x F], so (576, 512) streams K over E and V over keys, and
//   chunk i + 2 is in flight while chunk i is computed.  KC is 64, or E
//   itself where E is below 64 or no multiple of it (the smoke head dims
//   32 and 48).  Q stays in shared memory for the whole sweep.  Every row
//   is padded by 16 bytes, which makes all fragment loads free of bank
//   conflicts.
// * The tensor cores' fp32 accumulation truncates, so a score is summed
//   in partials of at most KDEPTH k-steps that are added in IEEE fp32
//   (at KC = 48 a chunk's 6 k-steps are a partial of 4 and one of 2).
//   The split, the mma and KDEPTH are in tf32x3.cuh, which the MLA latent
//   decode body shares.
// * A key tile that every row of the block sees whole skips the masks;
//   query tiles run heaviest first (under a causal mask the last tiles
//   sweep the most keys), which shortens the tail of the grid.
//
// The tile is chosen per (E, F) instantiation (PrefillTile below; the
// parent builds add the dims the wgmma body took), and each runs under
// that one plan (BQ rows, one column block); the shared memory of one
// block (fp32) is
//   (576, 512) 64 x 64,  WF 4, 8 warps:         220,160 B (absorbed)
// (autotune.prefill_smem_bytes is the same formula, which the wrapper
// holds to fusemax_prefill_plan's report); the smoke dims' parent tiles
// were 128 x 64, WF 1, KC 32 (46,080 B) and KC 48 (66,560 B).  The TPU's
// sequential M1 grid axis becomes the loop over key tiles, and the TPU's
// per-tile skip becomes the loop bounds.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "fusemax_prefill_wgmma.cuh"
#include "prefill_softmax.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int NS = 3;   // ring stages

// ---- cp.async --------------------------------------------------------------

// 16 bytes global -> shared; zero-filled when !valid (src must still be
// a mapped address)
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

// ---- tiles and shared-memory layout ----------------------------------------

// The tile of each (E, F) instantiation: BQ query rows x BK keys; a row
// group of 16 MT rows (MT m16 tiles, which share every K and V fragment
// a warp loads and splits) is held by WF warps, each with F / WF
// accumulator columns and the scores of BK / WF keys; KC columns of E
// per K chunk.
template <int E, int F> struct PrefillTile;
template <> struct PrefillTile<576, 512> {
  static constexpr int BQ = 64, BK = 64, WF = 4, MT = 2, KC = 64;
};

// keys of a V chunk: the largest power of two (8 <= VK <= BK) whose
// [VK x F] slab fits the slot of a [BK x KC] K chunk
constexpr int v_chunk(int bk, int f, int kc, int pad) {
  int vk = bk;
  while (vk > 8 && vk * (f + pad) > bk * (kc + pad)) vk /= 2;
  return vk;
}

template <typename T, int E, int F> struct Layout {
  using Tile = PrefillTile<E, F>;
  static constexpr int BQ = Tile::BQ, BK = Tile::BK, WF = Tile::WF,
                       MT = Tile::MT, KC = Tile::KC;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per cp.async
  static constexpr int PAD = VEC;          // 16 bytes a row: no bank conflicts
  static constexpr int QS = E + PAD, KS = KC + PAD, VS = F + PAD;
  static constexpr int VK = v_chunk(BK, F, KC, PAD);
  static constexpr int SLOT = BK * KS > VK * VS ? BK * KS : VK * VS;
  static constexpr int PS = BK + 8;        // fp32 probability tile stride
  static constexpr int NKC = E / KC, NVC = BK / VK, NCH = NKC + NVC;
  static constexpr int NWARP = BQ / (16 * MT) * WF, NT = 32 * NWARP;
  static constexpr int BYTES =
      static_cast<int>(sizeof(T)) * (BQ * QS + NS * SLOT) +
      (WF > 1 ? 4 * (BQ * PS + BQ * WF) : 0);
  static_assert(E % KC == 0 && KC % 8 == 0 &&
                    BQ % (16 * MT) == 0 && BK % (8 * WF) == 0 &&
                    F % (8 * WF) == 0 && BK % VK == 0 && VK % 8 == 0,
                "tile shapes");
  static_assert(BYTES <= 232448, "the tiles exceed one block's shared memory");
};

// Issue chunk c (0 <= c < NCH) of the key tile at k0 into `slot`: c < NKC
// is K[k0, k0 + BK) x [c·KC, c·KC + KC), else V[k0 + (c - NKC)·VK, + VK) x
// F; keys past m are zero-filled.
template <typename T, int E, int F>
__device__ __forceinline__ void issue_chunk(T* slot, const T* kb,
                                            const T* vb, int m, int k0,
                                            int c, int tid) {
  using L = Layout<T, E, F>;
  if (c < L::NKC) {
    constexpr int KC = L::KC;
    constexpr int VPR = KC / L::VEC;
    for (int i = tid; i < L::BK * VPR; i += L::NT) {
      const int r = i / VPR, x = i % VPR;
      const int kr = k0 + r;
      cp_async16(slot + r * L::KS + x * L::VEC,
                 kb + static_cast<size_t>(min(kr, m - 1)) * E + c * KC +
                     x * L::VEC,
                 kr < m);
    }
  } else {
    constexpr int VPR = F / L::VEC;
    const int kv0 = k0 + (c - L::NKC) * L::VK;
    for (int i = tid; i < L::VK * VPR; i += L::NT) {
      const int r = i / VPR, x = i % VPR;
      const int kr = kv0 + r;
      cp_async16(slot + r * L::VS + x * L::VEC,
                 vb + static_cast<size_t>(min(kr, m - 1)) * F + x * L::VEC,
                 kr < m);
    }
  }
}

template <typename T, int E, int F, bool MACCS>
__global__ void __launch_bounds__(Layout<T, E, F>::NT)
fusemax_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int pg, int m, float scale,
                       int causal, int window, float softcap, int q_offset,
                       int group, int m_valid) {
  using L = Layout<T, E, F>;
  constexpr int BQ = L::BQ, BK = L::BK, WF = L::WF, MT = L::MT, VK = L::VK;
  constexpr int KC = L::KC;
  constexpr int KSTEPS = KC / 8;  // k-steps of a K chunk
  constexpr int KW = BK / WF;   // keys whose scores one warp computes
  constexpr int NSB = KW / 8;   // score n-blocks a warp holds per m-tile
  constexpr int FW = F / WF;    // accumulator columns one warp holds
  constexpr int NOB = FW / 8;   // accumulator n-blocks per m-tile
  constexpr bool EXACT = sizeof(T) == 2;  // bf16: exact in TF32
  constexpr bool P_REGS = WF == 1;        // P stays in registers

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);          // [BQ][QS]
  T* ring = qs + BQ * L::QS;                       // NS x SLOT
  float* ps = reinterpret_cast<float*>(ring + NS * L::SLOT);  // [BQ][PS]
  float* red = ps + BQ * L::PS;                    // [BQ][WF]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp / WF, wf = warp % WF;
  // heaviest query tiles first: under a causal mask the last tiles sweep
  // the most keys
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int rows = min(BQ, pg - r0);
  const T* qb = q + (static_cast<size_t>(bh) * pg + r0) * E;
  const T* kb = k + static_cast<size_t>(bh) * m * E;
  const T* vb = v + static_cast<size_t>(bh) * m * F;

  {
    constexpr int VPR = E / L::VEC;
    for (int i = tid; i < BQ * VPR; i += L::NT) {
      const int r = i / VPR, x = i % VPR;
      cp_async16(qs + r * L::QS + x * L::VEC,
                 qb + static_cast<size_t>(min(r, rows - 1)) * E + x * L::VEC,
                 r < rows);
    }
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
  const int n_chunks = t_end > t_begin ? (t_end - t_begin) * L::NCH : 0;

  auto issue = [&](int i) {
    if (i < n_chunks)
      issue_chunk<T, E, F>(ring + (i % NS) * L::SLOT, kb, vb, m,
                           (t_begin + i / L::NCH) * BK, i % L::NCH, tid);
    cp_commit();  // an empty group keeps the wait count uniform
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);  // Q joins the first group

  // this lane's rows: row[mt][0] = g and row[mt][1] = g + 8 of m-tile mt
  int row[MT][2], qpos[MT][2];
  float m_i[MT][2], l_i[MT][2];  // l: per-lane partial over the lane's keys
  float acc[MT][NOB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[mt][h] = (rg * MT + mt) * 16 + g + 8 * h;
      qpos[mt][h] = (r0 + row[mt][h]) / group + q_offset;
      m_i[mt][h] = NEG_INF;
      l_i[mt][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NOB; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mt][n][x] = 0.f;
  }

  int i = 0;  // chunk being consumed
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;

    // BQK (Eq. 42): s[mt][j] holds rows g, g + 8 of m-tile mt x keys
    // wf·KW + 8j + {2t, 2t + 1}
    float s[MT][NSB][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NSB; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[mt][j][x] = 0.f;
    for (int c = 0; c < L::NKC; ++c, ++i) {
      cp_wait<NS - 2>();
      __syncthreads();  // chunk i landed; chunk i - 1's slot is free
      issue(i + NS - 1);
      const T* kc = ring + (i % NS) * L::SLOT;
#pragma unroll
      for (int kp = 0; kp < KSTEPS; kp += KDEPTH) {
        float part[MT][NSB][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NSB; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) part[mt][j][x] = 0.f;
#pragma unroll
        for (int kk = kp; kk < kp + KDEPTH && kk < KSTEPS; ++kk) {
          const int e0 = c * KC + kk * 8 + t4;
          uint32_t qh[MT][4], ql[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const T* qr = qs + row[mt][0] * L::QS + e0;
            load_split(qr[0], qh[mt][0], ql[mt][0]);
            load_split(qr[8 * L::QS], qh[mt][1], ql[mt][1]);
            load_split(qr[4], qh[mt][2], ql[mt][2]);
            load_split(qr[8 * L::QS + 4], qh[mt][3], ql[mt][3]);
          }
#pragma unroll
          for (int j = 0; j < NSB; ++j) {
            const T* kr = kc + (wf * KW + j * 8 + g) * L::KS + kk * 8 + t4;
            uint32_t kh0, kl0, kh1, kl1;
            load_split(kr[0], kh0, kl0);
            load_split(kr[4], kh1, kl1);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma3<EXACT, EXACT>(part[mt][j], qh[mt], ql[mt], kh0, kh1, kl0,
                                 kl1);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < NSB; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) s[mt][j][x] += part[mt][j][x];
      }
    }

    // masks, LM/RM (Eqs. 43-44).  A tile whose keys all exist, are below
    // m_valid and are visible to every row of the block needs no mask.
    const bool full =
        k0 + BK <= m_valid && (!causal || k0 + BK - 1 <= q_lo) &&
        (window <= 0 || k0 > q_hi - window);
    float lm[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      lm[mt][0] = NEG_INF;
      lm[mt][1] = NEG_INF;
#pragma unroll
      for (int j = 0; j < NSB; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int h = x >> 1;
          const int kpos = k0 + wf * KW + j * 8 + 2 * t4 + (x & 1);
          float sx = s[mt][j][x] * scale;
          if (softcap > 0.f) sx = softcap * tanhf(sx / softcap);
          if (!full) {
            bool ok = kpos < m_valid;
            if (causal) ok = ok && kpos <= qpos[mt][h];
            if (window > 0) ok = ok && kpos > qpos[mt][h] - window;
            sx = ok ? sx : NEG_INF;
          }
          s[mt][j][x] = sx;
          lm[mt][h] = fmaxf(lm[mt][h], sx);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)  // the quad holds one row
          lm[mt][h] =
              fmaxf(lm[mt][h], __shfl_xor_sync(0xffffffffu, lm[mt][h], off));
    }
    if constexpr (WF > 1) {  // the row group's other warps hold other keys
      if (t4 == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) red[row[mt][h] * WF + wf] = lm[mt][h];
      }
      __syncthreads();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int w = 0; w < WF; ++w)
            lm[mt][h] = fmaxf(lm[mt][h], red[row[mt][h] * WF + w]);
    }

    // SLN/SLD, PRM/RD (Eqs. 45-46, 48-50)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float prm[2], sld[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m_i[mt][h], lm[mt][h]);
        prm[h] = fexp<MACCS>(m_i[mt][h] - mn);
        m_i[mt][h] = mn;
      }
#pragma unroll
      for (int j = 0; j < NSB; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int h = x >> 1;
          float p = fexp<MACCS>(s[mt][j][x] - m_i[mt][h]);
          if (!full && k0 + wf * KW + j * 8 + 2 * t4 + (x & 1) >= m) p = 0.f;
          s[mt][j][x] = p;
          sld[h] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_i[mt][h] = l_i[mt][h] * prm[h] + sld[h];
#pragma unroll
      for (int n = 0; n < NOB; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mt][n][x] *= prm[x >> 1];
      if constexpr (!P_REGS) {
#pragma unroll
        for (int j = 0; j < NSB; ++j) {
          const int col = wf * KW + j * 8 + 2 * t4;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(ps + row[mt][h] * L::PS + col) =
                make_float2(s[mt][j][2 * h], s[mt][j][2 * h + 1]);
        }
      }
    }

    // SLNV / RNV (Eqs. 47, 51-52).  The A fragment of k-step j takes key
    // 8j + 2t as its k index t and 8j + 2t + 1 as t + 4 -- the columns an
    // accumulator lane holds -- and the V rows of the B fragment follow.
#pragma unroll
    for (int c = 0; c < L::NVC; ++c, ++i) {
      cp_wait<NS - 2>();
      __syncthreads();  // chunk i landed (and, the first time, all of P)
      issue(i + NS - 1);
      const T* vc = ring + (i % NS) * L::SLOT;
#pragma unroll
      for (int kk = 0; kk < VK / 8; ++kk) {
        uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (P_REGS) {
            const int j = c * (VK / 8) + kk;
            split(s[mt][j][0], ph[mt][0], pl[mt][0]);
            split(s[mt][j][2], ph[mt][1], pl[mt][1]);
            split(s[mt][j][1], ph[mt][2], pl[mt][2]);
            split(s[mt][j][3], ph[mt][3], pl[mt][3]);
          } else {
            const float* pr =
                ps + row[mt][0] * L::PS + c * VK + kk * 8 + 2 * t4;
            const float2 pa = *reinterpret_cast<const float2*>(pr);
            const float2 pb = *reinterpret_cast<const float2*>(pr + 8 * L::PS);
            split(pa.x, ph[mt][0], pl[mt][0]);
            split(pb.x, ph[mt][1], pl[mt][1]);
            split(pa.y, ph[mt][2], pl[mt][2]);
            split(pb.y, ph[mt][3], pl[mt][3]);
          }
        }
        const T* vr = vc + (kk * 8 + 2 * t4) * L::VS + wf * FW + g;
#pragma unroll
        for (int n = 0; n < NOB; ++n) {
          uint32_t vh0, vl0, vh1, vl1;
          load_split(vr[n * 8], vh0, vl0);
          load_split(vr[L::VS + n * 8], vh1, vl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma3<false, EXACT>(acc[mt][n], ph[mt], pl[mt], vh0, vh1, vl0,
                               vl1);
        }
      }
    }
  }
  cp_wait<0>();

  // RD of the whole row: the quad's lanes, then the row group's warps
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l_i[mt][h] += __shfl_xor_sync(0xffffffffu, l_i[mt][h], off);
  if constexpr (WF > 1) {
    __syncthreads();
    if (t4 == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) red[row[mt][h] * WF + wf] = l_i[mt][h];
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_i[mt][h] = 0.f;
#pragma unroll
        for (int w = 0; w < WF; ++w) l_i[mt][h] += red[row[mt][h] * WF + w];
      }
  }

  // AV (Eq. 53): deferred division; rows no tile reached emit 0.  With
  // `lse`, one lane of the row's quad (in the row group's first warp)
  // also writes the row's log-sum-exp m + log(l), the reference's
  // rm + log(rd_safe): NEG_INF for a row no tile reached.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[mt][h] >= rows) continue;
      const float d = l_i[mt][h] == 0.f ? 1.f : l_i[mt][h];
      if (lse != nullptr && t4 == 0 && wf == 0)
        lse[static_cast<size_t>(bh) * pg + r0 + row[mt][h]] =
            m_i[mt][h] + logf(d);
      T* orow = o + (static_cast<size_t>(bh) * pg + r0 + row[mt][h]) * F +
                wf * FW + 2 * t4;
#pragma unroll
      for (int n = 0; n < NOB; ++n) {
        orow[n * 8] = from_f<T>(acc[mt][n][2 * h] / d);
        orow[n * 8 + 1] = from_f<T>(acc[mt][n][2 * h + 1] / d);
      }
    }
}

template <typename T, int E, int F, bool MACCS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int pg, int m, float scale, int causal,
                   int window, float softcap, int q_offset, int group,
                   int m_valid, cudaStream_t stream) {
  using L = Layout<T, E, F>;
  auto kern = fusemax_prefill_kernel<T, E, F, MACCS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((pg + L::BQ - 1) / L::BQ, bh);
  kern<<<grid, L::NT, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, pg, m, scale,
      causal, window, softcap, q_offset, group, m_valid);
  return cudaGetLastError();
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int bh, pg, m;
  float scale;
  int causal, window;
  float softcap;
  int q_offset, group, m_valid, maccs;
  cudaStream_t stream;
};

template <typename T, int E, int F>
cudaError_t launch_exp(const Args& a) {
  return a.maccs ? launch<T, E, F, true>(a.q, a.k, a.v, a.o, a.lse, a.bh,
                                         a.pg, a.m, a.scale, a.causal,
                                         a.window, a.softcap, a.q_offset,
                                         a.group, a.m_valid, a.stream)
                 : launch<T, E, F, false>(a.q, a.k, a.v, a.o, a.lse, a.bh,
                                          a.pg, a.m, a.scale, a.causal,
                                          a.window, a.softcap, a.q_offset,
                                          a.group, a.m_valid, a.stream);
}

template <typename T, int E, int F, int FS, bool MACCS>
cudaError_t launch_wgmma(const Args& a) {
  using L = WgLayout<T, E, F, FS>;
  auto kern = fusemax_prefill_wgmma_kernel<T, E, F, FS, MACCS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.pg + L::BQ - 1) / L::BQ * FS, a.bh);
  kern<<<grid, L::NT, L::BYTES, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.pg, a.m,
      a.scale, a.causal, a.window, a.softcap, a.q_offset, a.group,
      a.m_valid);
  return cudaGetLastError();
}

template <typename T, int E, int F, int FS>
cudaError_t launch_wgmma_exp(const Args& a) {
  return a.maccs ? launch_wgmma<T, E, F, FS, true>(a)
                 : launch_wgmma<T, E, F, FS, false>(a);
}

// The instantiations.  REPRO_DIMS (E, F) run this file's mma.sync body
// under the one plan of their PrefillTile (BQ rows, one column block);
// REPRO_WGMMA_PLANS (E, F, BQ, FS) run the wgmma body of
// fusemax_prefill_wgmma.cuh (64-row blocks, one or two column blocks, the
// key tile of its WgTile).  autotune.CUDA_PREFILL lists the same plans,
// in order.
#define REPRO_DIMS(X) X(576, 512)
#define REPRO_WGMMA_PLANS(X)                                                  \
  X(128, 128, 64, 1) X(128, 128, 64, 2) X(64, 64, 64, 1) X(64, 64, 64, 2)    \
  X(256, 256, 64, 1) X(192, 128, 64, 1) X(32, 32, 64, 1) X(48, 32, 64, 1)

template <typename T>
cudaError_t dispatch_plan(int e, int f, int block_q, int f_split,
                          const Args& a) {
#define REPRO_LAUNCH(E, F)                                                    \
  if (e == E && f == F && block_q == PrefillTile<E, F>::BQ && f_split == 1)  \
    return launch_exp<T, E, F>(a);
#define REPRO_LAUNCH_WGMMA(E, F, BQ, FS)                                      \
  if (e == E && f == F && block_q == BQ && f_split == FS)                     \
    return launch_wgmma_exp<T, E, F, FS>(a);
  REPRO_WGMMA_PLANS(REPRO_LAUNCH_WGMMA)
  REPRO_DIMS(REPRO_LAUNCH)
#undef REPRO_LAUNCH_WGMMA
#undef REPRO_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  (e, f): q/k head dim and v head dim,
// one of (64, 64), (128, 128), (192, 128), (576, 512), (256, 256),
// (32, 32), (48, 32); (block_q, f_split) one of the plans REPRO_DIMS or
// REPRO_WGMMA_PLANS compiles for them.  q, k, v and o must be 16-byte
// aligned.  window <= 0 means no window; softcap <= 0 means no softcap.
// lse, when not null, is an fp32 [bh, pg] output: each row's log-sum-exp
// of its scaled (softcapped, masked) scores, which a recompute backward
// reads.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fusemax_prefill(const void* q, const void* k, const void* v,
                               void* o, void* lse, int dtype, int e, int f,
                               int bh, int pg, int m, float scale, int causal,
                               int window, float softcap, int q_offset,
                               int group, int m_valid, int exp_maccs,
                               int block_q, int f_split, void* stream) {
  const Args a{q,         k,       v,        o,     static_cast<float*>(lse),
               bh,        pg,      m,        scale, causal,
               window,    softcap, q_offset, group, m_valid,
               exp_maccs, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return static_cast<int>(dispatch_plan<float>(e, f, block_q, f_split, a));
  if (dtype == 1)
    return static_cast<int>(
        dispatch_plan<__nv_bfloat16>(e, f, block_q, f_split, a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan (block_q, f_split) at head dims (e, f) for `dtype`: its key
// tile and the dynamic shared memory one block takes; returns
// cudaErrorInvalidValue (outputs untouched) for a plan not compiled.
extern "C" int fusemax_prefill_plan(int dtype, int e, int f, int block_q,
                                    int f_split, int* block_k,
                                    int* smem_bytes) {
#define REPRO_PLAN(E, F)                                                      \
  if (e == E && f == F && block_q == PrefillTile<E, F>::BQ && f_split == 1) { \
    *block_k = PrefillTile<E, F>::BK;                                         \
    *smem_bytes = dtype == 0 ? Layout<float, E, F>::BYTES                     \
                             : Layout<__nv_bfloat16, E, F>::BYTES;            \
    return 0;                                                                 \
  }
#define REPRO_PLAN_WGMMA(E, F, BQ, FS)                                        \
  if (e == E && f == F && block_q == BQ && f_split == FS) {                   \
    *block_k = WgLayout<float, E, F, FS>::BK;                                 \
    *smem_bytes = dtype == 0 ? WgLayout<float, E, F, FS>::BYTES               \
                             : WgLayout<__nv_bfloat16, E, F, FS>::BYTES;      \
    return 0;                                                                 \
  }
  if (dtype == 0 || dtype == 1) {
    REPRO_WGMMA_PLANS(REPRO_PLAN_WGMMA)
    REPRO_DIMS(REPRO_PLAN)
  }
#undef REPRO_PLAN_WGMMA
#undef REPRO_PLAN
  return static_cast<int>(cudaErrorInvalidValue);
}
