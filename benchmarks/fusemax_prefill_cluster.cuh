// K1 at DeepSeek's absorbed latent attention (576, 512) as `wgmma` in
// error-compensated 3xTF32 on a thread-block cluster of C blocks that
// share one 64-row block of queries.
//
// A candidate for that dim, which ships on the `mma.sync` body of
// src/repro_torch/kernels/csrc/fusemax_prefill.cu (both port
// src/repro/kernels/fusemax.py:_fusemax_kernel, called at :243): at the
// absorbed timing shape it ran 3 % slower than that body in the same call
// (PERF.md), so it is no part of the port.  torch_k1_variants.py's
// cluster_source splices it into the shipped K1 source for its `cluster*`
// variants: the part above the line "the C entry" into the source's
// namespace, after its Args and launchers (it uses the helpers of
// fusemax_prefill_wgmma.cuh, prefill_softmax.cuh and tf32x3.cuh, and
// REPRO_CLUSTER_PLANS, which cluster_source defines), and the part below
// at the end.  It computes the same function as the
// wgmma body of fusemax_prefill_wgmma.cuh: Cascade 5 / Mapping 1 with
// deferred division, causal / window / softcap / q_offset / m_valid,
// native or MACC exp, the optional log-sum-exp output, the finite
// NEG_INF, the Pallas tile-run rule as loop bounds, heaviest query tiles
// first and the l = 0 -> 1 guard.
//
// Why a cluster: the wgmma body keeps a 64-row block's Q split (hi and lo)
// in shared memory for the whole sweep; at E = 576 that is 294,912 B, more
// than the 232,448 a block may take, and P·V's accumulators at F = 512
// would be 256 fp32 registers a thread.  A column split that recomputes
// the scores in each block would repeat Q·Kᵀ, 53 % of the FLOPs.  So the
// C blocks of a cluster split both products: block c holds columns
// [c·E/C, (c+1)·E/C) of Q and K and columns [c·F/C, (c+1)·F/C) of V and of
// the output.
//
// What the design does:
// * Each tile, block c computes its partial scores S_c (64 x BK, summed in
//   partials of KDEPTH k-steps as the other bodies do) and stores them
//   into each peer's shared memory (`st.shared::cluster`); one lane of
//   each warp then arrives on the peer's score barrier
//   (`mbarrier.arrive.release.cluster`, after the warp's `__syncwarp`); it
//   waits on its own barrier for the peers' partials.  Slots and barriers
//   alternate by tile parity: a block writes tile i + 2's scores only
//   after the peer's tile i + 1 arrived, which the peer sent after
//   reading tile i's.
// * Every block forms the same sum of the C partials in the same order,
//   S_0 + S_1 at C = 2 (IEEE addition commutes) and (S_0 + S_1) + (S_2 +
//   S_3) at C = 4, and runs the same masks, running max, exponentials and
//   denominators on it: every block of the cluster holds the same m, l
//   and P bits for a row, so its output columns are normalised alike.
//   Block 0 writes the log-sum-exp.
// * Q is held raw (fp32, bf16 widened) in shared memory in the order of
//   `wgmma`'s register A fragments: one 16-byte load a k-step a thread,
//   split into hi and lo in registers; Q·Kᵀ is `wgmma` m64nBKk8 with A
//   from registers (484 TFLOP/s bare at N = 32, against 323 with A from
//   shared memory) in commit groups of KB k-steps, NF in flight, each
//   group's fragments loaded and split before the wait for the group
//   NF - 1 back.  With ClTile's QS, Q is instead split once into hi and
//   lo in shared memory (the wgmma body's layout) and Q·Kᵀ reads A from
//   there (323 TFLOP/s bare at N = 32), which saves the split of every
//   k-step.  P·V is m64n(F/C)k8 with P from registers, as on the wgmma
//   body.
// * A second warpgroup (the splitter) loads the block's columns of each K
//   and V tile from global memory (L2) into its registers one tile ahead
//   (no raw tiles in shared memory: 32-key tiles would not fit beside
//   them) and splits them into the wgmma body's layouts, K in 16-byte
//   chunks of 8 neighbouring keys, V a lane a column (both free of bank
//   conflicts), handing the buffers over by full / empty mbarriers.
// * The wait for the peers' scores is one asm loop around `try_wait`: a
//   C++ loop there made ptxas serialise every wgmma (C7518).
// * The cluster's blocks start after a cluster barrier (every block's
//   mbarriers initialised) and end on one (no block exits while a peer
//   may still write into its shared memory).
//
// What bounds it (variants, PERF.md): with the splitter idle it ran 16 %
// faster, without the score exchange 7 %; fp32 takes all 255 registers
// and spills 48 bytes.
//
// Shared memory of one block (fp32; ClLayout): Q, 64 x E / C floats
// (with QS 2 x, its hi and lo; bf16: hi only); the K and Vᵀ splits, 2 x
// NBUF x BK x (E + F) / C floats (bf16: hi only); the peers' scores, 2 x
// (C - 1) x 64 x BK floats; 2 + 4 NBUF mbarriers:
//   (576, 512) C 2 BK 32 NBUF 1:       229,424 B (one block an SM)
//   (576, 512) C 4 BK 32 NBUF 1 QS:    192,560 B

// d (64 x 16, fp32) += A (64 x 8, registers) · B (16 x 8)ᵀ (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// waits until at most N of this warpgroup's committed wgmma groups are
// in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps A fragments in their registers up to this point (a wgmma in
// flight may still read them)
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[i][x])::"memory");
}

// ---- the cluster: ranks, barriers, distributed shared memory -----------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster; orders shared-memory
// writes before it against reads after it, cluster-wide
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
// the shared::cluster address of `p`'s counterpart in block `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_peer4(uint32_t addr, float a, float b,
                                         float c, float d) {
  asm volatile(
      "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d)
      : "memory");
}
// arrive on a peer's mbarrier, releasing this thread's earlier writes
// (its stores into the peer's shared memory) at cluster scope
__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}
// wait for a phase of a barrier that peers arrive on, acquiring their
// writes.  The loop is one asm statement: as a C++ loop around the try
// (mbar_wait's form) between the two products, it made ptxas serialise
// every wgmma of the kernel (C7518).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra LAB_WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---- the body ----------------------------------------------------------

// The key tile of each (E, F) the cluster body takes: BK keys, NBUF split
// buffers each of K and of Vᵀ, KB Q·Kᵀ k-steps a commit group, NF groups
// in flight, and QS: Q split once in shared memory (Q·Kᵀ reads A from
// there), else held raw and split into registers each k-step
template <int E, int F> struct ClTile;
template <> struct ClTile<576, 512> {
  static constexpr int BK = 32, NBUF = 1, KB = 1, NF = 3, QS = 0;
};

template <typename T, int E, int F, int C> struct ClLayout {
  static constexpr int BQ = 64, BK = ClTile<E, F>::BK,
                       NBUF = ClTile<E, F>::NBUF, EC = E / C, FC = F / C,
                       NT = 256;
  static constexpr bool QS = ClTile<E, F>::QS != 0;
  static constexpr bool EXACT = sizeof(T) == 2;  // bf16: lo = 0
  static constexpr int NB = EXACT ? 1 : 2;       // split buffers: hi (, lo)
  static constexpr int NQ = QS ? NB : 1;         // Q: raw, or its split
  // floats: Q (raw, or one of its split's buffers), one K split, one Vᵀ
  // split, one peer's scores of a tile
  static constexpr int QOP = BQ * EC, KOP = BK * EC, VOP = FC * BK,
                       XOP = BQ * BK;
  // K full, Vᵀ full, K empty, Vᵀ empty per buffer; the peers' scores of
  // an even / odd tile
  static constexpr int NBAR = 2 + 4 * NBUF;
  static constexpr int BYTES =
      4 * (NQ * QOP + NB * NBUF * (KOP + VOP) + 2 * (C - 1) * XOP) +
      8 * NBAR;
  // a splitter thread's share of a tile: K 16-byte chunks, V units of 8
  // keys of one column
  static constexpr int KU = BK * EC / 4 / 128, VU = BK / 8 * FC / 128;
  static_assert((C == 2 || C == 4) && E % (16 * C) == 0 && F % C == 0 &&
                    (FC == 128 || FC == 256) && (BK == 16 || BK == 32) &&
                    KU * 128 == BK * EC / 4 && VU * 128 == BK / 8 * FC,
                "cluster tile shapes");
  static_assert(BYTES <= 232448, "the tiles exceed one block's shared memory");
};

template <typename T, int E, int F, int C, bool MACCS>
__global__ void __launch_bounds__(ClLayout<T, E, F, C>::NT)
fusemax_prefill_cluster_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o,
                               float* __restrict__ lse, int pg, int m,
                               float scale, int causal, int window,
                               float softcap, int q_offset, int group,
                               int m_valid) {
  using L = ClLayout<T, E, F, C>;
  constexpr int BQ = L::BQ, BK = L::BK, EC = L::EC, FC = L::FC, NB = L::NB;
  constexpr int NBUF = L::NBUF, KU = L::KU, VU = L::VU;
  constexpr bool EXACT = L::EXACT, QS = L::QS;
  constexpr int NSB = BK / 8;        // score n-blocks (and P·V k-steps)
  constexpr int SW = BK / 2;         // scores a thread holds
  constexpr int KSTEPS = EC / 8;     // Q·Kᵀ k-steps of the block's columns
  constexpr int NPART = (KSTEPS + KDEPTH - 1) / KDEPTH;  // score partials
  constexpr int KB = ClTile<E, F>::KB;  // Q·Kᵀ k-steps a commit group
  constexpr int NF = ClTile<E, F>::NF;  // commit groups in flight
  constexpr int NG = (KSTEPS + KB - 1) / KB;  // commit groups
  // a group within one partial; a partial's accumulator is summed before
  // the partial two on takes it
  static_assert(KDEPTH % KB == 0 && NF >= 2 && NF <= KDEPTH / KB + 1,
                "commit groups");
  // barriers
  constexpr int KF = 0, VF = NBUF, KE = 2 * NBUF, VE = 3 * NBUF,
                XB = 4 * NBUF;

  extern __shared__ __align__(128) unsigned char cl_smem[];
  // Q: raw in A-fragment order, or (QS) its split [NQ][QOP]
  float* qf = reinterpret_cast<float*>(cl_smem);
  float* ks = qf + L::NQ * L::QOP;             // K splits [NBUF][NB][KOP]
  float* vs = ks + NBUF * NB * L::KOP;         // Vᵀ splits [NBUF][NB][VOP]
  float* xs = vs + NBUF * NB * L::VOP;         // peers' scores [2][C-1][XOP]
  uint64_t* bar = reinterpret_cast<uint64_t*>(xs + 2 * (C - 1) * L::XOP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rank = static_cast<int>(cluster_rank());
  const int r0 = (gridDim.x / C - 1 - blockIdx.x / C) * BQ;
  const int e0 = rank * EC, f0 = rank * FC;
  const int bh = blockIdx.y;
  const int rows = min(BQ, pg - r0);
  const T* qb = q + (static_cast<size_t>(bh) * pg + r0) * E;
  const T* kb = k + static_cast<size_t>(bh) * m * E;
  const T* vb = v + static_cast<size_t>(bh) * m * F;

  const int q_lo = r0 / group + q_offset;
  const int q_hi = (r0 + rows - 1) / group + q_offset;
  const int kstart = window > 0 ? max(0, q_lo - window + 1) : 0;
  int kend = m_valid;
  if (causal) kend = min(kend, q_hi + 1);
  const int t_begin = kstart / BK;
  const int t_end = kend > 0 ? (kend + BK - 1) / BK : 0;
  const int n_tiles = max(0, t_end - t_begin);

  if (tid == 0) {
    for (int b = 0; b < XB; ++b) mbar_init(&bar[b], 128);
    mbar_init(&bar[XB], 4 * (C - 1));  // a consumer warp of each peer
    mbar_init(&bar[XB + 1], 4 * (C - 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (QS) {
    // Q's columns of the block, split once for the sweep: chunk (r, c) of
    // 4 columns at c·BQ + r (the wgmma body's layout)
    for (int i = tid; i < BQ * EC / 4; i += L::NT) {
      const int r = i % BQ, c = i / BQ;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows)
        load4<T>(qb + static_cast<size_t>(r) * E + e0 + 4 * c, x);
      put_split<EXACT>(qf, qf + (L::NQ - 1) * L::QOP, i, x);
    }
    fence_async_smem();  // Q's split visible to wgmma
  } else {
    // Q's columns of the block in A-fragment order: k-step kk's fragment of
    // consumer thread t is the float4 at kk·128 + t: rows (16 w + g, + 8) x
    // columns (8 kk + t4, + 4) of warp w, lane (g, t4)
    for (int i = tid; i < KSTEPS * 128; i += L::NT) {
      const int kk = i >> 7, t = i & 127;
      const int ra = 16 * (t >> 5) + ((t & 31) >> 2), rb = ra + 8;
      const int ca = e0 + 8 * kk + (t & 3), cb = ca + 4;
      float4 x;
      x.x = ra < rows ? to_f(qb[static_cast<size_t>(ra) * E + ca]) : 0.f;
      x.y = rb < rows ? to_f(qb[static_cast<size_t>(rb) * E + ca]) : 0.f;
      x.z = ra < rows ? to_f(qb[static_cast<size_t>(ra) * E + cb]) : 0.f;
      x.w = rb < rows ? to_f(qb[static_cast<size_t>(rb) * E + cb]) : 0.f;
      reinterpret_cast<float4*>(qf)[i] = x;
    }
  }
  cluster_sync();  // every block's barriers initialised; Q stored

  if (warp >= 4) {
    // the splitter: each tile's K and V columns of the block from global
    // memory (L2) into registers one tile ahead, then, once the products
    // of the tile before are done with the buffer, split into it (the
    // wgmma body's layouts; keys >= m are zeros)
    const int st = tid - 128;
    float kr[KU][4], vr[VU][8];
    // K chunk `it` of this thread: key n, 4-column chunk c.  A warp reads
    // 8 keys x 4 chunks (64 bytes of each key's row) and writes 8
    // consecutive keys of each chunk (no bank conflict).
    auto k_chunk = [&](int it, int& n, int& c) {
      const int u = st + it * 128;
      n = (u & 7) + 8 * ((u >> 5) % (BK / 8));
      c = ((u >> 3) & 3) + 4 * (u / (4 * BK));
    };
    auto load_k = [&](int i) {
      const int k0 = (t_begin + i) * BK;
#pragma unroll
      for (int it = 0; it < KU; ++it) {
        int n, c;
        k_chunk(it, n, c);
#pragma unroll
        for (int x = 0; x < 4; ++x) kr[it][x] = 0.f;
        if (k0 + n < m)
          load4<T>(kb + static_cast<size_t>(k0 + n) * E + e0 + 4 * c, kr[it]);
      }
    };
    auto store_k = [&](int buf) {
      float* hi = ks + buf * NB * L::KOP;
#pragma unroll
      for (int it = 0; it < KU; ++it) {
        int n, c;
        k_chunk(it, n, c);
        put_split<EXACT>(hi, hi + (NB - 1) * L::KOP, c * BK + n, kr[it]);
      }
    };
    // V unit `it` of this thread: keys 8 oct .. 8 oct + 7 of column col
    // (a warp reads 32 neighbouring columns of a key, and writes 32
    // neighbouring chunks); the split's chunk (col, pc) at pc·FC + col
    // holds keys 8 (pc / 2) + 2 p + (pc & 1), p = 0..3
    auto load_v = [&](int i) {
      const int k0 = (t_begin + i) * BK;
#pragma unroll
      for (int it = 0; it < VU; ++it) {
        const int u = st + it * 128, col = u % FC, oct = u / FC;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int key = k0 + 8 * oct + r;
          vr[it][r] =
              key < m ? to_f(vb[static_cast<size_t>(key) * F + f0 + col])
                      : 0.f;
        }
      }
    };
    auto store_v = [&](int buf) {
      float* hi = vs + buf * NB * L::VOP;
#pragma unroll
      for (int it = 0; it < VU; ++it) {
        const int u = st + it * 128, col = u % FC, oct = u / FC;
#pragma unroll
        for (int par = 0; par < 2; ++par) {
          const float x[4] = {vr[it][par], vr[it][2 + par], vr[it][4 + par],
                              vr[it][6 + par]};
          put_split<EXACT>(hi, hi + (NB - 1) * L::VOP,
                           (2 * oct + par) * FC + col, x);
        }
      }
    };
    if (n_tiles > 0) {
      load_k(0);
      load_v(0);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int b = i % NBUF, u = i / NBUF;
      if (i >= NBUF) mbar_wait(&bar[KE + b], (u - 1) & 1);
      store_k(b);
      fence_async_smem();
      mbar_arrive(&bar[KF + b]);
      if (i + 1 < n_tiles) load_k(i + 1);
      if (i >= NBUF) mbar_wait(&bar[VE + b], (u - 1) & 1);
      store_v(b);
      fence_async_smem();
      mbar_arrive(&bar[VF + b]);
      if (i + 1 < n_tiles) load_v(i + 1);
    }
    cluster_sync();  // the end of the block (below)
    return;
  }

  // the consumer: the peers' slots for this block's scores and their
  // score barriers
  uint32_t peer_xs[C - 1], peer_bar[C - 1];
#pragma unroll
  for (int j = 0; j < C - 1; ++j) {
    const int pr = j < rank ? j : j + 1;
    const int at = rank < pr ? rank : rank - 1;  // this block at the peer
    peer_xs[j] = peer_addr(xs + at * L::XOP + tid * SW, pr);
    peer_bar[j] = peer_addr(&bar[XB], pr);
  }
  int row[2], qpos[2];
  float m_i[2], l_i[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = warp * 16 + g + 8 * h;
    qpos[h] = (r0 + row[h]) / group + q_offset;
    m_i[h] = NEG_INF;
    l_i[h] = 0.f;
  }
  float acc[FC / 2];
#pragma unroll
  for (int x = 0; x < FC / 2; ++x) acc[x] = 0.f;
  const float4* qfrag = reinterpret_cast<const float4*>(qf) + tid;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_begin + i) * BK;
    const int buf = i % NBUF;  // in its (i / NBUF)-th use
    mbar_wait(&bar[KF + buf], (i / NBUF) & 1);
    const uint64_t dk =
        opaque(gmma_desc(ks + buf * NB * L::KOP, BK * 16, 128));
    uint64_t dq = 0;  // Q's split (QS)
    if constexpr (QS) dq = opaque(gmma_desc(qf, BQ * 16, 128));

    // BQK (Eq. 42), this block's columns: partials of KDEPTH k-steps, in
    // commit groups of KB k-steps, NF of them in flight; a group's Q
    // fragments are loaded and split before the wait for the group NF - 1
    // back.  s = ((0 + p0) + p1) + ...
    float s[SW], part[2][SW];
    uint32_t qh[NF + 1][KB][4], ql[NF + 1][KB][4];
    // group bt's Q fragments into buffer hb, split
    auto frags = [&](int bt, int hb) {
      if constexpr (QS) return;
#pragma unroll
      for (int kq = 0; kq < KB; ++kq) {
        if (bt * KB + kq >= KSTEPS) continue;
        const float4 x = qfrag[(bt * KB + kq) * 128];
        const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (EXACT) {
            qh[hb][kq][r] = __float_as_uint(xv[r]);
            ql[hb][kq][r] = 0u;
          } else {
            split(xv[r], qh[hb][kq][r], ql[hb][kq][r]);
          }
        }
      }
    };
    // group g is done: its fragments may go, and its partial, if g ends
    // it, joins s
    auto retire = [&](int g) {
      if constexpr (!QS) {
        fence_frag(qh[g % (NF + 1)]);
        fence_frag(ql[g % (NF + 1)]);
      }
      if (((g + 1) * KB) % KDEPTH == 0 || g == NG - 1) {
        const int pb = (g * KB / KDEPTH) & 1;
        fence_regs(part[pb]);
#pragma unroll
        for (int x = 0; x < SW; ++x) s[x] += part[pb][x];
      }
    };
#pragma unroll
    for (int x = 0; x < SW; ++x) s[x] = 0.f;
    frags(0, 0);
#pragma unroll
    for (int bt = 0; bt < NG; ++bt) {
      const int hb = bt % (NF + 1), pb = (bt * KB / KDEPTH) & 1;
      if (bt * KB % KDEPTH == 0)
#pragma unroll
        for (int x = 0; x < SW; ++x) part[pb][x] = 0.f;
      fence_regs(part[pb]);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < KB; ++kq) {
        if (bt * KB + kq >= KSTEPS) continue;
        const uint64_t dkh = desc_at(dk, 8 * (bt * KB + kq) * BK);
        if constexpr (QS) {
          const uint64_t dqh = desc_at(dq, 8 * (bt * KB + kq) * BQ);
          if constexpr (!EXACT) {
            wgmma_ss(part[pb], desc_at(dqh, L::QOP), dkh);
            wgmma_ss(part[pb], dqh, desc_at(dkh, L::KOP));
          }
          wgmma_ss(part[pb], dqh, dkh);
        } else {
          if constexpr (!EXACT) {
            wgmma_rs(part[pb], ql[hb][kq], dkh);
            wgmma_rs(part[pb], qh[hb][kq], desc_at(dkh, L::KOP));
          }
          wgmma_rs(part[pb], qh[hb][kq], dkh);
        }
      }
      wgmma_commit();
      // the next group's fragments, into the buffer of group bt + 1 - NF
      // (done)
      if (bt + 1 < NG) frags(bt + 1, (bt + 1) % (NF + 1));
      if (bt >= NF - 1) {
        wgmma_wait<NF - 1>();
        retire(bt - NF + 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int g = NG - NF + 1 > 0 ? NG - NF + 1 : 0; g < NG; ++g) retire(g);
    mbar_arrive(&bar[KE + buf]);  // this K split may be refilled

    // the scores of the whole row: this block's partial to each peer
    // (a warp's stores, then one arrive of the warp, which releases them),
    // the peers' from this block's slots, summed in rank order
    const int xp = i & 1;
#pragma unroll
    for (int j = 0; j < C - 1; ++j) {
      const uint32_t dst = peer_xs[j] + xp * (C - 1) * L::XOP * 4;
#pragma unroll
      for (int x = 0; x < SW; x += 4)
        st_peer4(dst + 4 * x, s[x], s[x + 1], s[x + 2], s[x + 3]);
    }
    __syncwarp();
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < C - 1; ++j) mbar_arrive_peer(peer_bar[j] + 8 * xp);
    mbar_wait_cluster(&bar[XB + xp], (i >> 1) & 1);
    {
      const float* got = xs + xp * (C - 1) * L::XOP + tid * SW;
      float by_rank[C][SW];
#pragma unroll
      for (int r = 0; r < C; ++r)
#pragma unroll
        for (int x = 0; x < SW; ++x)
          by_rank[r][x] = r == rank ? s[x]
                                    : got[(r < rank ? r : r - 1) * L::XOP + x];
#pragma unroll
      for (int x = 0; x < SW; ++x) {
        if constexpr (C == 2)
          s[x] = by_rank[0][x] + by_rank[1][x];
        else
          s[x] = (by_rank[0][x] + by_rank[1][x]) +
                 (by_rank[2][x] + by_rank[3][x]);
      }
    }

    // masks, LM/RM (Eqs. 43-44): s[4j + x] holds row row[x >> 1], key
    // k0 + 8j + 2 t4 + (x & 1); the quad holds a row
    const bool full =
        k0 + BK <= m_valid && (!causal || k0 + BK - 1 <= q_lo) &&
        (window <= 0 || k0 > q_hi - window);
    float lm[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NSB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int h = x >> 1;
        const int kpos = k0 + j * 8 + 2 * t4 + (x & 1);
        float sx = s[4 * j + x] * scale;
        if (softcap > 0.f) sx = softcap * tanhf(sx / softcap);
        if (!full) {
          bool ok = kpos < m_valid;
          if (causal) ok = ok && kpos <= qpos[h];
          if (window > 0) ok = ok && kpos > qpos[h] - window;
          sx = ok ? sx : NEG_INF;
        }
        s[4 * j + x] = sx;
        lm[h] = fmaxf(lm[h], sx);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        lm[h] = fmaxf(lm[h], __shfl_xor_sync(0xffffffffu, lm[h], off));

    // SLN/SLD, PRM/RD (Eqs. 45-46, 48-50)
    float prm[2], sld[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m_i[h], lm[h]);
      prm[h] = fexp<MACCS>(m_i[h] - mn);
      m_i[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < NSB; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int h = x >> 1;
        float p = fexp<MACCS>(s[4 * j + x] - m_i[h]);
        if (!full && k0 + j * 8 + 2 * t4 + (x & 1) >= m) p = 0.f;
        s[4 * j + x] = p;
        sld[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_i[h] = l_i[h] * prm[h] + sld[h];
    // a warp rescales its accumulators only where a row's running max
    // moved: else every factor is exactly 1 (the same bits)
    if (!__all_sync(0xffffffffu, prm[0] == 1.f && prm[1] == 1.f))
#pragma unroll
      for (int x = 0; x < FC / 2; ++x) acc[x] *= prm[(x >> 1) & 1];

    // SLNV / RNV (Eqs. 47, 51-52), this block's columns: k-step j's A
    // fragment takes key 8j + 2t as k index t and 8j + 2t + 1 as t + 4
    // (the split of Vᵀ permuted its keys to match)
    uint32_t ph[NSB][4], pl[NSB][4];
#pragma unroll
    for (int j = 0; j < NSB; ++j) {
      split(s[4 * j + 0], ph[j][0], pl[j][0]);
      split(s[4 * j + 2], ph[j][1], pl[j][1]);
      split(s[4 * j + 1], ph[j][2], pl[j][2]);
      split(s[4 * j + 3], ph[j][3], pl[j][3]);
    }
    fence_regs(acc);
    mbar_wait(&bar[VF + buf], (i / NBUF) & 1);
    const uint64_t dv =
        opaque(gmma_desc(vs + buf * NB * L::VOP, FC * 16, 128));
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NSB; ++j) {
      const uint64_t dvh = desc_at(dv, 8 * j * FC);
      wgmma_rs(acc, pl[j], dvh);
      if constexpr (!EXACT) wgmma_rs(acc, ph[j], desc_at(dvh, L::VOP));
      wgmma_rs(acc, ph[j], dvh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_frag(ph);
    fence_frag(pl);
    fence_regs(acc);
    mbar_arrive(&bar[VE + buf]);  // this Vᵀ split may be refilled
  }

  // RD of the whole row over the quad; AV (Eq. 53) on this block's
  // columns, and block 0 writes the LSE
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], off);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= rows) continue;
    const float d = l_i[h] == 0.f ? 1.f : l_i[h];
    if (lse != nullptr && t4 == 0 && rank == 0)
      lse[static_cast<size_t>(bh) * pg + r0 + row[h]] = m_i[h] + logf(d);
    T* orow = o + (static_cast<size_t>(bh) * pg + r0 + row[h]) * F + f0 +
              2 * t4;
#pragma unroll
    for (int n = 0; n < FC / 8; ++n) {
      orow[n * 8] = from_f<T>(acc[4 * n + 2 * h] / d);
      orow[n * 8 + 1] = from_f<T>(acc[4 * n + 2 * h + 1] / d);
    }
  }
  cluster_sync();  // no block exits while a peer may still write into it
}

// The launch of a cluster plan: C consecutive blocks on grid.x form a
// cluster (cudaLaunchAttributeClusterDimension), which shares a 64-row
// block.
template <typename T, int E, int F, int C, bool MACCS>
cudaError_t cluster_config(const Args& a, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  using L = ClLayout<T, E, F, C>;
  cudaError_t err = cudaFuncSetAttribute(
      fusemax_prefill_cluster_kernel<T, E, F, C, MACCS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((a.pg + L::BQ - 1) / L::BQ * C, a.bh);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = a.stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int E, int F, int C, bool MACCS>
cudaError_t launch_cluster(const Args& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T, E, F, C, MACCS>(a, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(
      &cfg, fusemax_prefill_cluster_kernel<T, E, F, C, MACCS>,
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.pg, a.m,
      a.scale, a.causal, a.window, a.softcap, a.q_offset, a.group,
      a.m_valid);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int E, int F, int C>
cudaError_t launch_cluster_exp(const Args& a) {
  return a.maccs ? launch_cluster<T, E, F, C, true>(a)
                 : launch_cluster<T, E, F, C, false>(a);
}

// cudaOccupancyMaxActiveClusters of a cluster plan (native exp): how many
// of its clusters the card holds at once
template <typename T, int E, int F, int C>
cudaError_t max_active_clusters(int* clusters) {
  Args a{};
  a.pg = 64;
  a.bh = 1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<T, E, F, C, false>(a, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      clusters, fusemax_prefill_cluster_kernel<T, E, F, C, false>, &cfg);
}

// dispatch_plan's case of a cluster plan (E, F, BQ, C): cluster_source
// expands it over REPRO_CLUSTER_PLANS there
#define REPRO_LAUNCH_CLUSTER(E, F, BQ, C)                                     \
  if (e == E && f == F && block_q == BQ && f_split == C)                      \
    return launch_cluster_exp<T, E, F, C>(a);

// ---- the C entry (cluster_source appends it to the source) -------------

// The clusters of the cluster plan (block_q, f_split = C) at head dims
// (e, f) for `dtype` that the card holds at once
// (cudaOccupancyMaxActiveClusters: a cluster's blocks share one GPC, so
// SMs a GPC cannot pair stay idle); cudaErrorInvalidValue for a plan that
// is not a cluster plan.
extern "C" int fusemax_prefill_max_active_clusters(int dtype, int e, int f,
                                                   int block_q, int f_split,
                                                   int* clusters) {
#define REPRO_CLUSTERS(E, F, BQ, C)                                           \
  if (e == E && f == F && block_q == BQ && f_split == C)                      \
    return static_cast<int>(                                                  \
        dtype == 0 ? max_active_clusters<float, E, F, C>(clusters)            \
                   : max_active_clusters<__nv_bfloat16, E, F, C>(clusters));
  if (dtype == 0 || dtype == 1) {
    REPRO_CLUSTER_PLANS(REPRO_CLUSTERS)
  }
#undef REPRO_CLUSTERS
  return static_cast<int>(cudaErrorInvalidValue);
}
