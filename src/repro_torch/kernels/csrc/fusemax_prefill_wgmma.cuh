// K1's Hopper body at the GQA head dims (64, 64) and (128, 128), gemma's
// (256, 256), DeepSeek's MLA prefill (192, 128) and the smoke configs'
// (32, 32) and (48, 32): `wgmma` in error-compensated 3xTF32, fed by
// asynchronous bulk copies.  (DeepSeek's absorbed (576, 512) runs the
// mma.sync body of fusemax_prefill.cu; the thread-block cluster body that
// benchmarks/torch_k1_variants.py builds for it as a variant uses this
// file's helpers.)
//
// Replaces, at those dims, the `mma.sync` body of fusemax_prefill.cu
// (both port src/repro/kernels/fusemax.py:_fusemax_kernel, called at
// :243); it computes the same function: Cascade 5 / Mapping 1 with
// deferred division, causal / window / softcap / q_offset / m_valid,
// native or MACC exp, the optional log-sum-exp output, the finite
// NEG_INF, the Pallas tile-run rule as loop bounds, heaviest query tiles
// first and the l = 0 -> 1 guard.
//
// What bounds it: operations, as the mma.sync body: 3 x the FLOPs of the
// two products over 495 TFLOP/s of dense TF32 (a bare `wgmma` m64n128k8
// .tf32 loop reaches 486-492 TFLOP/s on an H100 SXM; `mma.sync` 318-321).
//
// What the design does about it:
// * One warpgroup holds 64 query rows; both products are `wgmma` m64nNk8
//   .tf32, the only instruction that reaches the card's TF32 rate.  Q·Kᵀ
//   reads Q and the K tile from shared memory; P·V takes P from the
//   score accumulators' registers and Vᵀ from shared memory.  3xTF32 is
//   lo·hi + hi·lo + hi·hi, small terms first (tf32x3.cuh's split); bf16
//   inputs have lo = 0 and skip those products.
// * Each operand is split once per block: Q once for the whole sweep, a
//   K and a V tile once per tile (the mma.sync body splits every
//   fragment once per warp that loads it), into hi and lo buffers in the
//   canonical K-major layout that `wgmma`'s shared-memory descriptors
//   read without swizzle: 8-row x 16-byte core matrices, a tile's 16-byte
//   column chunks [n][4] one after another.  `.tf32` takes only K-major
//   operands, so the split writes V transposed; within each 8 keys it
//   permutes them (key 2t -> k index t, 2t + 1 -> t + 4), the order in
//   which the score accumulator's columns {2t, 2t + 1} feed the A
//   fragment's {t, t + 4}.
// * A tile's raw K rows and raw V rows (contiguous in memory) arrive by
//   one `cp.async.bulk` each, completed by `mbarrier` transaction counts.
//   A bulk copy does not zero-fill: keys >= m are not copied, and the
//   split writes zeros for them (the plain version has no such keys).
// * At E >= 128 one block fills an SM's shared memory, so a second
//   warpgroup (the splitter) does the loads and splits while the first
//   runs the products and the softmax, handing buffers over by full /
//   empty mbarriers, and loads the next raw tile as soon as it has split
//   one.  Two warpgroups of 255 registers fit the SM's 65,536, so the
//   consumer needs no `setmaxnreg` to hold P·V's 128 accumulators a
//   thread at F = 256.  At E = 64 two blocks share an SM and each
//   warpgroup splits the next tile between its own products.
// * The key tile and the split buffers are set per (E, F) (WgTile): at
//   (64, 64) and (128, 128) 32-key tiles whose K and Vᵀ splits are
//   double-buffered (the next tile's is written while the tensor cores
//   read this one's).  Q's split fills half the block at E = 256 (128
//   KB), so gemma's dims take 16-key tiles and one K and one Vᵀ split:
//   the splitter writes tile i + 1's K split while tile i's softmax and
//   P·V run, and its Vᵀ split while tile i + 1's Q·Kᵀ runs.  The smoke
//   dims take the GQA dims' tile: at E = 48 and 32 one warpgroup splits
//   between its products, and three blocks share an SM.  (192, 128)
//   takes 32-key tiles the same way, which doubles Q·Kᵀ's N against
//   double-buffered 16-key tiles: the A operand (Q) is read from shared
//   memory once per `wgmma`, so a narrow N leaves the product waiting on
//   shared memory.
// * P·V's accumulators are rescaled only in a warp where a row's running
//   max moved (a factor of exactly 1 changes no bit): at F = 256 the
//   rescale of 128 accumulators a thread on every 16-key tile took
//   gemma2-9b's prefill from 27.0 ms on the mma.sync body to 38.9 ms, and
//   skipping it where it is 1 to 21.4 (H100 SXM, variants bench).
// * The tensor cores' fp32 accumulation truncates, so a score partial
//   takes at most KDEPTH k-steps (KDEPTH chained `wgmma` per product) in
//   its own registers before it is added in IEEE fp32; the partials'
//   chains are issued interleaved, all in flight at once.  P·V
//   accumulates directly, as the mma.sync body does.  The descriptors
//   are derived, where they are used, from bases the compiler may not
//   hoist out of the tile loop (at E = 256 the Q descriptors alone would
//   take 128 registers).
// * One key tile per (E, F), the same under every plan, so a row's fp32
//   result does not depend on the call's plan (a serving quantum's rows
//   equal the same rows of a whole-prompt call: 0.0 on the card).  A
//   short chunk splits the F output columns over two blocks (FS 2), each
//   with its rows' scores.
//
// Shared memory of one block (fp32; WgLayout, the same formula as
// autotune.prefill_smem_bytes): Q, K and Vᵀ hi and lo, 2 x (64 E + NBUF
// x BK E + NBUF x BK F / FS) floats, a raw K and a raw V tile, BK x (E +
// F) floats, 10 mbarriers; bf16 has raw tiles in bf16 and no lo:
//   (128, 128) BK 32 NBUF 2 FS 1: 229,456 B; FS 2: 196,688 B (1 an SM)
//   (64, 64)   BK 32 NBUF 2 FS 1: 114,768 B; FS 2:  98,384 B (2 an SM)
//   (256, 256) BK 16 NBUF 1 FS 1: 229,456 B
//   (192, 128) BK 32 NBUF 1 FS 1: 221,264 B
//   (48, 32)   BK 32 NBUF 2 FS 1:  75,856 B (3 an SM)
//   (32, 32)   BK 32 NBUF 2 FS 1:  57,424 B (3 an SM)

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "prefill_softmax.cuh"
#include "tf32x3.cuh"

namespace {

// ---- wgmma, its descriptors and fences ---------------------------------

// A shared-memory matrix descriptor, K-major, no swizzle: core matrices
// of 8 rows x 16 bytes, `lbo` bytes between the two core matrices of a
// k-step (K direction), `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// across an asynchronous wgmma's issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 8, fp32) += A (64 x 8) · B (8 x 8)ᵀ, both from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 16, fp32) += A (64 x 8) · B (16 x 8)ᵀ, both from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 8) · B (32 x 8)ᵀ, both from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 8, registers) · B (32 x 8)ᵀ (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d (64 x 64, fp32) += A (64 x 8, registers) · B (64 x 8)ᵀ (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d (64 x 128, fp32) += A (64 x 8, registers) · B (128 x 8)ᵀ (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45,"
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56,"
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d (64 x 256, fp32) += A (64 x 8, registers) · B (256 x 8)ᵀ (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// ---- mbarriers and bulk copies -----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the 128 threads of warpgroup 1 (the splitter) wait for one another
__device__ __forceinline__ void splitter_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
// `bytes` (a multiple of 16) global -> shared, both 16-byte aligned; the
// copy's completion counts against `bar`'s transaction bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// orders this thread's shared-memory writes before later reads by the
// async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the body ----------------------------------------------------------

// The key tile of each (E, F): BK keys a tile, NBUF split buffers each
// of K and of Vᵀ (2: the next tile's split is written while the tensor
// cores read this one's; 1 where two do not fit beside Q's split)
template <int E, int F> struct WgTile {
  static constexpr int BK = 32, NBUF = 2;
};
template <> struct WgTile<256, 256> {
  static constexpr int BK = 16, NBUF = 1;
};
template <> struct WgTile<192, 128> {
  static constexpr int BK = 32, NBUF = 1;
};

template <typename T, int E, int F, int FS> struct WgLayout {
  // WS: a second warpgroup splits the K and V tiles while the first runs
  // the products and the softmax (at E >= 128, where one block fills an
  // SM's shared memory); else the one warpgroup splits between them and
  // two blocks share an SM
  static constexpr bool WS = E >= 128;
  static constexpr int BQ = 64, BK = WgTile<E, F>::BK,
                       NBUF = WgTile<E, F>::NBUF, FC = F / FS,
                       NT = WS ? 256 : 128;
  static constexpr bool EXACT = sizeof(T) == 2;  // bf16: lo = 0
  static constexpr int NB = EXACT ? 1 : 2;       // split buffers: hi (, lo)
  // raw tiles: BK whole K rows and BK whole V rows (a column block
  // splits its FC columns of them), each one bulk copy
  static constexpr int RAWK = BK * E, RAWV = BK * F;
  static constexpr int RAW_BYTES =
      (RAWK + RAWV) * static_cast<int>(sizeof(T));
  static constexpr int QOP = BQ * E, KOP = BK * E, VOP = FC * BK;  // floats
  // Q's split, NBUF of K's and NBUF of Vᵀ's, and 10 mbarriers: raw K and
  // V landed, and with WS each split buffer's full and empty
  static constexpr int BYTES =
      RAW_BYTES + 4 * NB * (QOP + NBUF * KOP + NBUF * VOP) + 80;
  static_assert(E % 8 == 0 && F % FS == 0 &&
                    (FC * static_cast<int>(sizeof(T))) % 16 == 0 &&
                    (FC == 32 || FC == 64 || FC == 128 || FC == 256) &&
                    (BK == 8 || BK == 16 || BK == 32) &&
                    (NBUF == 2 || (NBUF == 1 && WS)),
                "wgmma tile shapes");
  static_assert(BYTES <= 232448, "the tiles exceed one block's shared memory");
};

// The descriptor of the operand `floats` (a multiple of 4) past the one
// `d` describes: the start address field counts 16-byte units.
__device__ __forceinline__ uint64_t desc_at(uint64_t d, int floats) {
  return d + static_cast<uint64_t>(floats >> 2);
}
// `x`, which the compiler must take as new where this is called: the
// descriptors derived from it are then computed where they are used, not
// hoisted out of the tile loop into registers the accumulators need
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&x)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16), x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16), x[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Write 4 values' hi (and lo) as one 16-byte chunk at chunk index `at`
// of the hi / lo buffers.
template <bool EXACT>
__device__ __forceinline__ void put_split(float* hi, float* lo, int at,
                                          const float (&x)[4]) {
  uint4 h, l;
  if constexpr (EXACT) {
    h = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                   __float_as_uint(x[2]), __float_as_uint(x[3]));
  } else {
    split(x[0], h.x, l.x);
    split(x[1], h.y, l.y);
    split(x[2], h.z, l.z);
    split(x[3], h.w, l.w);
    reinterpret_cast<uint4*>(lo)[at] = l;
  }
  reinterpret_cast<uint4*>(hi)[at] = h;
}

template <typename T, int E, int F, int FS, bool MACCS>
__global__ void __launch_bounds__(WgLayout<T, E, F, FS>::NT)
fusemax_prefill_wgmma_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             float* __restrict__ lse, int pg, int m,
                             float scale, int causal, int window,
                             float softcap, int q_offset, int group,
                             int m_valid) {
  using L = WgLayout<T, E, F, FS>;
  constexpr int BQ = L::BQ, BK = L::BK, FC = L::FC, NB = L::NB;
  constexpr int NBUF = L::NBUF;
  constexpr bool EXACT = L::EXACT, WS = L::WS;
  constexpr int NSB = BK / 8;        // score n-blocks (and P·V k-steps)
  constexpr int KSTEPS = E / 8;      // Q·Kᵀ k-steps
  constexpr int NPART = (KSTEPS + KDEPTH - 1) / KDEPTH;  // score partials

  extern __shared__ __align__(128) unsigned char wg_smem[];
  T* rk = reinterpret_cast<T*>(wg_smem);       // raw K tile [BK][E]
  T* rv = rk + L::RAWK;                        // raw V tile [BK][F]
  float* qh = reinterpret_cast<float*>(wg_smem + L::RAW_BYTES);
  float* ql = qh + (NB - 1) * L::QOP;          // = qh for bf16
  float* ks = qh + NB * L::QOP;                // K splits [NBUF][NB][KOP]
  float* vs = ks + NBUF * NB * L::KOP;         // Vᵀ splits [NBUF][NB][VOP]
  // raw K / V landed; with WS: K / V split b full (2 + b / 4 + b), empty
  // (6 + b / 8 + b)
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + NBUF * NB * L::VOP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int cb = blockIdx.x % FS;
  const int r0 = (gridDim.x / FS - 1 - blockIdx.x / FS) * BQ;
  const int f0 = cb * FC;
  const int bh = blockIdx.y;
  const int rows = min(BQ, pg - r0);
  const T* qb = q + (static_cast<size_t>(bh) * pg + r0) * E;
  const T* kb = k + static_cast<size_t>(bh) * m * E;

  const int q_lo = r0 / group + q_offset;
  const int q_hi = (r0 + rows - 1) / group + q_offset;
  const int kstart = window > 0 ? max(0, q_lo - window + 1) : 0;
  int kend = m_valid;
  if (causal) kend = min(kend, q_hi + 1);
  const int t_begin = kstart / BK;
  const int t_end = kend > 0 ? (kend + BK - 1) / BK : 0;
  const int n_tiles = max(0, t_end - t_begin);

  if (tid == 0) {
    mbar_init(&bar[0], 1);  // raw K tile landed
    mbar_init(&bar[1], 1);  // raw V tile landed
    if constexpr (WS)
      for (int b = 2; b < 10; ++b) mbar_init(&bar[b], 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The raw rows of tile i (K, or V: contiguous in memory), one bulk
  // copy issued by the thread `st` = 0 of the splitting warpgroup; the
  // k-th tile completes phase k of its barrier.
  auto load = [&](int i, bool is_v, int st) {
    if (st != 0 || i >= n_tiles) return;
    const int k0 = (t_begin + i) * BK;
    const uint32_t bytes = min(BK, m - k0) * (is_v ? F : E) * sizeof(T);
    uint64_t* b = &bar[is_v];
    mbar_expect_tx(b, bytes);
    if (is_v)
      bulk_copy(rv, v + (static_cast<size_t>(bh) * m + k0) * F, bytes, b);
    else
      bulk_copy(rk, kb + static_cast<size_t>(k0) * E, bytes, b);
  };
  // Split tile i's K into buffer `buf` (thread `st` of 128): chunk (n, c)
  // of 4 columns at c·BK + n; keys >= m (not copied) are zeros.  Thread
  // j takes row j % BK and chunk (j / BK + j % BK) mod E/4: 8 neighbours
  // read 8 rows at 8 chunk offsets and write 8 consecutive chunks, both
  // free of bank conflicts.
  auto split_k = [&](int i, int buf, int st) {
    const int k0 = (t_begin + i) * BK;
    mbar_wait(&bar[0], i & 1);
    float* hi = ks + buf * NB * L::KOP;
    static_assert(BK * E / 4 % 128 == 0 && FC * BK / 4 % 128 == 0,
                  "split loops");
#pragma unroll
    for (int it = 0; it < BK * E / 4 / 128; ++it) {
      const int j = st + it * 128;
      const int n = j % BK, c = (j / BK + n) % (E / 4);
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + n < m) load4<T>(rk + n * E + 4 * c, x);
      put_split<EXACT>(hi, hi + (NB - 1) * L::KOP, c * BK + n, x);
    }
  };
  // Split tile i's V transposed into buffer `buf`: chunk (col, pc) at
  // pc·FC + col holds keys 8 (pc / 2) + 2 p + (pc & 1), p = 0..3.
  auto split_v = [&](int i, int buf, int st) {
    const int k0 = (t_begin + i) * BK;
    mbar_wait(&bar[1], i & 1);
    float* hi = vs + buf * NB * L::VOP;
#pragma unroll
    for (int it = 0; it < FC * BK / 4 / 128; ++it) {
      const int j = st + it * 128;
      const int col = j % FC, pc = j / FC;
      const int key0 = 8 * (pc >> 1) + (pc & 1);
      float x[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int key = key0 + 2 * p;
        x[p] = k0 + key < m ? to_f(rv[key * F + f0 + col]) : 0.f;
      }
      put_split<EXACT>(hi, hi + (NB - 1) * L::VOP, j, x);
    }
  };

  load(0, false, tid);
  load(0, true, tid);
  // Q, split once for the sweep: chunk (r, c) of 4 columns at c·BQ + r
  for (int i = tid; i < BQ * E / 4; i += L::NT) {
    const int r = i % BQ, c = i / BQ;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows) load4<T>(qb + static_cast<size_t>(r) * E + 4 * c, x);
    put_split<EXACT>(qh, ql, i, x);
  }
  if constexpr (WS) {
    fence_async_smem();
    __syncthreads();  // Q's split visible to wgmma
    if (warp >= 4) {
      // the splitter: tile i's K and V into buffer i % NBUF once the
      // products of tile i - NBUF are done with it, then the next raw
      // tile; buffer b's u-th filling completes phase u of its barriers
      const int st = tid - 128;
      for (int i = 0; i < n_tiles; ++i) {
        const int b = i % NBUF, u = i / NBUF;
        if (i >= NBUF) mbar_wait(&bar[6 + b], (u - 1) & 1);
        split_k(i, b, st);
        fence_async_smem();
        mbar_arrive(&bar[2 + b]);
        splitter_sync();  // every splitter thread is done with raw K
        load(i + 1, false, st);
        if (i >= NBUF) mbar_wait(&bar[8 + b], (u - 1) & 1);
        split_v(i, b, st);
        fence_async_smem();
        mbar_arrive(&bar[4 + b]);
        splitter_sync();
        load(i + 1, true, st);
      }
      return;
    }
  } else {
    if (n_tiles > 0) {
      split_k(0, 0, tid);
      split_v(0, 0, tid);
    }
    fence_async_smem();
    __syncthreads();  // splits visible to wgmma; the raw tiles are free
    load(1, false, tid);
    load(1, true, tid);
  }

  // this thread's rows of the warpgroup's accumulators
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

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_begin + i) * BK;
    const int buf = i % NBUF;  // in its (i / NBUF)-th use
    if constexpr (WS) mbar_wait(&bar[2 + buf], (i / NBUF) & 1);
    // descriptors of the tile's operands at k-step 0 (hi; lo follows)
    const uint64_t dq = opaque(gmma_desc(qh, BQ * 16, 128));
    const uint64_t dk =
        opaque(gmma_desc(ks + buf * NB * L::KOP, BK * 16, 128));
    const uint64_t dv =
        opaque(gmma_desc(vs + buf * NB * L::VOP, FC * 16, 128));

    // BQK (Eq. 42): every partial of KDEPTH k-steps in flight at once
    float part[NPART][BK / 2];
#pragma unroll
    for (int pp = 0; pp < NPART; ++pp) {
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) part[pp][x] = 0.f;
      fence_regs(part[pp]);
    }
    wgmma_fence();
    // the partials' chains interleaved: each wgmma accumulates into
    // another partial than the one before it
#pragma unroll
    for (int kq = 0; kq < KDEPTH; ++kq)
#pragma unroll
      for (int pp = 0; pp < NPART; ++pp) {
        const int kk = pp * KDEPTH + kq;
        if (kk >= KSTEPS) continue;
        const uint64_t dqh = desc_at(dq, 8 * kk * BQ);
        const uint64_t dkh = desc_at(dk, 8 * kk * BK);
        if constexpr (!EXACT) {
          wgmma_ss(part[pp], desc_at(dqh, L::QOP), dkh);
          wgmma_ss(part[pp], dqh, desc_at(dkh, L::KOP));
        }
        wgmma_ss(part[pp], dqh, dkh);
      }
    wgmma_commit();
    if constexpr (WS) {
      wgmma_wait0();
      mbar_arrive(&bar[6 + buf]);  // this K split may be refilled
    } else {
      // meanwhile: the next tile's K split, then its raw K load
      if (i + 1 < n_tiles) split_k(i + 1, (i + 1) % NBUF, tid);
      fence_async_smem();
      __syncthreads();
      load(i + 2, false, tid);
      wgmma_wait0();
    }
    float s[BK / 2];
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) s[x] = 0.f;
#pragma unroll
    for (int pp = 0; pp < NPART; ++pp) {
      fence_regs(part[pp]);
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) s[x] += part[pp][x];
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

    // SLNV / RNV (Eqs. 47, 51-52): k-step j's A fragment takes key
    // 8j + 2t as k index t and 8j + 2t + 1 as t + 4 (the split of Vᵀ
    // permuted its keys to match)
    uint32_t ph[NSB][4], pl[NSB][4];
#pragma unroll
    for (int j = 0; j < NSB; ++j) {
      split(s[4 * j + 0], ph[j][0], pl[j][0]);
      split(s[4 * j + 2], ph[j][1], pl[j][1]);
      split(s[4 * j + 1], ph[j][2], pl[j][2]);
      split(s[4 * j + 3], ph[j][3], pl[j][3]);
    }
    fence_regs(acc);
    if constexpr (WS) mbar_wait(&bar[4 + buf], (i / NBUF) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NSB; ++j) {
      const uint64_t dvh = desc_at(dv, 8 * j * FC);
      wgmma_rs(acc, pl[j], dvh);
      if constexpr (!EXACT) wgmma_rs(acc, ph[j], desc_at(dvh, L::VOP));
      wgmma_rs(acc, ph[j], dvh);
    }
    wgmma_commit();
    if constexpr (WS) {
      wgmma_wait0();
      fence_regs(acc);
      mbar_arrive(&bar[8 + buf]);  // this Vᵀ split may be refilled
    } else {
      // meanwhile: the next tile's Vᵀ split, then its raw V load
      if (i + 1 < n_tiles) split_v(i + 1, (i + 1) % NBUF, tid);
      fence_async_smem();
      __syncthreads();
      load(i + 2, true, tid);
      wgmma_wait0();
      fence_regs(acc);
    }
  }

  // RD of the whole row over the quad; AV (Eq. 53) and the LSE
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], off);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= rows) continue;
    const float d = l_i[h] == 0.f ? 1.f : l_i[h];
    if (lse != nullptr && t4 == 0 && cb == 0)
      lse[static_cast<size_t>(bh) * pg + r0 + row[h]] = m_i[h] + logf(d);
    T* orow = o + (static_cast<size_t>(bh) * pg + r0 + row[h]) * F + f0 +
              2 * t4;
#pragma unroll
    for (int n = 0; n < FC / 8; ++n) {
      orow[n * 8] = from_f<T>(acc[4 * n + 2 * h] / d);
      orow[n * 8 + 1] = from_f<T>(acc[4 * n + 2 * h + 1] / d);
    }
  }
}

}  // namespace
