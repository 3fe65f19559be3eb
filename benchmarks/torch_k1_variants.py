"""K1's design choices, measured on the card.

    python benchmarks/torch_k1_variants.py [--out PATH] [VARIANT ...]
        [--shapes WORD ...]

Builds ``src/repro_torch/kernels/csrc/fusemax_prefill.cu`` as it ships
and in variants that each change one design choice (a textual edit of
the shipped source, which raises when the source no longer holds the
text it edits, or the shipped source launched under another plan), all
with ``nvcc`` in parallel into ``build/k1_variants/`` (each beside its
``-Xptxas -v`` report, ``<variant>.log``).  Then, fp32, on the CUDA
device:

* times every variant at the shapes ``chip_smoke.py`` times K1 at
  (granite-3-8b's prefill dispatch and one head shard of it at tp 2,
  serve_async's prefill quantum, stablelm-1.6b's training forward,
  hymba-1.5b's local and global layers, DeepSeek-V3's ``mla_forward`` and
  its absorbed tail, gemma2-9b's global and local layers, the smoke
  configs' (32, 32) and (48, 32) rows) and at two serving chunks whose
  default plan leaves 28-32 of the 132 SMs idle: CUDA events over 20
  launches after 3 (``ms``) and the device time of a launch from
  ``torch.profiler``'s kernel records (``device_ms``), in two rounds (the
  variants in order, then in reverse) so that a drift of the card shows,
  each row with the plan every variant ran and SDPA's times on the same
  inputs (``sdpa_ms``, ``sdpa_device_ms``; the masks without softcap);
* reports, for each variant that builds the cluster body, the clusters
  the card holds at once (``cudaOccupancyMaxActiveClusters``);
* holds, for every variant, the rows of a prompt's last quantum to the
  same rows of one whole-prompt call, bit for bit (``quantum_vs_chunk``:
  0.0 where a row's arithmetic does not depend on the plan), at
  ``QUANTUM_CASES``;
* runs every variant on stress inputs (scores in the hundreds, bits below
  TF32's mantissa that matter, a plain long sweep) and reports its
  largest distance to a float64 softmax-attention reference beside the
  plain fp32 version's (``fusemax_attention_torch``).

Variants:

* ``shipped``       — the source as it is, each call under its plan
  (``autotune.prefill_plan``);
* ``default_plan``  — the same library with every call under its (E, F)'s
  default plan (no column split);
* ``split2``        — every call at (64, 64) and (128, 128) in two column
  blocks, whatever the waves;
* ``split4``        — every call at (128, 128) in four column blocks (a
  plan compiled only here: 32 output columns a block);
* ``mma_sync``      — the ``wgmma`` body's dims routed back to the
  ``mma.sync`` body with the tiles it had there (``MMA_TILES``: 128 x 64
  at (64, 64), (128, 128), (192, 128), (32, 32) and (48, 32), 64 x 64 at
  (256, 256); one column block): the design that body replaced;
* ``cluster2``      — (576, 512) on the thread-block cluster body of
  this directory's ``fusemax_prefill_cluster.cuh``, which the port does
  not build (``cluster_source`` splices it in: two blocks a 64-row block,
  32-key tiles, one split buffer, Q raw and split into registers each
  k-step, Q·Kᵀ in commit groups of one k-step, three in flight), a plan
  compiled only here, against ``shipped``'s ``mma.sync`` body there;
* ``cluster2_kb2``  — the same with commit groups of two k-steps, two in
  flight;
* ``cluster2_bk16`` — the same on 16-key tiles (Q·Kᵀ as `wgmma`
  m64n16k8);
* ``cluster4``      — clusters of four blocks (E / 4 = 144 and F / 4 =
  128 columns a block, three peers' scores a tile);
* ``cluster4_nbuf2_kb4`` — clusters of four with two split buffers and
  commit groups of four k-steps, two in flight;
* ``cluster4_qsplit`` — clusters of four with Q split once into shared
  memory (its hi and lo, 73,728 B) and Q·Kᵀ reading A from there, which
  saves every k-step's split of Q; commit groups of four k-steps, two in
  flight (192,560 B a block);
* ``cluster4_qsplit_kb1`` — the same in commit groups of one k-step,
  three in flight;
* ``no_exchange``   — diagnostic, never shipped: ``cluster2`` without
  its score exchange's arrive and wait (each block reads whatever its
  slots hold: wrong outputs), for what the exchange costs;
* ``qk_only``       — diagnostic: ``cluster2`` without its P·V `wgmma`
  (wrong outputs);
* ``splitter_idle`` — diagnostic: ``cluster2``'s splitter hands over its
  buffers without loading or splitting a tile (wrong outputs);
* ``d256_bk8x2``    — (256, 256) on 8-key tiles with two K and two Vᵀ
  split buffers (213,072 B) instead of 16-key tiles with one (229,456 B);
* ``mla_bk16x2``    — (192, 128) on 16-key tiles with two split buffers
  (200,784 B) instead of 32-key tiles with one (221,264 B);
* ``rescale_always`` — the wgmma body rescales its accumulators on every
  key tile, also where every factor is exactly 1 (the same bits);
* ``cvt_split``     — hi and lo rounded by ``cvt.rna.tf32.f32`` instead of
  the same rounding on the integer pipe;
* ``trunc_lo``      — lo passed unrounded, so the tensor core drops its 13
  low bits (what CUTLASS's fast-fp32 operator does);
* ``kdepth8``       — score partials of 8 k-steps instead of 4;
* ``tf32_1x``       — single-pass TF32 (hi·hi only) in both bodies, for
  the accuracy and speed it gives up; never shipped.

(``rows16_p_regs`` and ``tile256_128x64`` edited the tile table's ``MT``
and ``BQ`` at the GQA dims, which the ``wgmma`` body took over; they are
retired.)

Beside them it measures the rate ``mma.sync.m16n8k8`` TF32 reaches on
this card with nothing else in the way (2 blocks of 8 warps a SM, 8
independent accumulators a warp, back-to-back mma): the ceiling of any
kernel built on that instruction; and the rate of ``wgmma`` m64nNk8
TF32 (two warpgroups a SM, operands in shared memory, 8 chained a commit
group) at N = 128 (P·V's) and at Q·Kᵀ's narrow 32 and 16: the ceilings
of a ``wgmma`` body's products, as against the 495 TFLOP/s it is rated
at.

Prints one JSON object per shape, per stress case and for the mma rate,
and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import os
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels import fusemax as fm  # noqa: E402
from repro_torch.model.layers import strict_fp32  # noqa: E402

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                   "fusemax_prefill.cu")
OUT_DIR = os.path.join(ROOT, "build", "k1_variants")


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the source no longer holds {old!r}")
    return src.replace(old, new)


#: the mma.sync body's tiles (BQ, BK, WF, MT, KC) at the dims the wgmma
#: body took from it: the GQA dims, gemma's, DeepSeek's MLA prefill, the
#: smoke configs' dims
MMA_TILES = {(64, 64): (128, 64, 1, 2, 64), (128, 128): (128, 64, 2, 2, 64),
             (192, 128): (128, 64, 2, 2, 64), (256, 256): (64, 64, 4, 2, 64),
             (32, 32): (128, 64, 1, 2, 32), (48, 32): (128, 64, 1, 2, 48)}
GQA_DIMS = ((64, 64), (128, 128))
WGMMA_DIMS = tuple(MMA_TILES)


def _plan_macro(src: str, name: str, keep) -> str:
    """``src`` with the plans of its ``#define name(X)`` (one line, or
    lines continued by backslashes) whose (E, F) do not pass ``keep``
    taken out."""
    head = f"#define {name}(X)"
    start = src.index(head)
    end = src.index("\n", start)
    while src[end - 1] == "\\":
        end = src.index("\n", end + 1)
    plans = re.findall(r"X\((\d+), (\d+)((?:, \d+)*)\)", src[start:end])
    kept = " ".join(f"X({e}, {f}{rest})" for e, f, rest in plans
                    if keep((int(e), int(f))))
    return src[:start] + f"{head} {kept}".rstrip() + src[end:]


def mma_sync_source(src: str, dims=WGMMA_DIMS, only: bool = False) -> str:
    """``src`` with ``dims`` routed back to the mma.sync body on the tiles
    it had there (no ``wgmma`` plan at them); with ``only``,
    those dims alone (a smaller library that builds faster).  It holds
    whatever ``REPRO_DIMS`` lists, or nothing."""
    anchor = "template <int E, int F> struct PrefillTile;\n"
    tiles = "".join(
        f"template <> struct PrefillTile<{e}, {f}> {{\n  static constexpr "
        f"int BQ = {bq}, BK = {bk}, WF = {wf}, MT = {mt}, KC = {kc};\n}};\n"
        for (e, f), (bq, bk, wf, mt, kc) in
        ((d, MMA_TILES[d]) for d in dims))
    src = _edit(src, anchor, anchor + tiles)
    for name in ("REPRO_DIMS", "REPRO_WGMMA_PLANS"):
        src = _plan_macro(src, name, lambda d: not only and d not in dims)
    listed = " ".join(f"X({e}, {f})" for e, f in dims)
    return _edit(src, "#define REPRO_DIMS(X)", f"#define REPRO_DIMS(X) {listed}")


#: the thread-block cluster body at (576, 512), which the port does not
#: build: :func:`cluster_source` splices it into the shipped source
CLUSTER_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fusemax_prefill_cluster.cuh")
CLUSTER_ENTRY = "// ---- the C entry"


def cluster_source(src: str, c: int = 2, bk: int = 32, nbuf: int = 1,
                   kb: int = 1, nf: int = 3, qs: bool = False) -> str:
    """``src`` (the shipped source, headers inlined) with the cluster body
    of ``fusemax_prefill_cluster.cuh`` compiled at (576, 512) in clusters
    of ``c`` blocks (the plan (64, c), which ``PLANS`` runs): its kernel
    and launchers spliced in before the instantiations, its case in
    ``dispatch_plan``, its ``fusemax_prefill_max_active_clusters`` entry
    at the end.  Its key tile is ``bk`` keys and ``nbuf`` split buffers,
    ``kb`` Q·Kᵀ k-steps a commit group and ``nf`` groups in flight, Q
    held raw and split into registers each k-step, or with ``qs`` split
    once into shared memory (the defaults: the candidate the cluster
    variants start from)."""
    with open(CLUSTER_SRC) as fh:
        text = fh.read()
    head = "template <> struct ClTile<576, 512> {"
    start = text.index(head)
    end = text.index("};", start)
    text = (text[:start] + head + f"\n  static constexpr int BK = {bk}, "
            f"NBUF = {nbuf}, KB = {kb}, NF = {nf}, QS = {int(qs)};\n"
            + text[end:])
    body_end = text.index(CLUSTER_ENTRY)
    body, entry = text[:body_end], text[body_end:]
    plans = f"#define REPRO_CLUSTER_PLANS(X) X(576, 512, 64, {c})\n"
    anchor = "// The instantiations."
    src = _edit(src, anchor, plans + body + anchor)
    src = _edit(src, "  REPRO_WGMMA_PLANS(REPRO_LAUNCH_WGMMA)\n",
                "  REPRO_CLUSTER_PLANS(REPRO_LAUNCH_CLUSTER)\n"
                "  REPRO_WGMMA_PLANS(REPRO_LAUNCH_WGMMA)\n")
    return src + "\n" + entry


def _edit_cluster(src: str, old: str, new: str) -> str:
    """``src`` with ``old`` replaced in the cluster body's kernel only."""
    at = src.index("fusemax_prefill_cluster_kernel(const T*")
    return src[:at] + _edit(src[at:], old, new)


def _wg_tile(src: str, e: int, f: int, bk: int, nbuf: int) -> str:
    """``src`` with the wgmma body's key tile at (E, F) set to ``bk`` keys
    and ``nbuf`` split buffers."""
    head = f"template <> struct WgTile<{e}, {f}> {{"
    start = src.index(head)
    end = src.index("};", start)
    return (src[:start] + head + f"\n  static constexpr int BK = {bk}, "
            f"NBUF = {nbuf};\n" + src[end:])


INT_TF32 = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
LO = "  lo = tf32(x - __uint_as_float(hi));"

VARIANTS = {
    "shipped": lambda s: s,
    "default_plan": lambda s: s,
    "split2": lambda s: s,
    "split4": lambda s: _edit(s, "X(128, 128, 64, 2)",
                              "X(128, 128, 64, 2) X(128, 128, 64, 4)"),
    "mma_sync": mma_sync_source,
    "d256_bk8x2": lambda s: _wg_tile(s, 256, 256, 8, 2),
    "mla_bk16x2": lambda s: _wg_tile(s, 192, 128, 16, 2),
    "cluster2": cluster_source,
    "cluster2_kb2": lambda s: cluster_source(s, kb=2, nf=2),
    "cluster2_bk16": lambda s: cluster_source(s, bk=16),
    "cluster4": lambda s: cluster_source(s, c=4),
    "cluster4_nbuf2_kb4": lambda s: cluster_source(s, 4, 32, 2, 4, 2),
    "cluster4_qsplit": lambda s: cluster_source(s, 4, 32, 1, 4, 2, qs=True),
    "cluster4_qsplit_kb1": lambda s: cluster_source(s, 4, 32, 1, 1, 3,
                                                    qs=True),
    "qk_only": lambda s: _edit_cluster(
        cluster_source(s), "      wgmma_rs(acc, pl[j], dvh);\n      if "
        "constexpr (!EXACT) wgmma_rs(acc, ph[j], desc_at(dvh, L::VOP));\n"
        "      wgmma_rs(acc, ph[j], dvh);\n", ""),
    "splitter_idle": lambda s: _edit_cluster(_edit_cluster(_edit_cluster(
        _edit_cluster(cluster_source(s), "    store_k(b);\n", ""),
        "    store_v(b);\n", ""),
        "    if (i + 1 < n_tiles) load_k(i + 1);\n", ""),
        "    if (i + 1 < n_tiles) load_v(i + 1);\n", ""),
    "no_exchange": lambda s: _edit_cluster(_edit_cluster(
        cluster_source(s),
        "    mbar_wait_cluster(&bar[XB + xp], (i >> 1) & 1);\n", ""),
        "    if (lane == 0)\n#pragma unroll\n      for (int j = 0; j < C - 1; "
        "++j) mbar_arrive_peer(peer_bar[j] + 8 * xp);\n", ""),
    "rescale_always": lambda s: _edit(
        s, "    if (!__all_sync(0xffffffffu, prm[0] == 1.f && prm[1] == 1.f))"
        "\n", ""),
    "cvt_split": lambda s: _edit(
        s, INT_TF32, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : '
        '"=r"(r) : "f"(x));\n  return r;'),
    "trunc_lo": lambda s: _edit(
        s, LO, "  lo = __float_as_uint(x - __uint_as_float(hi));"),
    "kdepth8": lambda s: _edit(s, "constexpr int KDEPTH = 4;",
                               "constexpr int KDEPTH = 8;"),
    "tf32_1x": lambda s: _edit(_edit(_edit(_edit(
        s, "mma3<EXACT, EXACT>", "mma3<true, true>"),
        "mma3<false, EXACT>", "mma3<true, true>"),
        "        if constexpr (!EXACT) {\n          wgmma_ss(",
        "        if constexpr (false) {\n          wgmma_ss("),
        "      wgmma_rs(acc, pl[j], dvh);\n      if constexpr (!EXACT)",
        "      if constexpr (false)"),
}

#: the variants that build the cluster body (at (576, 512), in clusters of
#: four where the name says so, else two)
CLUSTER_VARIANTS = ("cluster2", "cluster2_kb2", "cluster2_bk16", "cluster4",
                    "cluster4_nbuf2_kb4", "cluster4_qsplit",
                    "cluster4_qsplit_kb1", "qk_only", "splitter_idle",
                    "no_exchange")


def _fixed_plan(bq: int, fs: int, dims=GQA_DIMS):
    """A plan function that runs ``dims`` under (bq rows, fs column
    blocks) and every other call under ``autotune.prefill_plan``."""
    def plan(bh: int, pg: int, e: int, f: int) -> autotune.PrefillPlan:
        if (e, f) not in dims:
            return autotune.prefill_plan(bh, pg, e, f)
        bk = autotune.CUDA_PREFILL[(e, f)].block_k
        return autotune.PrefillPlan(bq, bk, fs, -(-pg // bq) * bh * fs)
    return plan


def mma_sync_plan(bh: int, pg: int, e: int, f: int) -> autotune.PrefillPlan:
    """The plan of ``mma_sync_source``'s library: at ``MMA_TILES``' dims
    the mma.sync tile's BQ rows in one column block, else the shipped
    plan."""
    if (e, f) not in MMA_TILES:
        return autotune.prefill_plan(bh, pg, e, f)
    bq, bk = MMA_TILES[(e, f)][:2]
    return autotune.PrefillPlan(bq, bk, 1, -(-pg // bq) * bh)


def default_plan(bh: int, pg: int, e: int, f: int) -> autotune.PrefillPlan:
    """The (E, F)'s first plan whatever the shape: no column split
    (``default_plan``)."""
    kern = autotune.CUDA_PREFILL[(e, f)]
    bq, fs = kern.plans[0]
    return autotune.PrefillPlan(bq, kern.block_k, fs,
                                -(-pg // bq) * bh * fs)


#: the plan each variant's calls run
PLANS = {"default_plan": default_plan, "split2": _fixed_plan(64, 2),
         "split4": _fixed_plan(64, 4, ((128, 128),)),
         "mma_sync": mma_sync_plan,
         **{name: _fixed_plan(64, 4 if name.startswith("cluster4") else 2,
                              ((576, 512),))
            for name in CLUSTER_VARIANTS}}

MMA_PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256) mma_peak(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  const uint32_t b0 = __float_as_uint(1e-3f * threadIdx.x), b1 = a[1];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int x = 0; x < 4; ++x) s += d[j][x];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_peak_launch(int blocks, int iters, void* out,
                               void* stream) {
  mma_peak<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""

def _wgmma_peak_src(n: int = 128, rs: bool = False) -> str:
    """A kernel that issues `wgmma` m64n{n}k8 .tf32 back to back from two
    warpgroups a block, operands from shared memory (no swizzle), or with
    ``rs`` A from registers, 8 chained into one accumulator a commit
    group, one group in flight."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    if rs:    # A: 4 registers a thread; B and the predicate follow them
        a_op = "{%%%d, %%%d, %%%d, %%%d}" % (r, r + 1, r + 2, r + 3)
        b_op, pred = "%%%d" % (r + 4), r + 5
        ins = ('"r"(ua[0]), "r"(ua[1]), "r"(ua[2]), "r"(ua[3]), "l"(db), '
               '"r"(1)')
    else:
        a_op, b_op, pred = "%%%d" % r, "%%%d" % (r + 1), r + 2
        ins = '"l"(da), "l"(db), "r"(1)'
    name = "wgmma_rs_peak" if rs else "wgmma_peak"
    return r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32;
}

__global__ void __launch_bounds__(256) %(name)s(float* out, int iters) {
  __shared__ __align__(128) float a[64 * 8];
  __shared__ __align__(128) float b[%(n)d * 8];
  for (int i = threadIdx.x; i < 64 * 8; i += 256) a[i] = 1e-3f * (i %% 7);
  for (int i = threadIdx.x; i < %(n)d * 8; i += 256) b[i] = 1e-3f * (i %% 5);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t da = desc(a, 64 * 16, 128), db = desc(b, %(n)d * 16, 128);
  uint32_t ua[4];
  for (int i = 0; i < 4; ++i) ua[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  float d[%(r)d];
  for (int i = 0; i < %(r)d; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %%%(pred)d, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n%(n)dk8.f32.tf32.tf32 "
          "{%(regs)s}, %(a_op)s, %(b_op)s, p, 1, 1;\n}\n"
          : %(outs)s
          : %(ins)s);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < %(r)d; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int %(name)s_launch(int blocks, int iters, void* out,
                               void* stream) {
  %(name)s<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
""" % dict(n=n, r=r, pred=pred, a_op=a_op, b_op=b_op, regs=regs,
           outs=outs, ins=ins, name=name)


#: (name, B·Hkv, P·G, M, E, F, group, q_offset[, window, softcap[, lse]]):
#: the shapes chip_smoke times K1 at (``lse``: the call also writes each
#: row's log-sum-exp, as the training forward does)
SHAPES = [
    ("granite B4 Hq32 Hkv8 P=M=1024 d128", 32, 4096, 1024, 128, 128, 4, 0),
    ("granite tp2 head shard B4 Hq16 Hkv4 P=M=1024 d128", 16, 4096, 1024,
     128, 128, 4, 0),
    ("serve_async quantum B1 Hq32 Hkv8 P=128 after 896 M=1024 d128", 8,
     512, 1024, 128, 128, 4, 896),
    ("granite chunk B1 Hq32 Hkv8 P=208 after 816 M=1024 d128", 8, 832,
     1024, 128, 128, 4, 816),
    ("hymba quantum B1 Hq25 Hkv5 P=128 after 896 M=1024 d64", 5, 640,
     1024, 64, 64, 5, 896),
    ("hymba chunk B1 Hq25 Hkv5 P=256 after 768 M=1024 d64", 5, 1280,
     1024, 64, 64, 5, 768),
    ("stablelm train B4 H32 P=M=1024 d64 + LSE", 128, 1024, 1024, 64, 64, 1,
     0, 0, 0.0, True),
    ("hymba global B4 Hq25 Hkv5 P=M=2048 d64", 20, 10240, 2048, 64, 64, 5,
     0),
    ("hymba local B4 Hq25 Hkv5 P=M=2048 d64 window 1024", 20, 10240, 2048,
     64, 64, 5, 0, 1024, 0.0),
    ("mla_forward B4 H128 P=M=1024 E192 F128", 512, 1024, 1024, 192, 128,
     1, 0),
    ("absorbed B4 H128 in 1 group P=256 after 768 E576 F512", 4, 32768,
     1024, 576, 512, 128, 768),
    ("gemma2 global B2 Hq16 Hkv8 P=M=8192 d256 softcap 50", 16, 16384, 8192,
     256, 256, 2, 0, 0, 50.0),
    ("gemma2 local B2 Hq16 Hkv8 P=M=8192 d256 window 4096 softcap 50", 16,
     16384, 8192, 256, 256, 2, 0, 4096, 50.0),
    ("smoke 32x32 B4 Hq4 Hkv2 P=M=256 d32 window 64 softcap 50", 8, 512,
     256, 32, 32, 2, 0, 64, 50.0),
    ("smoke 48x32 B4 H4 P=M=256 E48 F32", 16, 256, 256, 48, 32, 1, 0),
]

#: (name, B·Hkv, P·G, M, E, F, group, q_offset, inputs)
STRESS = [
    ("q x30 d128 g4 P=M=512", 4, 2048, 512, 128, 128, 4, 0, "q_x30"),
    ("q x30 E576 F512 g16 P=M=512", 1, 8192, 512, 576, 512, 16, 0,
     "q_x30"),
    ("x + x*2^-12 E192 F128 P=M=1024", 8, 1024, 1024, 192, 128, 1, 0,
     "low_bits"),
    ("unit normals d128 g4 P=M=1024", 8, 4096, 1024, 128, 128, 4, 0, None),
    ("q x30 d256 g2 P=M=512", 4, 1024, 512, 256, 256, 2, 0, "q_x30"),
    ("x + x*2^-12 d256 g2 P=M=512", 4, 1024, 512, 256, 256, 2, 0,
     "low_bits"),
    ("q x30 E192 F128 P=M=512", 8, 512, 512, 192, 128, 1, 0, "q_x30"),
]


def shipped_source() -> str:
    """The shipped K1 source with its ``csrc/*.cuh`` headers inlined (each
    once, where it is first included), so that a variant may edit any of
    them and builds outside ``csrc``."""
    src, done = open(SRC).read(), set()
    while True:
        found = re.search(r'#include "(\w+\.cuh)"\n', src)
        if not found:
            return src.replace("#pragma once\n", "")
        name = found.group(1)
        text = ""
        if name not in done:
            done.add(name)
            with open(os.path.join(os.path.dirname(SRC), name)) as fh:
                text = fh.read()
        src = src[:found.start()] + text + src[found.end():]


def start_build(sources: dict, out_dir: str = OUT_DIR) -> dict:
    """Write each {name: CUDA source} to ``out_dir`` and start one ``nvcc``
    on each, all at once; returns what :func:`finish_build` takes."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, os.path.join(out_dir, f"{name}.log"),
                       subprocess.Popen(
                           [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                            path], stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True))
    return procs


def finish_build(procs: dict) -> dict:
    """Wait for :func:`start_build`'s compilers; {name: loaded library},
    each beside its ``-Xptxas -v`` report, ``<name>.log``."""
    libs = {}
    for name, (lib, log_path, proc) in procs.items():
        log, _ = proc.communicate()
        with open(log_path, "w") as fh:
            fh.write(log)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def prefill_fn(lib):
    """A library's ``fusemax_prefill`` entry, typed."""
    fn = lib.fusemax_prefill
    fn.restype = ctypes.c_int
    fn.argtypes = fm.PREFILL_ARGTYPES
    return fn


def build(names: list[str]) -> tuple[dict, object, dict]:
    """({variant: its fusemax_prefill}, {rate probe: its launch},
    {variant: its library}), built together."""
    src = shipped_source()
    sources = {name: VARIANTS[name](src) for name in names}
    sources["mma_peak"] = MMA_PEAK_SRC
    for n in WGMMA_RATE_NS:
        sources[f"wgmma_peak_n{n}"] = _wgmma_peak_src(n)
    for n in WGMMA_RS_RATE_NS:
        sources[f"wgmma_rs_peak_n{n}"] = _wgmma_peak_src(n, rs=True)
    libs = finish_build(start_build(sources))
    peak = {}
    for name in ("mma_peak", *(f"wgmma_peak_n{n}" for n in WGMMA_RATE_NS),
                 *(f"wgmma_rs_peak_n{n}" for n in WGMMA_RS_RATE_NS)):
        fn = getattr(libs.pop(name), f"{name.split('_n')[0]}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        peak[name] = fn
    return ({name: prefill_fn(lib) for name, lib in libs.items()}, peak,
            libs)


def max_active_clusters(lib, dtype: torch.dtype, c: int) -> int:
    """``fusemax_prefill_max_active_clusters`` of a library that compiles
    the cluster plan (64, c) at (576, 512): the clusters the card holds
    at once."""
    fn = lib.fusemax_prefill_max_active_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    n = ctypes.c_int()
    err = fn(fm.CUDA_DTYPES[dtype], 576, 512, 64, c, ctypes.byref(n))
    if err:
        raise RuntimeError(f"max_active_clusters: CUDA error {err}")
    return n.value


def sdpa_call(q, k, v, group, q_offset, window=0):
    """``scaled_dot_product_attention`` on the folded call's inputs, its
    query rows unfolded to (fiber, G heads, P) over one kv head, the same
    causal, offset and window mask (no softcap: SDPA has none), fp32: the
    library yardstick of a timing row, as a call of no arguments."""
    import torch.nn.functional as F

    bh, pg, e = q.shape
    p, m = pg // group, k.shape[1]
    qu = q.reshape(bh, p, group, e).transpose(1, 2)
    kpos = torch.arange(m, device=q.device)[None, :]
    qpos = q_offset + torch.arange(p, device=q.device)[:, None]
    mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    return lambda: F.scaled_dot_product_attention(
        qu, k[:, None], v[:, None], attn_mask=mask, scale=e ** -0.5,
        enable_gqa=True)


def mma_rate(peak) -> dict:
    """TF32 FLOP/s of back-to-back mma.sync.m16n8k8 on the whole card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 2 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if peak["mma_peak"](blocks, iters, out.data_ptr(), stream):
            raise RuntimeError("mma_peak launch failed")

    ms = time_ms(run, iters=5, warmup=1)
    flops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8
    return dict(kind="mma_sync_tf32_rate", ms=ms,
                tflops=flops / ms / 1e9, blocks=blocks, warps_per_block=8,
                accumulators_per_warp=8)


#: the N of the `wgmma` m64nNk8 rate probes: the P·V product's 128, and
#: the Q·Kᵀ product's 32 and 16, where the A operand (64 x 8 of Q) read
#: from shared memory by every `wgmma` weighs against fewer FLOPs
WGMMA_RATE_NS = (128, 32, 16)
#: the N of the register-A (`wgmma` RS) rate probes: the cluster body's
#: Q·Kᵀ at 32 and 16 keys and its P·V at 256 columns
WGMMA_RS_RATE_NS = (256, 32, 16)


def wgmma_rate(peak, n: int = 128, rs: bool = False) -> dict:
    """TF32 FLOP/s of back-to-back `wgmma` m64n{n}k8 on the whole card:
    one block of two warpgroups a SM, operands in shared memory (``rs``:
    A from registers)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    name = f"wgmma_{'rs_' if rs else ''}peak_n{n}"

    def run():
        if peak[name](blocks, iters, out.data_ptr(), stream):
            raise RuntimeError(f"{name} launch failed")

    ms = time_ms(run, iters=5, warmup=1)
    flops = blocks * 2 * iters * 8 * 2 * 64 * n * 8
    return dict(kind="wgmma_tf32_rate", ms=ms, tflops=flops / ms / 1e9,
                blocks=blocks, warpgroups_per_block=2, shape=f"m64n{n}k8",
                a_operand="registers" if rs else "shared memory")


def plan_of(name: str, q, v) -> autotune.PrefillPlan:
    """The plan variant ``name`` runs on q [B·Hkv, P·G, E], v."""
    bh, pg, e = q.shape
    return PLANS.get(name, autotune.prefill_plan)(bh, pg, e, v.shape[2])


def launch_plan(fn, plan, q, k, v, o, *, group=1, q_offset=0, window=0,
                softcap=0.0, lse=None, causal=True, m_valid=None,
                exp_maccs=False, scale=None):
    """One launch of a library's ``fusemax_prefill`` under ``plan`` on
    the current stream: q [B·Hkv, P·G, E] fp32 or bf16 into o, scale
    E^-0.5 unless given (``window`` 0 and ``softcap`` 0.0 mean none)."""
    bh, pg, e = q.shape
    m, f = v.shape[1], v.shape[2]
    scale = e ** -0.5 if scale is None else scale
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), fm.CUDA_DTYPES[q.dtype],
            e, f, bh, pg, m, scale, int(causal), window, softcap,
            q_offset, group, m if m_valid is None else m_valid,
            int(exp_maccs), plan.block_q, plan.f_split]
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{plan}: launch failed: CUDA error {err}")


def launch(name, fn, q, k, v, o, group, q_offset, window=0, softcap=0.0,
           lse=None):
    launch_plan(fn, plan_of(name, q, v), q, k, v, o, group=group,
                q_offset=q_offset, window=window, softcap=softcap, lse=lse)


#: (E, F, kv heads, G, P = M of the whole call, the quantum's P) of the
#: quantum-vs-chunk checks
QUANTUM_CASES = [(128, 128, 8, 4, 1024, 128), (64, 64, 5, 5, 1024, 128),
                 (576, 512, 1, 16, 256, 64), (48, 32, 4, 1, 256, 64),
                 (32, 32, 2, 2, 256, 64)]


def quantum_vs_chunk(name, fn, rand) -> list:
    """The rows of a prompt's last quantum against the same rows of one
    whole-prompt call (fp32, causal): the largest difference at
    ``QUANTUM_CASES`` (a 1024-token prompt's last 128 tokens at (128, 128)
    G 4 and (64, 64) G 5, a 256-token prompt's last 64 at (576, 512) G 16,
    (48, 32) G 1 and (32, 32) G 2)."""
    out = []
    for e, f, hkv, g, p_all, p_q in QUANTUM_CASES:
        off = p_all - p_q
        q, k, v = rand(hkv, p_all * g, e), rand(hkv, p_all, e), \
            rand(hkv, p_all, f)
        whole = torch.empty(hkv, p_all * g, f, device="cuda")
        launch(name, fn, q, k, v, whole, g, 0)
        qq = q[:, off * g:].contiguous()
        part = torch.empty(hkv, p_q * g, f, device="cuda")
        launch(name, fn, qq, k, v, part, g, off)
        torch.cuda.synchronize()
        plans = [plan_of(name, x, v) for x in (qq, q)]
        out.append(dict(e=e, f=f, group=g, max_abs_diff=(
            part - whole[:, off * g:]).abs().max().item(),
            plans=[[p.block_q, p.f_split, p.blocks] for p in plans]))
    return out


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 3) -> float:
    """Device time of one call of ``fn`` from ``torch.profiler``'s CUDA
    kernel records over ``iters`` calls after ``warmup``: for every kernel
    the call launches, the mean of its recorded launches times its
    launches a call (its records over ``iters`` rounded up: CUPTI drops a
    few records), summed.  A session with no record is profiled again, up
    to ``tries`` sessions; then it raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        n, us = {}, {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                n[ev.name] = n.get(ev.name, 0) + 1
                us[ev.name] = us.get(ev.name, 0.0) + (
                    ev.device_time_total if hasattr(ev, "device_time_total")
                    else ev.cuda_time_total)
        if n:
            return sum(us[k] / n[k] * -(-n[k] // iters) for k in n) / 1e3
    raise RuntimeError(f"the profiler recorded no kernel in {tries} "
                       "sessions")


def ref64(q, k, v, group, q_offset):
    """Causal softmax attention in float64 on the folded layout."""
    pg, m = q.shape[1], k.shape[1]
    s = torch.einsum("bre,bke->brk", q.double(), k.double()) \
        * q.shape[2] ** -0.5
    qpos = torch.arange(pg, device=q.device) // group + q_offset
    ok = torch.arange(m, device=q.device)[None, :] <= qpos[:, None]
    s = s.masked_fill(~ok, float("-inf"))
    return torch.einsum("brk,bkf->brf", torch.softmax(s, -1), v.double())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"some of {list(VARIANTS)} (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/k1_variants.json")
    ap.add_argument("--shapes", nargs="+", metavar="WORD",
                    help="time only the shapes whose name holds one of "
                         "these words (default: all)")
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    names = args.variants or list(VARIANTS)
    if not torch.cuda.is_available():
        print("torch_k1_variants: no CUDA device", file=sys.stderr)
        return 2
    strict_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    fns, peak, libs = build(names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    results = [dict(mma_rate(peak), device=smi)] + [
        dict(wgmma_rate(peak, n), device=smi) for n in WGMMA_RATE_NS] + [
        dict(wgmma_rate(peak, n, rs=True), device=smi)
        for n in WGMMA_RS_RATE_NS]
    for n in fns:
        if n in CLUSTER_VARIANTS:
            c = 4 if n.startswith("cluster4") else 2
            results.append(dict(
                kind="max_active_clusters", variant=n, cluster=c,
                device=smi, sms=torch.cuda.get_device_properties(
                    0).multi_processor_count,
                **{str(dt).split(".")[1]: max_active_clusters(libs[n], dt, c)
                   for dt in (torch.float32, torch.bfloat16)}))
    for row in results:
        print(json.dumps(row), flush=True)
    shapes = [row for row in SHAPES if not args.shapes
              or any(word in row[0] for word in args.shapes)]
    for name, bh, pg, m, e, f, group, q_offset, *mask in shapes:
        q, k, v = rand(bh, pg, e), rand(bh, m, e), rand(bh, m, f)
        o = torch.empty(bh, pg, f, device="cuda")
        if len(mask) == 3:                       # (window, softcap, lse)
            mask = [*mask[:2], torch.empty(bh, pg, device="cuda")]
        ms = {n: [] for n in fns}
        dev = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                def call(n=n):
                    launch(n, fns[n], q, k, v, o, group, q_offset, *mask)
                ms[n].append(time_ms(call))
                dev[n].append(device_ms(call))
        plans = {n: dataclasses.astuple(plan_of(n, q, v)) for n in fns}
        sdpa = sdpa_call(q, k, v, group, q_offset, *mask[:1]) \
            if group * (pg // group) == pg else None
        row = dict(kind="time", shape=name, device=smi, ms=ms,
                   device_ms=dev,
                   sdpa_ms=sdpa and time_ms(sdpa),
                   sdpa_device_ms=sdpa and device_ms(sdpa),
                   plans_bq_bk_fsplit_blocks=plans)
        print(json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, o
        torch.cuda.empty_cache()
    for n, fn in fns.items():
        row = dict(kind="quantum_vs_chunk", variant=n, device=smi,
                   cases=quantum_vs_chunk(n, fn, rand))
        print(json.dumps(row), flush=True)
        results.append(row)
    for name, bh, pg, m, e, f, group, q_offset, how in STRESS:
        q, k, v = rand(bh, pg, e), rand(bh, m, e), rand(bh, m, f)
        if how == "q_x30":
            q = q * 30.0
        elif how == "low_bits":
            q, k, v = (x + x * 2.0 ** -12 for x in (q, k, v))
        ref = ref64(q, k, v, group, q_offset)
        bq, bk = autotune.CUDA_PREFILL_TILES[(e, f)]
        plain = fm.fusemax_attention_torch(
            q, k, v, scale=e ** -0.5, causal=True, group=group,
            q_offset=q_offset, block_q=bq, block_k=bk)
        row = dict(kind="accuracy", case=name, device=smi,
                   plain_vs_f64=(plain.double() - ref).abs().max().item(),
                   vs_f64={}, vs_plain={})
        for n, fn in fns.items():
            o = torch.empty(bh, pg, f, device="cuda")
            launch(n, fn, q, k, v, o, group, q_offset)
            torch.cuda.synchronize()
            row["vs_f64"][n] = (o.double() - ref).abs().max().item()
            row["vs_plain"][n] = (o - plain).abs().max().item()
        print(json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, ref, plain
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
