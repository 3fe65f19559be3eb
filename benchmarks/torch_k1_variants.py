"""K1's design choices, measured on the card.

    python benchmarks/torch_k1_variants.py [--out PATH] [VARIANT ...]

Builds ``src/repro_torch/kernels/csrc/fusemax_prefill.cu`` as it ships
and in variants that each change one design choice (a textual edit of
the shipped source, which raises when the source no longer holds the
text it edits), all with ``nvcc`` in parallel into ``build/k1_variants/``
(each beside its ``-Xptxas -v`` report, ``<variant>.log``).  Then, fp32,
on the CUDA device:

* times every variant at the shapes ``chip_smoke.py`` times K1 at
  (granite-3-8b's prefill dispatch, DeepSeek-V3's ``mla_forward`` and its
  absorbed tail, gemma2-9b's global and local layers), CUDA events over
  20 launches after 3, in two rounds
  (the variants in order, then in reverse) so that a drift of the card
  shows;
* runs every variant on stress inputs (scores in the hundreds, bits below
  TF32's mantissa that matter, a plain long sweep) and reports its
  largest distance to a float64 softmax-attention reference beside the
  plain fp32 version's (``fusemax_attention_torch``).

Variants:

* ``shipped``       — the source as it is;
* ``cvt_split``     — hi and lo rounded by ``cvt.rna.tf32.f32`` instead of
  the same rounding on the integer pipe;
* ``trunc_lo``      — lo passed unrounded, so the tensor core drops its 13
  low bits (what CUTLASS's fast-fp32 operator does);
* ``rows16_p_regs`` — the first design: 16-row warps, P in registers at
  F <= 128 (WF 1, MT 1, BQ 64), two 16-row warps per row group at
  (576, 512);
* ``kdepth8``       — score partials of 8 k-steps instead of 4;
* ``tf32_1x``       — single-pass TF32 (hi·hi only), for the accuracy
  and speed it gives up; never shipped;
* ``tile256_128x64`` — gemma's (256, 256) on a 128 x 64 tile with two
  warps a row group (128 accumulator floats a lane, 223,232 B of shared
  memory) instead of the shipped 64 x 64 with four (64 floats, 138,240
  B).

Beside them it measures the rate ``mma.sync.m16n8k8`` TF32 reaches on
this card with nothing else in the way (2 blocks of 8 warps a SM, 8
independent accumulators a warp, back-to-back mma): the ceiling of any
kernel built on that instruction, as against the 495 TFLOP/s that
``wgmma`` is rated at.

Prints one JSON object per shape, per stress case and for the mma rate,
and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fusemax as fm  # noqa: E402
from repro_torch.kernels.autotune import CUDA_PREFILL_TILES  # noqa: E402
from repro_torch.model.layers import strict_fp32  # noqa: E402

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                   "fusemax_prefill.cu")
OUT_DIR = os.path.join(ROOT, "build", "k1_variants")


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the source no longer holds {old!r}")
    return src.replace(old, new)


def _tiles(src: str, tiles: dict) -> str:
    """``src`` with the (BQ, BK, WF, MT) of each (E, F) in ``tiles``
    replaced (the K chunk ``KC`` stays)."""
    for (e, f), (bq, bk, wf, mt) in tiles.items():
        src, n = re.subn(
            r"struct PrefillTile<%d, %d> \{\n  static constexpr int "
            r"BQ = \d+, BK = \d+, WF = \d+, MT = \d+," % (e, f),
            "struct PrefillTile<%d, %d> {\n  static constexpr int BQ = %d, "
            "BK = %d, WF = %d, MT = %d," % (e, f, bq, bk, wf, mt), src)
        if n != 1:
            raise ValueError(f"no PrefillTile<{e}, {f}> in the source")
    return src


INT_TF32 = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
LO = "  lo = tf32(x - __uint_as_float(hi));"

VARIANTS = {
    "shipped": lambda s: s,
    "cvt_split": lambda s: _edit(
        s, INT_TF32, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : '
        '"=r"(r) : "f"(x));\n  return r;'),
    "trunc_lo": lambda s: _edit(
        s, LO, "  lo = __float_as_uint(x - __uint_as_float(hi));"),
    "rows16_p_regs": lambda s: _tiles(s, {
        (64, 64): (64, 64, 1, 1), (128, 128): (64, 64, 1, 1),
        (192, 128): (64, 64, 1, 1), (576, 512): (64, 64, 2, 1)}),
    "kdepth8": lambda s: _edit(s, "constexpr int KDEPTH = 4;",
                               "constexpr int KDEPTH = 8;"),
    "tf32_1x": lambda s: _edit(_edit(
        s, "mma3<EXACT, EXACT>", "mma3<true, true>"),
        "mma3<false, EXACT>", "mma3<true, true>"),
    "tile256_128x64": lambda s: _tiles(s, {(256, 256): (128, 64, 2, 2)}),
}

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

#: (name, B·Hkv, P·G, M, E, F, group, q_offset[, window, softcap]): the
#: shapes chip_smoke times K1 at
SHAPES = [
    ("granite B4 Hq32 Hkv8 P=M=1024 d128", 32, 4096, 1024, 128, 128, 4, 0),
    ("mla_forward B4 H128 P=M=1024 E192 F128", 512, 1024, 1024, 192, 128,
     1, 0),
    ("absorbed B4 H128 in 1 group P=256 after 768 E576 F512", 4, 32768,
     1024, 576, 512, 128, 768),
    ("gemma2 global B2 Hq16 Hkv8 P=M=8192 d256 softcap 50", 16, 16384, 8192,
     256, 256, 2, 0, 0, 50.0),
    ("gemma2 local B2 Hq16 Hkv8 P=M=8192 d256 window 4096 softcap 50", 16,
     16384, 8192, 256, 256, 2, 0, 4096, 50.0),
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
]


def build(names: list[str]) -> tuple[dict, object]:
    """({variant: its fusemax_prefill}, mma_peak_launch), built together."""
    os.makedirs(OUT_DIR, exist_ok=True)
    src = open(SRC).read()
    sources = {name: VARIANTS[name](src) for name in names}
    sources["mma_peak"] = MMA_PEAK_SRC
    procs = {}
    for name, text in sources.items():
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        lib = os.path.join(OUT_DIR, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    argtypes = fm._prefill_lib()[0].argtypes
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(OUT_DIR, f"{name}.log"), "w") as fh:
            fh.write(log)              # the -Xptxas -v report
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    peak = libs.pop("mma_peak").mma_peak_launch
    peak.restype = ctypes.c_int
    peak.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p]
    fns = {}
    for name, lib in libs.items():
        fn = lib.fusemax_prefill
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[name] = fn
    return fns, peak


def mma_rate(peak) -> dict:
    """TF32 FLOP/s of back-to-back mma.sync.m16n8k8 on the whole card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 2 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if peak(blocks, iters, out.data_ptr(), stream):
            raise RuntimeError("mma_peak launch failed")

    ms = time_ms(run, iters=5, warmup=1)
    flops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8
    return dict(kind="mma_sync_tf32_rate", ms=ms,
                tflops=flops / ms / 1e9, blocks=blocks, warps_per_block=8,
                accumulators_per_warp=8)


def launch(fn, q, k, v, o, group, q_offset, window=0, softcap=0.0):
    bh, pg, e = q.shape
    m, f = v.shape[1], v.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
             0, e, f, bh, pg, m, e ** -0.5, 1, window, softcap, q_offset,
             group, m, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


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
    fns, peak = build(names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    results = [dict(mma_rate(peak), device=smi)]
    print(json.dumps(results[0]), flush=True)
    for name, bh, pg, m, e, f, group, q_offset, *mask in SHAPES:
        q, k, v = rand(bh, pg, e), rand(bh, m, e), rand(bh, m, f)
        o = torch.empty(bh, pg, f, device="cuda")
        ms = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                ms[n].append(time_ms(lambda: launch(fns[n], q, k, v, o,
                                                    group, q_offset, *mask)))
        row = dict(kind="time", shape=name, device=smi, ms=ms)
        print(json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, o
        torch.cuda.empty_cache()
    for name, bh, pg, m, e, f, group, q_offset, how in STRESS:
        q, k, v = rand(bh, pg, e), rand(bh, m, e), rand(bh, m, f)
        if how == "q_x30":
            q = q * 30.0
        elif how == "low_bits":
            q, k, v = (x + x * 2.0 ** -12 for x in (q, k, v))
        ref = ref64(q, k, v, group, q_offset)
        bq, bk = CUDA_PREFILL_TILES[(e, f)]
        plain = fm.fusemax_attention_torch(
            q, k, v, scale=e ** -0.5, causal=True, group=group,
            q_offset=q_offset, block_q=bq, block_k=bk)
        row = dict(kind="accuracy", case=name, device=smi,
                   plain_vs_f64=(plain.double() - ref).abs().max().item(),
                   vs_f64={}, vs_plain={})
        for n, fn in fns.items():
            o = torch.empty(bh, pg, f, device="cuda")
            launch(fn, q, k, v, o, group, q_offset)
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
