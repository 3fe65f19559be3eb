"""The MLA latent decode body's design choices, measured on the card.

    python benchmarks/torch_mla_variants.py [--parent DIR] [--out PATH]
        [--long] [VARIANT ...]

Builds K4 (``src/repro_torch/kernels/csrc/mla_paged_decode_partials.cu``
on the body ``mla_decode_partials.cuh``, which K2's E != F branch shares)
as it ships and in variants that each change one design choice (a textual
edit of the shipped header, which raises when the header no longer holds
the text it edits), all with ``nvcc`` in parallel into
``build/mla_variants/``; with ``--parent DIR`` also the K4 of another
checkout's ``csrc`` directory (``parent``), e.g. the parent commit
unpacked by ``git archive``.  Then, fp32, on the CUDA device, at the shape
``chip_smoke.py`` times K4 at (a DeepSeek-V3 decode step: 8 slots, 128
heads, r 512, rd 64, kv_len [2048, 1500, 1024, 700, 300, 64, 1, 1900] in
a 1024-page pool of 16-token pages in random order, 16 splits, 16-key
tiles; with ``--long`` also 8 slots of 16384 tokens):

* checks each variant against the plain version (largest difference of
  the combined output; the diagnostic variants, marked ``*``, drop work
  and are timed only);
* times each with ``chip_smoke.py``'s timers, in two rounds (the variants
  in order, then in reverse, so that a drift of the card shows): ``ms``
  from CUDA events around 20 launches after 3 (the C entry point called
  directly, no wrapper), ``device_ms`` from ``torch.profiler``'s kernel
  records;
* reports each variant's ptxas line (registers, spill) of the fp32
  (512, 64) instantiation.

Variants (``a+b`` applies both):

* ``ns2``            — a ring of 2 chunks instead of 3;
* ``one_partial``    — one score partial over a warp's 9 k-steps instead
  of partials of KDEPTH;
* ``es16``           — 16 warps split the score's k-steps, each over both
  m16 tiles (each latent value loaded once, not by two warps), instead of
  8 over one, with a ring of 2 chunks (3 do not fit beside its score
  partials);
* ``no_score_mma*``  — the score's mma replaced by one integer op on its
  operands (loads and splits stay);
* ``no_value_mma*``  — the same for the value product;
* ``tf32_1x*``       — single-pass TF32 in both products (the operation
  count of the split divided by 3);
* ``no_chunks*``     — no chunk runs: the launch, the query loads and the
  partials' writes;
* ``no_split*``      — every operand passed as its raw bits with a zero lo
  part (the split's integer and FP work gone, the products kept);
* ``no_softmax_exp*`` — the softmax's exponentials replaced by a multiply.

Prints one JSON object per shape and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from chip_smoke import deepseek_decode_data, device_ms, time_ms  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels import decode as dec  # noqa: E402
from repro_torch.model.layers import strict_fp32  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
HEADER = "mla_decode_partials.cuh"
ENTRY = "mla_paged_decode_partials.cu"
SHARED = ("tf32x3.cuh",)
OUT_DIR = os.path.join(ROOT, "build", "mla_variants")
R, RD, H = 512, 64, 128


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"the header no longer holds {old!r}")
    return src.replace(old, new)


def _const(src: str, name: str, value: int) -> str:
    out, n = re.subn(r"constexpr int %s = \d+;" % name,
                     f"constexpr int {name} = {value};", src)
    if n != 1:
        raise ValueError(f"the header declares no constexpr int {name}")
    return out


def _edit_call(src: str, call: str, new: str) -> str:
    """Replace the one statement ``call`` (its tokens, whatever the line
    breaks and indentation between them) with ``new``."""
    pattern = r"\s*".join(re.escape(tok) for tok in call.split())
    out, n = re.subn(pattern, new, src)
    if n != 1:
        raise ValueError(f"the header holds {n} statements {call!r}")
    return out


_SCORE_MMA = ("mma3<Q_EXACT, K_EXACT>(part[mt][j], qh[mt], ql[mt], kh0, "
              "kh1, kl0, kl1);")
_VALUE_MMA = ("mma3<false, K_EXACT>(acc[mt][n], pfh[mt], pfl[mt], vh0, "
              "vh1, vl0, vl1);")

_LOAD_RAW = """
namespace {
__device__ __forceinline__ void load_raw(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = 0u;
}
__device__ __forceinline__ void load_raw(__nv_bfloat16 x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}
}  // namespace
"""

VARIANTS = {
    "shipped": lambda s: s,
    "ns2": lambda s: _const(s, "NS", 2),
    "es16": lambda s: _const(_const(s, "ES", 16), "NS", 2),
    "one_partial": lambda s: _edit(_edit(
        s, "for (int ip = 0; ip < KPW; ip += KDEPTH) {",
        "for (int ip = 0; ip < KPW; ip += KPW) {"),
        "for (int i = ip; i < ip + KDEPTH && i < KPW; ++i) {",
        "for (int i = ip; i < KPW; ++i) {"),
    "no_score_mma": lambda s: _edit_call(
        s, _SCORE_MMA,
        "part[mt][j][0] += __uint_as_float(qh[mt][0] ^ ql[mt][1] ^ kh0 ^ "
        "kh1 ^ kl0 ^ kl1 ^ qh[mt][2] ^ ql[mt][3]);"),
    "no_value_mma": lambda s: _edit_call(
        s, _VALUE_MMA,
        "acc[mt][n][0] += __uint_as_float(pfh[mt][0] ^ pfl[mt][1] ^ vh0 ^ "
        "vh1 ^ vl0 ^ vl1 ^ pfh[mt][2] ^ pfl[mt][3]);"),
    "tf32_1x": lambda s: _edit_call(_edit_call(
        s, _SCORE_MMA,
        "mma3<true, true>(part[mt][j], qh[mt], ql[mt], kh0, kh1, kl0, "
        "kl1);"), _VALUE_MMA,
        "mma3<true, true>(acc[mt][n], pfh[mt], pfl[mt], vh0, vh1, vl0, "
        "vl1);"),
    "no_split": lambda s: _edit(
        s, '#include "tf32x3.cuh"\n', '#include "tf32x3.cuh"\n' + _LOAD_RAW
    ).replace("load_split(", "load_raw("),
    "no_softmax_exp": lambda s: _edit(_edit(
        s, "fexp<MACCS>(x - m_new)", "(x - m_new) * 0.5f"),
        "fexp<MACCS>(m_i - m_new)", "(m_i - m_new) * 0.5f"),
    "no_chunks": lambda s: _edit(
        s, "const int n_chunks = (kfin - split0 + CK - 1) / CK;",
        "const int n_chunks = 0 * ((kfin - split0 + CK - 1) / CK);"),
}
DIAGNOSTIC = {"no_score_mma", "no_value_mma", "tf32_1x", "no_chunks",
              "no_split", "no_softmax_exp"}


def _variant(name: str, src: str) -> str:
    for part in name.split("+"):
        src = VARIANTS[part](src)
    return src


def _ptxas(log: str) -> str:
    """The ptxas line of the fp32 (512, 64) non-maccs instantiation."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "ffLi512ELi64ELb0E" in ln:
            rest = [x.strip() for x in lines[i + 1:i + 4]]
            return "; ".join(x.split(":", 1)[-1].strip() for x in rest
                             if "spill" in x or "registers" in x)
    return "not found"


def build(names: list[str], parent: str | None) -> tuple[dict, dict]:
    """({variant: K4 entry point}, {variant: ptxas line}), all compiled at
    once."""
    shipped = open(os.path.join(CSRC, HEADER)).read()
    dirs, seen = {}, {}
    for name in names:
        text = _variant(name, shipped)
        if text in seen:
            print(f"torch_mla_variants: {name} equals {seen[text]}, skipped",
                  file=sys.stderr)
            continue
        seen[text] = name
        d = os.path.join(OUT_DIR, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, HEADER), "w") as fh:
            fh.write(text)
        for f in (ENTRY,) + SHARED:
            shutil.copy(os.path.join(CSRC, f), os.path.join(d, f))
        dirs[name] = d
    if parent:
        d = os.path.join(OUT_DIR, "parent")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(parent, d)
        dirs["parent"] = d
    procs = {}
    for name, d in dirs.items():
        lib = os.path.join(d, "libk4.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, ENTRY)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    argtypes = dec._mla_lib().argtypes
    fns, ptxas = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps(dict(kind="build_failed", variant=name,
                                  log=log[-3000:])), flush=True)
            continue
        ptxas[name] = _ptxas(log)
        fn = ctypes.CDLL(lib).mla_paged_decode_partials
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[name] = fn
    return fns, ptxas


def launcher(fn, x: dict):
    """A no-argument call of one variant's K4 entry point on the permuted
    pool of ``x`` (:func:`chip_smoke.deepseek_decode_data`) at the tuned
    geometry, writing preallocated partials."""
    b, w, ps = x["b"], x["w"], x["ps"]
    ckv, kr = x["pools"]["permuted"]
    tuned = autotune.mla_paged_decode_params(w, ps, H, R, RD)
    pm = torch.empty((b, tuned.splits, H), device="cuda")
    pl = torch.empty_like(pm)
    pnv = torch.empty((b, tuned.splits, H, R), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (x["q"].data_ptr(), ckv.data_ptr(), kr.data_ptr(), None, None,
            x["tables"]["permuted"].data_ptr(), x["kv_len"].data_ptr(),
            pm.data_ptr(), pl.data_ptr(), pnv.data_ptr(), 0, 0, R, RD, b, H,
            x["n_pages"], ps, w, tuned.splits, (w // tuned.splits) * ps,
            tuned.block_k, 1, H, (R + RD) ** -0.5, 0.0, 0, stream)

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return pm, pl, pnv

    return run, dict(splits=tuned.splits, block_k=tuned.block_k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"some of {list(VARIANTS)}, or several joined by "
                         f"'+' (default: all)")
    ap.add_argument("--parent", default=None,
                    help="a csrc directory whose K4 is built as 'parent'")
    ap.add_argument("--long", action="store_true",
                    help="also time 8 slots of 16384 tokens")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/mla_variants.json")
    args = ap.parse_args(argv)
    unknown = {p for n in args.variants for p in n.split("+")} - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    names = args.variants or list(VARIANTS)
    if not torch.cuda.is_available():
        print("torch_mla_variants: no CUDA device", file=sys.stderr)
        return 2
    strict_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    fns, ptxas = build(names, args.parent)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    shapes = [("deepseek_decode", [2048, 1500, 1024, 700, 300, 64, 1, 1900],
               128)]
    if args.long:
        shapes.append(("long_16k", [16384] * 8, 1024))
    results = []
    for label, kvl, w in shapes:
        x = deepseek_decode_data(torch, gen, kvl, b=len(kvl), w=w)
        runs, geo, refused = {}, None, {}
        for name, fn in fns.items():
            run, geo = launcher(fn, x)
            try:
                run()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                refused[name] = str(exc)
                continue
            runs[name] = run
        ref = dec.mla_paged_decode_partials_torch(
            x["q"], *x["pools"]["permuted"], x["tables"]["permuted"],
            x["kv_len"], scale=(R + RD) ** -0.5, **geo)
        want = dec.combine_partials(*ref, torch.float32)
        err = {}
        for name, run in runs.items():
            got = dec.combine_partials(*run(), torch.float32)
            err[name] = (got - want).abs().max().item()
        ms = {n: [] for n in runs}
        dev = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                ms[n].append(time_ms(torch, runs[n]))
                dev[n].append(device_ms(torch, runs[n],
                                        "mla_paged_decode_partials_kernel"))
        row = dict(shape=label, device=smi, kv_len=kvl, w=w, **geo,
                   diagnostic=sorted(DIAGNOSTIC & set(runs)), refused=refused,
                   max_abs_err=err, ms=ms, device_ms=dev, ptxas=ptxas)
        print(json.dumps(row), flush=True)
        results.append(row)
        del x
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
