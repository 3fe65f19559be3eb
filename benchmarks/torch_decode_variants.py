"""K2's and K3's design choices, measured on the card.

    python benchmarks/torch_decode_variants.py [--out PATH] [VARIANT ...]

Builds the split-K decode partials body
(``src/repro_torch/kernels/csrc/decode_partials.cuh``, with its two entry
files ``decode_partials.cu`` (K2, dense cache) and
``paged_decode_partials.cu`` (K3, page pool)) as it ships and in variants
that each change one design choice (a textual edit of the shipped header,
which raises when the header no longer holds the text it edits), all with
``nvcc`` in parallel into ``build/decode_variants/``.  Then, fp32, on the
CUDA device, at the shapes ``chip_smoke.py`` times K2 and K3 at (a
granite-3-8b decode step: 8 slots, 32 query over 8 kv heads, head dim
128, kv_len [2048, 1500, 1024, 700, 300, 64, 1, 1900], 16 splits; K2 on a
2048-slot dense cache with 128-key tiles, K3 on the same rows in a
1024-page pool of 16-token pages in random order with 16-key tiles):

* checks each variant against the plain version (largest difference of
  the combined output);
* times each over 20 launches after 3, in two rounds (the variants in
  order, then in reverse, so that a drift of the card shows): ``ms`` from
  CUDA events around the launches (the C entry point called directly, no
  wrapper), ``device_ms`` from ``torch.profiler``'s kernel records.

Variants (each one edit of the shipped header; one that equals the
shipped source is skipped; ``a+b`` applies both):

* ``stages2`` / ``stages3`` — ring of 2 or 3 chunks;
* ``ck16`` / ``ck32`` / ``ck64`` — 16, 32 or 64 keys a chunk;
* ``skip_off``    — every walk covers the whole tile-run range, also
  with P = 1 and no window (the trailing chunks past kv_len are walked);
* ``page_lookup`` — K3 reads each chunk's page ids from the block table
  in device memory instead of the page list in shared memory;
* ``no_key_split`` — one warp per row group walks every key of a chunk
  (the 4 warps split the rows, no cross-warp merge) instead of 4 warps
  splitting each chunk's keys;
* ``nt256``       — 8 warps a block (two row groups of 4 key warps);
* ``lb5`` / ``lb6`` — registers capped for 5 or 6 blocks a SM
  (``__launch_bounds__(NT, n)``).

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

from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels import decode as dec  # noqa: E402
from repro_torch.model.layers import strict_fp32  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
HEADER = "decode_partials.cuh"
ENTRIES = {"k2": "decode_partials.cu", "k3": "paged_decode_partials.cu"}
OUT_DIR = os.path.join(ROOT, "build", "decode_variants")


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


VARIANTS = {
    "shipped": lambda s: s,
    "stages2": lambda s: _const(s, "STAGES", 2),
    "stages3": lambda s: _const(s, "STAGES", 3),
    "ck16": lambda s: _const(s, "CK", 16),
    "ck32": lambda s: _const(s, "CK", 32),
    "ck64": lambda s: _const(s, "CK", 64),
    "skip_off": lambda s: _edit(
        s, "const bool skip = a.n_pos == 1 && a.window <= 0;",
        "const bool skip = false;"),
    "page_lookup": lambda s: _edit(_edit(
        s, "      list[i] = min(ids[i], n_pages - 1);", "      ;"),
        "    const int page = list[pi];",
        "    const int page = min(block_table[static_cast<size_t>(b) * w + "
        "split0 / ps + pi], n_pages - 1);"),
    "no_key_split": lambda s: _const(s, "WK", 1),
    "nt256": lambda s: _const(s, "NT", 256),
    "lb5": lambda s: _edit(s, "__launch_bounds__(NT)",
                           "__launch_bounds__(NT, 5)"),
    "lb6": lambda s: _edit(s, "__launch_bounds__(NT)",
                           "__launch_bounds__(NT, 6)"),
}


def _variant(name: str, src: str) -> str:
    """The header of ``name``: one variant, or several joined by ``+``
    (e.g. ``ck16+stages2``), applied in order."""
    for part in name.split("+"):
        src = VARIANTS[part](src)
    return src


def build(names: list[str]) -> dict:
    """{variant: {"k2": fn, "k3": fn}} for each variant whose header
    differs from the shipped one, all compiled at once."""
    shipped = open(os.path.join(CSRC, HEADER)).read()
    headers, seen = {}, {}
    for name in names:
        text = _variant(name, shipped)
        if text in seen:
            print(f"torch_decode_variants: {name} equals {seen[text]}, "
                  f"skipped", file=sys.stderr)
            continue
        seen[text] = name
        headers[name] = text
    procs = {}
    for name, text in headers.items():
        d = os.path.join(OUT_DIR, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, HEADER), "w") as fh:
            fh.write(text)
        for kind, entry in ENTRIES.items():
            shutil.copy(os.path.join(CSRC, entry), os.path.join(d, entry))
            lib = os.path.join(d, f"lib{kind}.so")
            procs[(name, kind)] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                 os.path.join(d, entry)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    argtypes = {"k2": dec._partials_lib()[0].argtypes,
                "k3": dec._paged_lib()[0].argtypes}
    symbol = {"k2": "decode_partials", "k3": "paged_decode_partials"}
    fns: dict = {}
    failed = set()
    for (name, kind), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            # a variant the kernel's static checks refuse is reported and
            # left out; the others are still measured
            print(json.dumps(dict(kind="build_failed", variant=name,
                                  entry=ENTRIES[kind], log=log[-2000:])),
                  flush=True)
            failed.add(name)
            continue
        fn = getattr(ctypes.CDLL(lib), symbol[kind])
        fn.restype, fn.argtypes = ctypes.c_int, argtypes[kind]
        fns.setdefault(name, {})[kind] = fn
    return {n: f for n, f in fns.items() if n not in failed}


def granite_step(gen):
    """A granite-3-8b decode step on both layouts (chip_smoke's K2/K3
    timing data): q [B·Hkv, G, D], the dense cache [B·Hkv, M, D], the same
    rows in a permuted page pool, its block table with sentinels past
    kv_len, kv_len."""
    b, hkv, g, m, d, ps = 8, 8, 4, 2048, 128, 16
    w = m // ps
    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 1900]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    q, k, v = rand(b * hkv, g, d), rand(b * hkv, m, d), rand(b * hkv, m, d)
    perm = torch.randperm(b * w, generator=gen, device="cuda")
    pools = []
    for x in (k, v):
        pool = torch.empty((b * w, ps, hkv, d), device="cuda")
        pool[perm] = x.reshape(b, hkv, w, ps, d).permute(0, 2, 3, 1, 4) \
            .reshape(b * w, ps, hkv, d)
        pools.append(pool)
    table = perm.to(torch.int32).reshape(b, w).clone()
    for i, n in enumerate(kvl):
        table[i, -(-n // ps):] = b * w
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    return dict(q=q, k=k, v=v, k_pages=pools[0], v_pages=pools[1],
                table=table, kv_len=kv_len, hkv=hkv, g=g, m=m, d=d, ps=ps,
                w=w)


def launcher(kind: str, fn, x: dict):
    """A no-argument call of ``fn`` (one variant's K2 or K3 entry point)
    at the tuned geometry, writing preallocated partials."""
    hkv, g, m, d, ps, w = (x[k] for k in ("hkv", "g", "m", "d", "ps", "w"))
    bh = x["q"].shape[0]
    if kind == "k2":
        tuned = autotune.decode_params(m, max(g, 8), d, d)
    else:
        tuned = autotune.paged_decode_params(w, ps, max(g, 8), d, d)
    splits, bk = tuned.splits, tuned.block_k
    pm = torch.empty((bh, splits, g), device="cuda")
    pl = torch.empty_like(pm)
    pnv = torch.empty((bh, splits, g, d), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    p = [t.data_ptr() for t in (x["q"], x["k"], x["v"], x["k_pages"],
                                x["v_pages"], x["table"], x["kv_len"], pm,
                                pl, pnv)]
    q, k, v, kp, vp, table, kv_len, pm_, pl_, pnv_ = p
    if kind == "k2":
        args = (q, k, v, kv_len, pm_, pl_, pnv_, 0, d, bh, hkv, g, m,
                splits, m // splits, bk, 1, g, d ** -0.5, 0, 0.0, 0, 0,
                stream)
    else:
        n_pages = x["k_pages"].shape[0]
        args = (q, kp, vp, None, None, table, kv_len, pm_, pl_, pnv_, 0, 0,
                d, bh, hkv, g, n_pages, ps, w, splits, (w // splits) * ps, bk,
                1, g, d ** -0.5, 0.0, 0, stream)

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return pm, pl, pnv

    return run, dict(splits=splits, block_k=bk)


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


def device_ms(fn, iters: int = 20) -> float:
    """Mean kernel time per launch from the profiler's CUDA records of
    ``iters`` launches."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [ev.device_time_total if hasattr(ev, "device_time_total")
          else ev.cuda_time_total for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and "decode_partials_kernel" in ev.name]
    if not us:
        raise RuntimeError("the profiler recorded no decode_partials_kernel")
    # the mean over the launches the profiler recorded (it may drop one)
    return sum(us) / 1e3 / len(us)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"some of {list(VARIANTS)}, or several joined by "
                         f"'+' (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/decode_variants.json")
    args = ap.parse_args(argv)
    unknown = {p for n in args.variants for p in n.split("+")} - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    names = args.variants or list(VARIANTS)
    if not torch.cuda.is_available():
        print("torch_decode_variants: no CUDA device", file=sys.stderr)
        return 2
    strict_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    fns = build(names)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    x = granite_step(gen)
    results = []
    for kind in ("k2", "k3"):
        runs, geo = {}, None
        for name, pair in fns.items():
            runs[name], geo = launcher(kind, pair[kind], x)
        kw = dict(scale=x["d"] ** -0.5, hkv=x["hkv"], **geo)
        if kind == "k2":
            ref = dec.decode_partials_torch(x["q"], x["k"], x["v"],
                                            x["kv_len"], **kw)
        else:
            ref = dec.paged_decode_partials_torch(
                x["q"], x["k_pages"], x["v_pages"], x["table"], x["kv_len"],
                **kw)
        want = dec.combine_partials(*ref, torch.float32)
        err = {}
        for name, run in runs.items():
            got = dec.combine_partials(*run(), torch.float32)
            err[name] = (got - want).abs().max().item()
        ms = {n: [] for n in runs}
        dev = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                ms[n].append(time_ms(runs[n]))
                dev[n].append(device_ms(runs[n]))
        row = dict(kernel=kind, device=smi, **geo,
                   shape="B8 Hq32 Hkv8 d128 fp32 kv_len [2048, 1500, 1024, "
                         "700, 300, 64, 1, 1900]"
                         + (" M2048" if kind == "k2" else
                            " page_size 16 W 128, pool 1024 pages permuted"),
                   max_abs_err=err, ms=ms, device_ms=dev)
        print(json.dumps(row), flush=True)
        results.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
