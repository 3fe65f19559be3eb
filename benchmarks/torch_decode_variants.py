"""K2's and K3's design choices, measured on the card.

    python benchmarks/torch_decode_variants.py [--out PATH] [--logs DIR]
        [--shapes NAME ...] [--parent HEADER] [--no-bits] [VARIANT ...]

Builds the split-K decode partials body
(``src/repro_torch/kernels/csrc/decode_partials.cuh``, with its two entry
files ``decode_partials.cu`` (K2, dense cache) and
``paged_decode_partials.cu`` (K3, page pool)) as it ships and in variants
that each change one design choice (a textual edit of the shipped header,
which raises when the header no longer holds the text it edits), all with
``nvcc`` in parallel into ``build/decode_variants/``.  A variant named
``@PATH`` is the header at PATH as it stands, and ``--parent HEADER``
adds an older body's header verbatim as the variant ``parent`` (e.g. the
parent commit's, ``git show HEAD~1:<header> > build/parent.cuh``).  Then,
on the CUDA device, at the shapes ``chip_smoke.py`` times K2 and K3 at
(its data builders, ``benchmarks/torch_decode_data.py``):

* granite-3-8b (8 slots, 32 query over 8 kv heads, head dim 128, kv_len
  [2048, 1500, 1024, 700, 300, 64, 1, 1900], 16 splits; K2 on a 2048-slot
  dense cache, K3 on the same rows in a 1024-page pool of 16-token pages
  in random order): a decode step (P = 1, 4 rows a fiber) and verify
  chains of P = 13, 17 and 32 positions (52, 68 and 128 rows a fiber,
  ``block_k`` clamped as the model path clamps it); K3 also on fp8 e4m3
  codes at P = 1 and 13 and on int8 codes at P = 1;
* gemma2-9b's decode step at head dim 256 (4 slots, 16 over 8 heads, M
  8192) and hymba-1.5b's at head dim 64 (G = 5, M 2048), both layouts;

it checks each variant against the plain version (largest difference of
the combined output) and against ``--bits-against`` (default ``parent``
with ``--parent``, else ``shipped``: equal m, l and acc partials bit for
bit), and times each over 20 launches after 3, in two rounds (the
variants in order, then in reverse, so that a drift of the card shows):
``ms`` from CUDA events around the launches (the C entry point called
directly, no wrapper), ``device_ms`` from ``torch.profiler``'s kernel
records.  Each row gives every variant's plan (rows a block, the grid
and its blocks against the card's 132 SMs).  Unless ``--no-bits``, a
sweep then holds every variant to ``--bits-against`` bit for bit on
small data at every head dim (32, 64, 128, 256), fp32 and bf16 on both
layouts and fp32 on int8 / fp8 codes, at P = 1, 2, 3, 13 and 32 with G =
4 (``bits`` rows).

Variants (each one edit of the shipped header; one that equals another
is skipped; ``a+b`` applies both):

* ``rows_outer``  — a split's blocks of rows on grid.z (one slice after
  another, so each re-reads the split's chunks from HBM) instead of
  grid.x;
* ``free_regs``   — no register cap at 8 rows below d256 (ptxas picks
  147-156 at d128, so 3 blocks a SM instead of 4);
* ``select_lanes`` — the butterfly picks each step's kept and sent value
  by the lane's bit (two selects a pair) instead of slots permuted per
  lane;
* ``shuffle_p``   — each probability and rescale factor broadcast from
  its lane by a shuffle instead of through shared memory;
* ``no_math``     — a diagnostic, not a design: the walk, copies, merge
  and writes without the scores, softmax and value products (its outputs
  are wrong; it shows what the memory side alone costs);
* ``stages2`` / ``stages3`` / ``stages4`` — ring of 2, 3 or 4 chunks;
* ``ck16`` / ``ck32`` / ``ck64`` — 16, 32 or 64 keys a chunk;
* ``skip_off``    — every walk covers the whole tile-run range, also
  with P = 1 and no window (the trailing chunks past kv_len are walked);
* ``page_lookup`` — K3 reads each chunk's page ids from the block table
  in device memory instead of the page list in shared memory;
* ``no_key_split`` — one warp per row group walks every key of a chunk
  (the 4 warps split the rows, no cross-warp merge) instead of 4 warps
  splitting each chunk's keys;
* ``nt256``       — 8 warps a block (two row groups of 4 key warps);
* ``lb5`` / ``lb6`` — registers capped for 5 or 6 blocks a SM.

With no VARIANT the default set is ``shipped`` (and ``parent`` with
``--parent``) and the variants from ``rows_outer`` to ``no_math`` above.
Prints one JSON object per shape and writes them all to ``--out``;
``--logs`` keeps each build's ptxas report, whose registers and spills
per fp32 instantiation the ``build`` row sums up.
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

from repro_torch.kernels import _build, autotune, ops  # noqa: E402
from repro_torch.kernels import decode as dec  # noqa: E402
from repro_torch.model.layers import strict_fp32  # noqa: E402

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
HEADER = "decode_partials.cuh"
ENTRIES = {"k2": "decode_partials.cu", "k3": "paged_decode_partials.cu"}
OUT_DIR = os.path.join(ROOT, "build", "decode_variants")
SMS = autotune.H100_SMS
GRANITE_KVL = [2048, 1500, 1024, 700, 300, 64, 1, 1900]


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


LAUNCH_BOUNDS = "(RB == 8 && D < 256) ? 4 : 1"


def _rows_outer(s: str) -> str:
    s = _edit(s, """  const int row_base = blockIdx.x * RB;
  const int split = blockIdx.y;
  const int bh = blockIdx.z;""", """  const int row_base = blockIdx.z * RB;
  const int split = blockIdx.x;
  const int bh = blockIdx.y;""")
    nb = "a.R / RB + (a.R % RB != 0)"
    return _edit(s, f"const dim3 grid({nb}, a.splits, bh);",
                 f"const dim3 grid(a.splits, bh, {nb});")


def _select_lanes(s: str) -> str:
    s = _edit(s, "const int xi = my_i, xk = my_k;",
              "const int xi = 0, xk = 0;")
    return _edit(
        s, "if (i < h) v[i] = v[i] + __shfl_xor_sync(FULL, v[i + h], mask);",
        "if (i < h) {\n"
        "        const bool up = lane & mask;\n"
        "        const float keep = up ? v[i + h] : v[i];\n"
        "        const float send = up ? v[i] : v[i + h];\n"
        "        v[i] = keep + __shfl_xor_sync(FULL, send, mask);\n"
        "      }")


def _shuffle_p(s: str) -> str:
    s = _edit(s, """    if ((lane & ((1 << SH) - 1)) == 0) {
#pragma unroll
      for (int g = 0; g < NG; ++g) pw[g * NP + (lane >> SH)] = p[g];
      if (my_k == 0) pw[RW * KW + my_i] = prm;
    }
    __syncwarp();
""", "")
    s = _edit(s, "const float f = pw[RW * KW + i];",
              "const float f = __shfl_sync(FULL, prm, (i * KG) << SH);")
    return _edit(s, "pc[i] = pw[kk / KG * NP + i * KG + kk % KG];",
                 "pc[i] = __shfl_sync(FULL, p[kk / KG], "
                 "(i * KG + kk % KG) << SH);")


VARIANTS = {
    "shipped": lambda s: s,
    "rows_outer": _rows_outer,
    "free_regs": lambda s: _edit(s, LAUNCH_BOUNDS, "1"),
    "select_lanes": _select_lanes,
    "shuffle_p": _shuffle_p,
    "no_math": lambda s: _edit(s, "if (kw0 >= nk) continue;", "continue;"),
    "stages2": lambda s: _const(s, "STAGES", 2),
    "stages3": lambda s: _const(s, "STAGES", 3),
    "stages4": lambda s: _const(s, "STAGES", 4),
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
    "lb5": lambda s: _edit(s, LAUNCH_BOUNDS, "5"),
    "lb6": lambda s: _edit(s, LAUNCH_BOUNDS, "6"),
}
DEFAULT = ["shipped", "rows_outer", "free_regs", "select_lanes", "shuffle_p",
           "no_math"]
#: variants whose outputs are not meant to be right
DIAGNOSTIC = {"no_math"}


def _variant(name: str, src: str) -> str:
    """The header of ``name``: ``@PATH`` (that file), one variant, or
    several joined by ``+`` (e.g. ``ck16+stages2``), applied in order."""
    if name.startswith("@"):
        with open(name[1:]) as fh:
            return fh.read()
    for part in name.split("+"):
        src = VARIANTS[part](src)
    return src


def _layout_of(text: str) -> tuple[bool, int]:
    """(whether a split's blocks of rows lie on grid.x, threads a block)
    of a header: the shipped grid, or an older one with the rows on
    grid.z."""
    nt = re.search(r"constexpr int NT = (\d+);", text)
    return "dim3 grid(a.R / RB" in text, int(nt.group(1)) if nt else 128


def plan(layout, rows: int, splits: int, fibers: int) -> dict:
    """A launch's plan under a variant's layout, as ``launch_partials``
    in its header computes it."""
    inner, nt = layout
    rb = 4 if rows <= 4 else 8
    nb = -(-rows // rb)
    grid = (nb, splits, fibers) if inner else (splits, fibers, nb)
    blocks = nb * splits * fibers
    return dict(rows_a_block=rb, threads=nt, row_blocks=nb, grid=grid,
                blocks=blocks, blocks_per_sm=blocks / SMS)


_PTXAS = re.compile(
    r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, (\d+) "
    r"bytes spill loads.*?Used (\d+) registers", re.S)
_KERNEL = re.compile(r"decode_partials_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                     r"Lb([01])ELi(\d+)E")


def ptxas_summary(log: str) -> dict:
    """{"d<D> rb<RB> <layout>": [registers, spill stores, spill loads]} of
    the fp32, native-exp instantiations in an nvcc log."""
    out = {}
    for name, st, ld, regs in _PTXAS.findall(log):
        m = _KERNEL.search(name)
        if not m or m.group(1) != "f" or m.group(3) != "0":
            continue
        layout = ("dense" if "DenseKV" in name else
                  "int8" if re.search(r"PagedKVTIfLi\d+EaE", name) else
                  "fp8" if "fp8" in name else "paged")
        key = f"d{m.group(2)} rb{m.group(4)} {layout}"
        out[key] = [int(regs), int(st), int(ld)]
    return dict(sorted(out.items()))


def build(names: list[str], logs: str | None,
          parent: str | None = None) -> tuple[dict, dict, dict]:
    """({variant: {"k2": fn, "k3": fn}}, {variant: layout},
    {variant: {kind: ptxas summary}}) for each variant whose header
    differs from the others, all compiled at once; ``parent`` is the
    header of the variant named ``parent``."""
    shipped = open(os.path.join(CSRC, HEADER)).read()
    headers, seen = {}, {}
    for name in names:
        text = (_variant("@" + parent, shipped) if name == "parent"
                else _variant(name, shipped))
        if text in seen:
            print(f"torch_decode_variants: {name} equals {seen[text]}, "
                  f"skipped", file=sys.stderr)
            continue
        seen[text] = name
        headers[name] = text
    procs = {}
    for name, text in headers.items():
        d = os.path.join(OUT_DIR, re.sub(r"[^\w+.-]", "_", name))
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
    regs: dict = {}
    failed = set()
    for (name, kind), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if logs:
            os.makedirs(logs, exist_ok=True)
            tag = re.sub(r"[^\w+.-]", "_", name)
            with open(os.path.join(logs, f"{tag}.{kind}.log"), "w") as fh:
                fh.write(log)
        if proc.returncode:
            # a variant the kernel's static checks refuse is reported and
            # left out; the others are still measured
            print(json.dumps(dict(kind="build_failed", variant=name,
                                  entry=ENTRIES[kind], log=log[-2000:])),
                  flush=True)
            failed.add(name)
            continue
        regs.setdefault(name, {})[kind] = ptxas_summary(log)
        fn = getattr(ctypes.CDLL(lib), symbol[kind])
        fn.restype, fn.argtypes = ctypes.c_int, argtypes[kind]
        fns.setdefault(name, {})[kind] = fn
    layouts = {n: _layout_of(t) for n, t in headers.items()}
    return ({n: f for n, f in fns.items() if n not in failed}, layouts,
            {n: r for n, r in regs.items() if n not in failed})


def _load_data():
    from importlib.util import module_from_spec, spec_from_file_location

    spec = spec_from_file_location(
        "torch_decode_data",
        os.path.join(ROOT, "benchmarks", "torch_decode_data.py"))
    mod = module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DATA = _load_data()


def case(kind: str, x: dict, kvl, p: int = 1, code=None, gen=None,
         dtype=torch.float32, splits=None, block_k=None) -> dict:
    """One K2 (``kind`` "k2", the dense cache of ``x``) or K3 ("k3", its
    permuted pool, ``code`` an int8 / fp8 dtype for a quantized pool)
    launch: P chain positions (fresh queries when P > 1), the tuned splits
    and (verify-clamped) block_k unless given, the plain version's
    arguments and a description."""
    b, hq, hkv, g, m, d, ps, w = (x[k] for k in
                                  ("b", "hq", "hkv", "g", "m", "d", "ps", "w"))
    q4 = x["q"] if p == 1 else DATA.rand(torch, gen, (b, hq, p, d),
                                        torch.float32)
    q = ops._fold_decode_q(q4, b, hkv, g, d).contiguous().to(dtype)
    kvl = list(kvl)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    vbk = dict(p=p, g=max(g, 8), e=d, f=d)
    out = dict(kind=kind, q=q, kv_len=kv_len, p=p, g=g, d=d, hkv=hkv,
               dtype=dtype)
    if kind == "k2":
        tuned = autotune.decode_params(m, max(g, 8), d, d)
        out.update(k=x["k"].reshape(b * hkv, m, d).to(dtype),
                   v=x["v"].reshape(b * hkv, m, d).to(dtype), m=m)
    else:
        n_pages = x["k_pages"].shape[0]
        table = DATA.with_sentinels(x["table"], [min(n + p - 1, m)
                                               for n in kvl], ps, n_pages)
        kp, vp, ks, vs = x["k_pages"], x["v_pages"], None, None
        if code is not None:
            (kp, ks, _), (vp, vs, _) = DATA.quantized(
                torch, (kp, vp), {torch.int8: "int8",
                                  torch.float8_e4m3fn: "fp8_e4m3"}[code])
        tuned = autotune.paged_decode_params(w, ps, max(g, 8), d, d,
                                             elem_bytes=kp.element_size())
        out.update(k_pages=kp.to(dtype) if code is None else kp,
                   v_pages=vp.to(dtype) if code is None else vp,
                   k_scale=ks, v_scale=vs, table=table, n_pages=n_pages,
                   ps=ps, w=w)
    out["splits"] = splits or tuned.splits
    out["block_k"] = block_k or autotune.verify_block_k(tuned.block_k, **vbk)
    out["shape"] = (f"B{b} Hq{hq} Hkv{hkv} d{d} {str(dtype)[6:]} kv_len "
                    f"{kvl} splits {out['splits']} block_k {out['block_k']}"
                    + (f" M{m}" if kind == "k2" else
                       f" page_size {ps} W {w}, pool {x['k_pages'].shape[0]}"
                       f" pages permuted")
                    + (f" {str(code)[6:]} codes + fp16 scales" if code
                       else "")
                    + f" P={p} ({p * g} rows a fiber)")
    return out


def plain(c: dict):
    kw = dict(scale=c["d"] ** -0.5, hkv=c["hkv"], splits=c["splits"],
              block_k=c["block_k"], n_pos=c["p"], rows_per_pos=c["g"])
    if c["kind"] == "k2":
        return dec.decode_partials_torch(c["q"], c["k"], c["v"],
                                         c["kv_len"], **kw)
    return dec.paged_decode_partials_torch(
        c["q"], c["k_pages"], c["v_pages"], c["table"], c["kv_len"],
        k_scale=c["k_scale"], v_scale=c["v_scale"], **kw)


def launcher(fn, c: dict):
    """A no-argument call of ``fn`` (one variant's K2 or K3 entry point)
    on case ``c``, writing preallocated partials."""
    q, p, g, d, hkv = (c[k] for k in ("q", "p", "g", "d", "hkv"))
    bh, r = q.shape[:2]
    splits, bk = c["splits"], c["block_k"]
    pm = torch.empty((bh, splits, r), device="cuda")
    pl = torch.empty_like(pm)
    pnv = torch.empty((bh, splits, r, d), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    dt = dec.CUDA_DTYPES[q.dtype]
    ptr = dec._ptr
    if c["kind"] == "k2":
        m = c["m"]
        args = (ptr(q), ptr(c["k"]), ptr(c["v"]), ptr(c["kv_len"]), ptr(pm),
                ptr(pl), ptr(pnv), dt, d, bh, hkv, r, m, splits,
                m // splits, bk, p, g, d ** -0.5, 0, 0.0, 0, 0, stream)
    else:
        kp = c["k_pages"]
        code = dec.QUANT_CODES.get(kp.dtype, 0)
        none = ctypes.c_void_p(0)
        args = (ptr(q), ptr(kp), ptr(c["v_pages"]),
                ptr(c["k_scale"]) if code else none,
                ptr(c["v_scale"]) if code else none, ptr(c["table"]),
                ptr(c["kv_len"]), ptr(pm), ptr(pl), ptr(pnv), dt, code, d,
                bh, hkv, r, c["n_pages"], c["ps"], c["w"], splits,
                (c["w"] // splits) * c["ps"], bk, p, g, d ** -0.5, 0.0, 0,
                stream)

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return pm, pl, pnv

    return run


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


def device_ms(fn, iters: int = 20, tries: int = 3) -> float:
    """Mean kernel time per launch from the profiler's CUDA records of
    ``iters`` launches; a session in which CUPTI dropped every record is
    profiled again, up to ``tries`` sessions."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [ev.device_time_total if hasattr(ev, "device_time_total")
              else ev.cuda_time_total for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and "decode_partials_kernel" in ev.name]
        if us:
            # the mean over the launches recorded (it may drop one)
            return sum(us) / 1e3 / len(us)
    raise RuntimeError("the profiler recorded no decode_partials_kernel")


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def shapes(gen) -> dict:
    """{name: case} at the shapes chip_smoke times K2 and K3 at."""
    granite = DATA.granite_paged_data(torch, gen)
    gemma2 = DATA.gemma2_paged_data(torch, gen)
    hymba = DATA.paged_data(torch, gen, 8, 25, 5, 2048, 64)
    gem_kvl = [8192, 5000, 4096, 1]
    hym_kvl = [2048, 1536, 1300, 1024, 700, 513, 1, 1900]
    out = {}
    for kind in ("k2", "k3"):
        for p in (1, 13, 17, 32):
            out[f"{kind} granite P={p}"] = case(kind, granite, GRANITE_KVL,
                                                p, gen=gen)
        out[f"{kind} gemma2 d256 P=1"] = case(kind, gemma2, gem_kvl)
        out[f"{kind} hymba d64 G=5 P=1"] = case(kind, hymba, hym_kvl)
    for code, tag in ((torch.float8_e4m3fn, "fp8"), (torch.int8, "int8")):
        out[f"k3 granite {tag} P=1"] = case("k3", granite, GRANITE_KVL,
                                            code=code)
    out["k3 granite fp8 P=13"] = case("k3", granite, GRANITE_KVL, 13,
                                      code=torch.float8_e4m3fn, gen=gen)
    return out


def bits_sweep(fns: dict, against: str, gen) -> list:
    """Every variant against ``against`` on small data (2 slots, 16 query
    over 4 kv heads, M 512, kv_len [1, 37, 200, 470] spread over 2 x 2
    batches, 4 splits): each head dim, fp32 and bf16 on both layouts,
    int8 / fp8 codes with fp32 queries, P = 1, 2, 3, 13 and 32.  One row
    per (variant, combination): equal partials, bit for bit."""
    rows = []
    for d in dec.CUDA_HEAD_DIMS:
        x = DATA.paged_data(torch, gen, 4, 16, 4, 512, d)
        kvl = [1, 37, 200, 470]
        combos = [("k2", torch.float32, None), ("k2", torch.bfloat16, None),
                  ("k3", torch.float32, None), ("k3", torch.bfloat16, None),
                  ("k3", torch.float32, torch.int8),
                  ("k3", torch.float32, torch.float8_e4m3fn)]
        for kind, dtype, code in combos:
            for p in (1, 2, 3, 13, 32):
                c = case(kind, x, kvl, p, code=code, gen=gen, dtype=dtype,
                         splits=4, block_k=128 if kind == "k2" else 16)
                want = launcher(fns[against][kind], c)()
                want = [t.clone() for t in want]
                for name, pair in fns.items():
                    if name == against or name in DIAGNOSTIC:
                        continue
                    got = launcher(pair[kind], c)()
                    rows.append(dict(kind="bits", variant=name,
                                     against=against, kernel=kind, d=d,
                                     dtype=str(dtype)[6:],
                                     code=str(code)[6:] if code else None,
                                     p=p, rows=p * 4,
                                     same_bits=_same(got, want)))
    torch.cuda.synchronize()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="VARIANT",
                    help=f"some of {list(VARIANTS)}, several joined by "
                         f"'+', or @PATH (default: {DEFAULT})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/decode_variants.json")
    ap.add_argument("--logs", default=None,
                    help="directory for each build's ptxas report")
    ap.add_argument("--shapes", nargs="*", default=None,
                    help="substrings of the shape names to run (default: "
                         "all)")
    ap.add_argument("--parent", default=None, metavar="HEADER",
                    help="an older body's header, run verbatim as the "
                         "variant 'parent'")
    ap.add_argument("--bits-against", default=None,
                    help="the variant every other is held to bit for bit "
                         "(default: parent with --parent, else shipped)")
    ap.add_argument("--no-bits", action="store_true",
                    help="skip the bit-for-bit sweep")
    args = ap.parse_args(argv)
    unknown = {p for n in args.variants if not n.startswith("@")
               for p in n.split("+")} - set(VARIANTS) - {"parent"}
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    names = list(args.variants or DEFAULT)
    if args.parent and "parent" not in names:
        names.insert(1, "parent")
    if "parent" in names and not args.parent:
        ap.error("the variant 'parent' needs --parent HEADER")
    args.bits_against = args.bits_against or (
        "parent" if args.parent else "shipped")
    if not torch.cuda.is_available():
        print("torch_decode_variants: no CUDA device", file=sys.stderr)
        return 2
    strict_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    fns, layouts, regs = build(names, args.logs, args.parent)
    results = [dict(kind="build", device=smi, ptxas=regs,
                    layouts={n: dict(zip(("rows_on_grid_x", "nt"), v))
                             for n, v in layouts.items()})]
    print(json.dumps(results[0]), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    against = args.bits_against if args.bits_against in fns else None
    for sname, c in shapes(gen).items():
        if args.shapes and not any(s in sname for s in args.shapes):
            continue
        runs = {n: launcher(pair[c["kind"]], c) for n, pair in fns.items()}
        want = dec.combine_partials(*plain(c), torch.float32)
        err, bits = {}, {}
        ref = [t.clone() for t in runs[against]()] if against else None
        for name, run in runs.items():
            got = run()
            err[name] = (dec.combine_partials(*got, torch.float32)
                         - want).abs().max().item()
            if ref is not None:
                bits[name] = _same(got, ref)
        ms = {n: [] for n in runs}
        dev = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                ms[n].append(time_ms(runs[n]))
                dev[n].append(device_ms(runs[n]))
        bh, r = c["q"].shape[:2]
        row = dict(kernel=c["kind"], name=sname, device=smi,
                   shape=c["shape"], splits=c["splits"],
                   block_k=c["block_k"],
                   plans={n: plan(layouts[n], r, c["splits"], bh)
                          for n in runs},
                   max_abs_err=err, same_bits_as=against, same_bits=bits,
                   ms=ms, device_ms=dev)
        print(json.dumps(row), flush=True)
        results.append(row)
        torch.cuda.empty_cache()
    if against and not args.no_bits:
        rows = bits_sweep(fns, against, gen)
        bad = [r for r in rows if not r["same_bits"]]
        summary = dict(kind="bits_summary", against=against,
                       combinations=len(rows), differing=len(bad),
                       first_differing=bad[:20])
        print(json.dumps(summary), flush=True)
        results.append(summary)
        results.extend(rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
