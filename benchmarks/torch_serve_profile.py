"""Where the time goes in the port's serving path, on the card.

    python benchmarks/torch_serve_profile.py [--cache-layout dense|paged]
        [--arch granite-3-8b|deepseek-v3-671b|gemma2-9b|hymba-1.5b]
        [--layers N] [--out PATH]

Builds ``--arch`` at full width (all its layers unless ``--layers`` cuts
the depth — ``--arch deepseek-v3-671b --layers 3`` is its dense prefix,
MLA + dense FFN, ``--layers 4`` adds its first MoE layer, 256 experts
of 2048, top-8, one shared, on either layout; fp32, random weights
from ``--seed``) on the CUDA device, admits 8
prompts of mixed length in [128, 1024] into a
``repro_torch.serving.ServeEngine`` on the ``--cache-layout`` (slots 8,
max_len 2048; the paged layout with its default pool of 1024 pages of
16 tokens and the prefix cache on) and runs one 16-step decode dispatch,
after one untimed warm-up round of the same work.  gemma2-9b runs its
serve cell's traffic instead: 4 prompts uniform in [4200, 6000], past
its 4096-token window, in 4 slots of max_len 8192.  hymba-1.5b (32
layers, attention beside Mamba) admits 8 prompts uniform in [513, 1024]:
its prefill phase is one dispatch of the 1024-token bucket, whose SSM
layers step every token (``ssm_ms``: the device time of the kernels
launched inside the transformer's ``"ssm"`` profiler ranges, the SSM
products included).  Each phase runs twice: once timed with CUDA events around it (wall
on the device's clock, no profiler attached) and once under
``torch.profiler`` for the per-kernel device time.  It prints one JSON
object per phase — wall ms, device-busy ms (sum of kernel durations: the
kernels of one stream do not overlap), the idle share, and the device
time grouped by layer (K1 prefill attention, K2/K3/K4 decode partials
and K2's dense latent branch,
matrix products, indexing and cache writes, reductions, elementwise and
other)
with the top kernels, the top operators by device time with their input
shapes (``top_ops``: which product is an expert's, and whether a copy
moves a weight), and the number of kernels per decode step — and
writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.model import transformer as tf  # noqa: E402
from repro_torch.model.layers import Runtime  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402


def _group(name: str) -> str:
    n = name.lower()
    if "fusemax_prefill" in n:
        return "K1 prefill attention"
    if "mla_paged_decode_partials" in n:
        return "K4 MLA paged decode partials"
    if "latent_decode_partials" in n:
        return "K2 MLA dense latent decode partials"
    if "pagedkv" in n:                 # the K3 instantiations of the body
        return "K3 paged decode partials"
    if "decode_partials" in n:
        return "K2 decode partials"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "sm90_xmma",
                            "splitk", "matmul", "dot_kernel")):
        return "matrix products"
    if "index" in n or "scatter" in n or "gather" in n:
        return "indexing / cache writes"
    if "reduce" in n:
        return "reductions (norms, softmax combine, argmax)"
    return "elementwise / other"


def _device_us(ev, self_only: bool = False) -> float:
    name = ("self_" if self_only else "") + "device_time_total"
    if hasattr(ev, name):
        return getattr(ev, name)
    return getattr(ev, name.replace("device", "cuda"))


def _profile(fn) -> tuple:
    """Device time by kernel over one call of ``fn``, and the operators
    whose kernels took the most device time, by input shapes."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    kernels: dict = {}
    ssm = [0.0, 0]
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name == tf.SSM_RANGE:  # the range's device-side marker
                continue
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += _device_us(ev) / 1e3
            k[1] += 1
        elif ev.name == tf.SSM_RANGE:
            # a CPU range: its device time is its launches' kernels'
            ssm[0] += _device_us(ev) / 1e3
            ssm[1] += 1
    ops = [{"op": a.key, "input_shapes": str(a.input_shapes)[:160],
            "device_ms": _device_us(a, self_only=True) / 1e3,
            "calls": a.count}
           for a in prof.key_averages(group_by_input_shape=True)
           if a.key.startswith("aten::") and _device_us(a, True) > 0]
    ops.sort(key=lambda o: -o["device_ms"])
    return kernels, ops[:16], ssm


def _timed(fn) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def _summary(phase: str, wall_ms: float, profiled: tuple,
             extra: dict) -> dict:
    kernels, ops, ssm = profiled
    busy = sum(v[0] for v in kernels.values())
    groups: dict = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "phase": phase, "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
        "by_layer": {g: {"ms": v[0], "launches": v[1],
                         "share_of_busy": v[0] / busy if busy else None}
                     for g, v in sorted(groups.items(),
                                        key=lambda kv: -kv[1][0])},
        "top_kernels": [{"name": n[:120], "ms": v[0], "launches": v[1]}
                        for n, v in top],
        "top_ops": ops,
        "ssm_ms": ssm[0], "ssm_calls": ssm[1],
        "ssm_share_of_busy": ssm[0] / busy if busy else None,
        **extra,
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache-layout", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--arch", default="granite-3-8b",
                    choices=("granite-3-8b", "deepseek-v3-671b",
                             "gemma2-9b", "hymba-1.5b"))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: all of the arch's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/torch_serve_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_profile: needs a CUDA device")

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    rt = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
    model = tf.init(cfg, args.seed, rt, device="cuda")
    # (slots, max_len, prompt lengths lo..hi): the arch's serve cell
    slots, max_len, lo, hi = {
        "gemma2-9b": (4, 8192, 4200, 6000),
        "hymba-1.5b": (8, 2048, 513, 1024)}.get(args.arch,
                                                (8, 2048, 128, 1024))
    rng = np.random.default_rng(args.seed)
    lens = [int(x) for x in rng.integers(lo, hi + 1, size=slots)]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]

    def fresh_engine():
        eng = ServeEngine(cfg, model, slots=slots, max_len=max_len, rt=rt,
                          cache_layout=args.cache_layout, device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=17))
        return eng

    results = []
    for rnd in ("warmup", "timed", "profiled"):
        eng = None                       # one engine's caches at a time
        torch.cuda.empty_cache()
        eng = fresh_engine()
        if rnd == "warmup":
            eng._admit()
            eng._decode_chunk()          # the one-step first dispatch
            eng._decode_chunk()          # a 16-step dispatch
            continue
        if rnd == "timed":
            t_admit = _timed(eng._admit)
            t_first = _timed(eng._decode_chunk)
            h0 = time.perf_counter()
            t_chunk = _timed(eng._decode_chunk)
            host_chunk = (time.perf_counter() - h0) * 1e3
            steps = eng.stats["decode_steps"] - 1
            continue
        k_admit = _profile(eng._admit)
        pre = dict(eng.stats)
        k_first = _profile(eng._decode_chunk)
        k_chunk = _profile(eng._decode_chunk)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    common = {"card": smi, "arch": args.arch, "layers": cfg.n_layers,
              "prompt_lens": lens,
              "cache_layout": args.cache_layout}
    results.append(_summary("prefill (all admission groups)", t_admit,
                            k_admit, dict(common, dispatches=pre[
                                "prefill_dispatches"],
                                tokens=sum(lens))))
    results.append(_summary("decode, first dispatch (1 step)", t_first,
                            k_first, dict(common, steps=1)))
    results.append(_summary(f"decode, {steps}-step dispatch", t_chunk,
                            k_chunk, dict(common, steps=steps,
                                          ms_per_step=t_chunk / steps,
                                          host_ms=host_chunk,
                                          kernels_per_step=sum(
                                              v[1] for v in k_chunk[0]
                                              .values()) / steps)))
    for r in results:
        print(json.dumps(r))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    return results


if __name__ == "__main__":
    main()
