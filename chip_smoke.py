#!/usr/bin/env python3
"""Card check of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  It
imports nothing of JAX or of the JAX package.  Phases, each printing one
JSON line (``"phase": ...``):

1. device  — ``nvidia-smi`` name and power limit (also printed raw on a
             line of its own), torch and CUDA versions;
2. build   — seconds to build both kernels from ``kernels/csrc`` (nvcc,
             in parallel) and the ptxas register / shared-memory report;
3. kernels — every case of the prefill (K1) and split-K decode (K2)
             kernels against its plain torch version on the same inputs,
             with its tolerance; then each kernel's time at the shapes the
             granite-3-8b main path gives it, beside its plain version's,
             ``scaled_dot_product_attention``'s (a yardstick the port never
             calls) and the least time the card could take (``bound_ms``);
4. model   — granite-3-8b at full width cut to 4 layers, fp32: prefill 4
             mixed-length prompts and decode 8 greedy steps with
             ``attn_impl="cuda"`` and ``"torch"`` on the same weights;
             logits difference and token match rate;
5. serve   — ``repro_torch.launch.serve.main`` on the full 40-layer
             granite-3-8b (dense layout, fp32): every request gets its
             tokens, logits stay finite, and in the timed run K1 launched
             40 x prefill dispatches and K2 40 x decode steps;
6. the ``kernels`` line (launches on the main path, errors, times,
   bounds) and, last, ``{"ok": true, "device": {...}}``.

Any failed phase raises: the script then exits non-zero and prints no
result line.  It also exits non-zero when no CUDA card is visible or when
the port's sources are not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and fp32
#: non-tensor FLOP/s — the serving path is fp32, so no tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: tolerances: fp32 differs only in summation order; bf16 outputs may
#: differ by one rounding of the output (2 ulps at unit scale)
TOL = {"float32": (1e-4, 0.0), "bfloat16": (2e-2, 2.0 ** -7)}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(torch, serve) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = serve.device_info(torch.device("cuda", 0))
    emit("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0], **info)
    return info


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------

def _err(torch, out, ref, dtype_name):
    atol, rtol = TOL[dtype_name]
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    excess = (diff - (atol + rtol * r.abs())).max().item()
    return diff.max().item(), excess <= 0.0, atol, rtol


def _rand(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def k1_cases(torch):
    """(name, b, hkv, group, p, m, d, dtype, kwargs) for the prefill
    kernel."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("fp32 causal g4 d128", 2, 2, 4, 128, 128, 128, f32,
         dict(causal=True)),
        ("bf16 causal g4 d128", 2, 2, 4, 128, 128, 128, bf16,
         dict(causal=True)),
        ("fp32 causal q_offset=64 g4", 1, 2, 4, 100, 164, 128, f32,
         dict(causal=True, q_offset=64)),
        ("fp32 m_valid=200 of 256 g1 d64", 2, 2, 1, 96, 256, 64, f32,
         dict(m_valid=200)),
        ("fp32 window=48 causal g8 d64", 1, 2, 8, 96, 96, 64, f32,
         dict(causal=True, window=48)),
        ("fp32 softcap=30 causal g4", 1, 2, 4, 128, 128, 128, f32,
         dict(causal=True, softcap=30.0)),
        ("fp32 exp=maccs causal g4", 1, 2, 4, 128, 128, 128, f32,
         dict(causal=True, exp_impl="maccs")),
        ("bf16 causal g1 d128 unaligned", 1, 4, 1, 200, 200, 128, bf16,
         dict(causal=True)),
        ("bf16 window=100 causal g8 d64", 1, 1, 8, 150, 150, 64, bf16,
         dict(causal=True, window=100)),
    ]


def run_k1_cases(torch, gen, fm, tile) -> list:
    rows = []
    for name, b, hkv, g, p, m, d, dtype, kw in k1_cases(torch):
        q = _rand(torch, gen, (b * hkv, p * g, d), dtype)
        k = _rand(torch, gen, (b * hkv, m, d), dtype)
        v = _rand(torch, gen, (b * hkv, m, d), dtype)
        args = dict(scale=d ** -0.5, group=g, block_q=tile[0],
                    block_k=tile[1], **kw)
        out = fm.fusemax_attention_cuda(q, k, v, **args)
        ref = fm.fusemax_attention_torch(q, k, v, **args)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        rows.append(dict(kernel="fusemax_prefill", case=name, dtype=dn,
                         max_abs_err=err, atol=atol, rtol=rtol, ok=ok))
    return rows


def run_k2_cases(torch, gen, dec) -> list:
    rows = []
    f32, bf16 = torch.float32, torch.bfloat16
    # name, b, hkv, group, P, M, d, dtype, kv_len, splits, block_k, kwargs
    cases = [
        ("fp32 ragged kv_len incl 0,1 splits=4", 4, 8, 4, 1, 512, 128, f32,
         [0, 1, 300, 512], 4, 128, {}),
        ("bf16 ragged splits=4", 4, 8, 4, 1, 512, 128, bf16,
         [0, 1, 300, 512], 4, 128, {}),
        ("fp32 splits=1 g8 d64", 4, 2, 8, 1, 256, 64, f32,
         [7, 64, 0, 129], 1, 128, {}),
        ("fp32 splits=8 window=100", 4, 4, 4, 1, 1024, 128, f32,
         [1000, 50, 1024, 0], 8, 128, dict(window=100)),
        ("fp32 softcap=50 exp=maccs splits=4", 2, 8, 4, 1, 512, 128, f32,
         [511, 3], 4, 128, dict(softcap=50.0, exp_impl="maccs")),
        ("fp32 P=2 verify rows splits=4", 4, 8, 4, 2, 512, 128, f32,
         [0, 5, 250, 510], 4, 128, {}),
        ("bf16 P=2 verify rows g8 d64 splits=8", 2, 2, 8, 2, 1024, 64, bf16,
         [1, 1022], 8, 128, {}),
    ]
    for (name, b, hkv, g, p, m, d, dtype, kvl, splits, bk, kw) in cases:
        q = _rand(torch, gen, (b * hkv, p * g, d), dtype)
        k = _rand(torch, gen, (b * hkv, m, d), dtype)
        v = _rand(torch, gen, (b * hkv, m, d), dtype)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
        args = dict(scale=d ** -0.5, hkv=hkv, splits=splits, block_k=bk,
                    n_pos=p, rows_per_pos=g, **kw)
        out = dec.combine_partials(*dec.decode_partials_cuda(
            q, k, v, kv_len, **args), dtype)
        ref = dec.combine_partials(*dec.decode_partials_torch(
            q, k, v, kv_len, **args), dtype)
        torch.cuda.synchronize()
        dn = str(dtype).split(".")[1]
        err, ok, atol, rtol = _err(torch, out, ref, dn)
        rows.append(dict(kernel="decode_partials", case=name, dtype=dn,
                         max_abs_err=err, atol=atol, rtol=rtol, ok=ok))
    return rows


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` launches, CUDA events, warmed up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _sdpa_fn(torch, q, k, v, **kw):
    """One ``scaled_dot_product_attention`` call on the same inputs (GQA
    through ``enable_gqa`` where this torch has it, else on K/V expanded
    to the query heads before the clock starts)."""
    import torch.nn.functional as F

    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        ke = k.repeat_interleave(rep, dim=1)
        ve = v.repeat_interleave(rep, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve, **kw)


def time_k1(torch, gen, fm, tile) -> dict:
    """K1 at a granite-3-8b prefill dispatch: 4 prompts of 1024, causal,
    32 q heads over 8 kv heads, head dim 128, fp32."""
    b, hq, hkv, p, d = 4, 32, 8, 1024, 128
    g = hq // hkv
    q = _rand(torch, gen, (b, hq, p, d), torch.float32)
    k = _rand(torch, gen, (b, hkv, p, d), torch.float32)
    v = _rand(torch, gen, (b, hkv, p, d), torch.float32)
    q_f = (q.reshape(b, hkv, g, p, d).transpose(2, 3)
           .reshape(b * hkv, p * g, d).contiguous())
    k_f, v_f = k.reshape(b * hkv, p, d), v.reshape(b * hkv, p, d)
    args = dict(scale=d ** -0.5, causal=True, group=g, block_q=tile[0],
                block_k=tile[1])
    out = fm.fusemax_attention_cuda(q_f, k_f, v_f, **args)
    ref = fm.fusemax_attention_torch(q_f, k_f, v_f, **args)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: fm.fusemax_attention_cuda(q_f, k_f, v_f,
                                                          **args))
    plain_ms = time_ms(torch, lambda: fm.fusemax_attention_torch(
        q_f, k_f, v_f, **args), iters=5, warmup=1)
    library_ms = time_ms(torch, _sdpa_fn(torch, q, k, v, is_causal=True))
    # the causal bound needs p(p+1)/2 (q, k) pairs per head; each costs
    # d MACs for Q·K and d for P·V
    pairs = p * (p + 1) // 2
    flops = 4 * d * pairs * hq * b
    nbytes = 4 * (q.numel() + k.numel() + v.numel() + q.numel())
    return _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok,
                       shape=f"B{b} Hq{hq} Hkv{hkv} P=M={p} d{d} fp32 causal")


def time_k2(torch, gen, dec, autotune) -> dict:
    """K2 at a granite-3-8b decode step: 8 slots, 2048-slot cache, mixed
    kv_len, 32 q heads over 8 kv heads, head dim 128, fp32."""
    b, hq, hkv, m, d = 8, 32, 8, 2048, 128
    g = hq // hkv
    kvl = [2048, 1500, 1024, 700, 300, 64, 1, 1900]
    q = _rand(torch, gen, (b, hq, 1, d), torch.float32)
    k = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    v = _rand(torch, gen, (b, hkv, m, d), torch.float32)
    kv_len = torch.tensor(kvl, dtype=torch.int32, device="cuda")
    tuned = autotune.decode_params(m, max(g, 8), d, d)
    q_f = q.reshape(b * hkv, g, d)
    k_f, v_f = k.reshape(b * hkv, m, d), v.reshape(b * hkv, m, d)
    args = dict(scale=d ** -0.5, hkv=hkv, splits=tuned.splits,
                block_k=tuned.block_k)
    out = dec.combine_partials(*dec.decode_partials_cuda(
        q_f, k_f, v_f, kv_len, **args), torch.float32)
    ref = dec.combine_partials(*dec.decode_partials_torch(
        q_f, k_f, v_f, kv_len, **args), torch.float32)
    err, ok, _, _ = _err(torch, out, ref, "float32")
    ms = time_ms(torch, lambda: dec.decode_partials_cuda(q_f, k_f, v_f,
                                                         kv_len, **args))
    plain_ms = time_ms(torch, lambda: dec.decode_partials_torch(
        q_f, k_f, v_f, kv_len, **args), iters=5, warmup=1)
    mask = (torch.arange(m, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    library_ms = time_ms(torch, _sdpa_fn(torch, q, k, v, attn_mask=mask))
    live = sum(kvl)
    # each valid key is read once (K and V rows of every kv head), the
    # queries once, the fp32 partials written once
    nbytes = (4 * 2 * live * hkv * d + 4 * q.numel() + 4 * b
              + 4 * b * hkv * tuned.splits * g * (d + 2))
    flops = 4 * d * live * hq
    return _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok,
                       shape=f"B{b} Hq{hq} Hkv{hkv} M{m} d{d} fp32 kv_len "
                             f"{kvl} splits {tuned.splits} block_k "
                             f"{tuned.block_k}")


def _timing_row(ms, plain_ms, library_ms, flops, nbytes, err, ok, shape):
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes, max_abs_err=err, ok=ok)


# ---------------------------------------------------------------------------
# 4. model cross-check
# ---------------------------------------------------------------------------

def phase_model(torch) -> None:
    from repro_torch.configs import get_config
    from repro_torch.model import transformer as tf
    from repro_torch.model.layers import Runtime

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=4)
    rt_c = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                   param_dtype=torch.float32)
    rt_t = dataclasses.replace(rt_c, attn_impl="torch")
    model = tf.init(cfg, 0, rt_c, device="cuda")
    lens = [512, 333, 128, 45]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (len(lens), 512), generator=gen,
                         device="cuda", dtype=torch.int32)
    true_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    streams, logits_all = {}, {}
    for name, rt in (("cuda", rt_c), ("torch", rt_t)):
        caches = tf.init_cache(cfg, len(lens), 1024, torch.float32, "cuda")
        lg, caches = tf.prefill(cfg, model, {"inputs": toks}, caches, rt,
                                true_len=true_len)
        kv = true_len.clone()
        out, lgs = [], [lg]
        for _ in range(8):
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            out.append(nxt)
            kv = kv + 1
            lg, caches = tf.decode_step(cfg, model, nxt[:, None], caches, kv,
                                        rt)
            lgs.append(lg)
        streams[name] = torch.stack(out).cpu()
        logits_all[name] = torch.stack(lgs)
        del caches
    torch.cuda.synchronize()
    diff = (logits_all["cuda"] - logits_all["torch"]).abs().max().item()
    scale = logits_all["torch"].abs().max().item()
    match = (streams["cuda"] == streams["torch"]).float().mean().item()
    finite = bool(torch.isfinite(logits_all["cuda"]).all().item())
    rel_tol = 1e-4
    emit("model", config="granite-3-8b n_layers=4 fp32", prompts=lens,
         decode_steps=8, logits_max_abs_diff=diff, logits_max_abs=scale,
         rel_tol=rel_tol, token_match_rate=match, finite=finite)
    check(finite, "non-finite logits in the model cross-check")
    check(diff <= rel_tol * scale,
          f"cuda vs torch logits differ by {diff} > {rel_tol} x {scale}")
    check(match == 1.0, f"greedy token match rate {match} < 1")
    del model, logits_all
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 5. serve
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "granite-3-8b", "--cache-layout", "dense",
              "--requests", "16", "--slots", "8", "--prompt-len", "128",
              "--prompt-len-max", "1024", "--new-tokens", "64",
              "--max-len", "2048", "--repeats", "1", "--json", ""]


def phase_serve(torch, fm, dec, serve) -> dict:
    from repro_torch.configs import get_config

    n_layers = get_config("granite-3-8b").n_layers
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before it, read just after
    fm.fusemax_attention_cuda.launches = 0
    dec.decode_partials_cuda.launches = 0
    t0 = time.perf_counter()
    metrics = serve.main(SERVE_ARGS)
    wall = time.perf_counter() - t0
    launches = {"fusemax_prefill": fm.fusemax_attention_cuda.launches,
                "decode_partials": dec.decode_partials_cuda.launches}
    outputs = metrics.pop("_outputs")
    disp = metrics["dispatches"]
    timed = metrics["kernel_launches"]
    emit("serve", args=" ".join(SERVE_ARGS), seconds=wall,
         warmup_s=metrics["warmup_s"], wall_s=metrics["wall_s"],
         tok_per_s=metrics["tok_per_s"], ttft_s=metrics["ttft_s"],
         steps_per_s=metrics["steps_per_s"], dispatches=disp,
         tokens_decoded=metrics["tokens_decoded"],
         timed_run_launches=timed, main_path_launches=launches,
         logits_finite=metrics["logits_finite"],
         cache_bytes=metrics["memory"]["physical_cache_bytes"],
         max_memory_allocated=torch.cuda.max_memory_allocated())
    check(len(outputs) == 16 and all(len(o) == 64 for o in outputs),
          f"streams of lengths {[len(o) for o in outputs]}, expected 16 x 64")
    vocab = get_config("granite-3-8b").vocab
    check(all(0 <= t < vocab for o in outputs for t in o),
          "token outside the vocabulary")
    check(metrics["logits_finite"], "non-finite logits while serving")
    check(timed["fusemax_prefill"] == n_layers * disp["prefill"],
          f"K1 launched {timed['fusemax_prefill']} times in the timed run, "
          f"expected {n_layers} x {disp['prefill']} prefill dispatches")
    check(timed["decode_partials"] == n_layers * disp["decode_steps"],
          f"K2 launched {timed['decode_partials']} times in the timed run, "
          f"expected {n_layers} x {disp['decode_steps']} decode steps")
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    return launches


# ---------------------------------------------------------------------------

def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 3
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels import decode as dec
    from repro_torch.kernels import fusemax as fm
    from repro_torch.launch import serve
    from repro_torch.model.layers import strict_fp32

    strict_fp32()
    info = phase_device(torch, serve)

    secs = _build.timed_build()
    emit("build", seconds=secs, build_dir=os.path.relpath(
        _build.build_dir(), ROOT), ptxas=_build.ptxas_report())

    tile = autotune.attention_params(4096, 1024, 128, 128, impl="cuda")
    tile = (tile.block_q, tile.block_k)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = run_k1_cases(torch, gen, fm, tile) + \
        run_k2_cases(torch, gen, dec)
    for r in rows:
        emit("kernel_case", **r)
    t1 = time_k1(torch, gen, fm, tile)
    emit("kernel_time", kernel="fusemax_prefill", **t1)
    t2 = time_k2(torch, gen, dec, autotune)
    emit("kernel_time", kernel="decode_partials", **t2)
    bad = [r["case"] for r in rows if not r["ok"]]
    bad += [n for n, t in (("K1 timing shape", t1), ("K2 timing shape", t2))
            if not t["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")
    torch.cuda.empty_cache()

    phase_model(torch)
    launches = phase_serve(torch, fm, dec, serve)

    def entry(name, route, source, replaces, t):
        cases = [r["ok"] for r in rows if r["kernel"] == name]
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "cases_passed": f"{sum(cases)}/{len(cases)}",
                "ok": all(cases) and t["ok"]}

    print(json.dumps({"kernels": [
        entry("fusemax_prefill", "cuda",
              "src/repro_torch/kernels/csrc/fusemax_prefill.cu",
              "src/repro/kernels/fusemax.py:102", t1),
        entry("decode_partials", "cuda",
              "src/repro_torch/kernels/csrc/decode_partials.cu",
              "src/repro/kernels/decode.py:60", t2),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
