"""Serving launcher: the continuous-batching engine over the FuseMax kernels.

  python -m repro_torch.launch.serve --arch gemma2-9b-smoke --requests 6 \
      --slots 4 --max-len 256

Port of ``repro.launch.serve`` for the dense and paged cache layouts:
builds the model from a seed on ``--device`` (``cuda`` by default;
``cpu`` runs the plain torch path), warms each engine up, serves a seeded
synthetic trace ``--repeats`` times per layout and reports the median
run — tok/s, time to first token, decode steps/s, dispatch counts, cache
bytes, prefix reuse and the CUDA kernel launches of that run — in the
reference's JSON schema, plus the device it ran on, written to
``BENCH_torch_serving.json``.

``--cache-layout both`` serves the trace on the dense and the paged
layout and reports ``outputs_match`` (greedy streams equal across
layouts); with ``--shared-prefix-len N`` every prompt starts with the
same N tokens, and the paged layout is served once more with the prefix
cache off (``paged_noprefix``), which joins ``outputs_match``.  Every
paged leg ends with the pool's invariant audit
(``PagedKVCache.check_invariants``), which raises on a violation.

Quantized pages and the host swap tier (paged layouts): ``--kv-dtype
fp8_e4m3|int8`` serves the trace once more on a quantized pool
(``paged_quant``); quantization changes the numbers, so that leg stays
out of ``outputs_match`` and its greedy streams are compared with the
exact paged leg under ``quant_quality``.  ``--host-swap-gb G`` serves a
``paged_swap`` leg whose evicted prefix chains demote to G GiB of host
memory and promote back on a hit — lossless, so it joins
``outputs_match`` — and, with ``--kv-dtype``, gives the quantized leg the
swap tier too.  ``--pool-mb M`` sizes every paged leg's full pool from M
MiB instead of ``--num-pages`` (a quantized leg gets about 3.9x the
pages).  Each leg with the swap tier reports its host time in
``host_swap_ms``.

Speculative decoding: ``--speculate K`` serves every leg with an n-gram
proposer drafting K tokens a slot and one verify dispatch per step
(greedy only, on archs whose every layer is global GQA or MLA attention
with a dense MLP), and serves the primary layout (paged when served)
once more without it, ``<layout>_nospec``, which joins ``outputs_match``;
each speculative leg reports a ``speculation`` block (drafts proposed
and accepted, committed tokens per dispatch) and the top level
``spec_vs_base_tok_per_s``.  ``--duplicates N`` appends N requests that
resend earlier prompts verbatim (FIFO admission sends each after its
original completes: the traffic where cross-request drafting pays);
``--no-speculate`` overrides ``--speculate``.

SSM and hybrid archs (``xlstm-125m``, ``hymba-1.5b``) serve on both
layouts, their recurrent state dense per slot beside the pages; as in the
reference they take no prefix cache and no ``--speculate``.  The frame and
patch front ends (``musicgen-large``, ``pixtral-12b``) take embeddings,
not token prompts: the launcher refuses them and names the model-level
entry points that take them.

MLA archs serve on both layouts (dense: the latent cache through K2's
E ≠ F branch; paged: K4), and ``--cache-layout both`` holds their
streams to each other in ``outputs_match``.  MoE archs
(``deepseek-v3-671b``, ``llama4-maverick-400b-a17b``) serve their expert
layers (``repro_torch.model.moe``); as in the reference they take no
prefix cache and no ``--speculate``.

Open-loop async serving (``--async``): the seeded trace (every
``--long-every``-th prompt ``--long-prompt-len`` tokens long with its own
``--long-new-tokens`` budget) arrives as Poisson traffic at
``--arrival-rate`` and is served by :class:`AsyncServeEngine` on the
dense layout, the paged layout with the prefix cache off
(``paged_noprefix``) and on (``paged``), each prompt in
``--prefill-quantum``-token slices between decode dispatches on the
paged legs, and by the synchronous paged engine on the same arrivals
(``sync_open_loop``); ``outputs_match`` holds every leg's greedy streams
to the synchronous engine's, and the paged leg's TTFT / ITL tails are
set beside the synchronous one's (``itl_p95_sync_over_async``).  ``--dp
N`` serves the trace once more through N paged replicas sharing the one
model behind the prefix-affinity router, at ``--dp-arrival-rate``.
Each leg reports its dispatches, kernel launches, ``logits_finite`` and
the device; the JSON goes to ``BENCH_torch_serving_async.json``.

``--mesh tp=N`` serves the trace once more with the paged pool sharded
over N devices (kv-head / latent-rank partitioning, the
``paged_sharded`` leg, which joins ``outputs_match``), reports
``mesh``, ``sharded_vs_paged_tok_per_s`` and the per-device bytes under
``memory.sharding``; with ``--async --dp M`` each of the M replicas
shards its pool over its own N devices.  The devices are the visible
CUDA ones (too few exit with a message), or those a library caller
passes as ``devices=`` — a list may repeat a device, so one card (or the
CPU) holds every shard.  ``--no-compile-cache`` is accepted and does
nothing (XLA's cache has no counterpart here).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.kernels.decode import (
    decode_partials_cuda, latent_decode_partials_cuda,
    mla_paged_decode_partials_cuda, paged_decode_partials_cuda,
)
from repro_torch.distributed.sharding import visible_devices
from repro_torch.kernels.fusemax import fusemax_attention_cuda
from repro_torch.launch.mesh import make_mesh, make_replica_meshes
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving.engine import (
    Request, ServeEngine, speculation_refusal,
)
from repro_torch.serving.scheduler import (
    AsyncRequest, AsyncServeEngine, DataParallelAsyncEngine, WallClock,
    latency_metrics, poisson_arrivals, serve_open_loop,
)


def _trace_lens(args) -> list:
    rng = np.random.default_rng(args.seed)
    hi = args.prompt_len_max
    if hi is None or hi <= args.prompt_len:
        lens = [args.prompt_len] * args.requests
    else:
        lens = [int(x) for x in
                rng.integers(args.prompt_len, hi + 1, size=args.requests)]
    if args.shared_prefix_len:
        lens = [max(p, args.shared_prefix_len + 1) for p in lens]
    return lens


def device_info(device: torch.device) -> dict:
    """Which device a result came from: platform, kind, count."""
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def kernel_launches() -> dict:
    """Launches of each CUDA kernel so far in this process."""
    return {"fusemax_prefill": fusemax_attention_cuda.launches,
            "decode_partials": decode_partials_cuda.launches,
            "paged_decode_partials": paged_decode_partials_cuda.launches,
            "mla_paged_decode_partials":
                mla_paged_decode_partials_cuda.launches,
            "latent_decode_partials": latent_decode_partials_cuda.launches}


def quant_kernel_launches() -> dict:
    """Launches so far of the decode kernels on quantized pools, by code
    dtype (part of :func:`kernel_launches`' counts)."""
    return {"paged_decode_partials":
                dict(paged_decode_partials_cuda.launches_by_code),
            "mla_paged_decode_partials":
                dict(mla_paged_decode_partials_cuda.launches_by_code)}


def n_pos_kernel_launches() -> dict:
    """Launches so far of each decode kernel by draft positions: ``1`` a
    decode step, ``P`` a verify chain (part of :func:`kernel_launches`'
    counts)."""
    return {w.__name__.removesuffix("_cuda"): dict(w.launches_by_n_pos)
            for w in (decode_partials_cuda, paged_decode_partials_cuda,
                      mla_paged_decode_partials_cuda,
                      latent_decode_partials_cuda)}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _parse_mesh(arg: Optional[str], devices=None):
    """``--mesh tp=N`` → a one-axis ("model",) mesh of the first N of
    ``devices`` (default: the visible CUDA devices), over which the paged
    pool shards.  None / empty / tp=1 → no mesh."""
    if not arg:
        return None
    try:
        key, n = arg.split("=")
        n = int(n)
    except ValueError:
        raise SystemExit(f"--mesh expects tp=N, got {arg!r}")
    if key != "tp":
        raise SystemExit(f"--mesh expects tp=N, got {arg!r}")
    if n <= 1:
        return None
    devs = visible_devices() if devices is None else list(devices)
    if n > len(devs):
        raise SystemExit(
            f"--mesh tp={n} needs {n} devices but only {len(devs)} are "
            f"visible (a library caller may pass devices=, e.g. one "
            f"device repeated)")
    return make_mesh(n, devs)


def _serve_one_layout(args, cfg, model, rt, layout: str,
                      prefix_caching: bool = True, mesh=None,
                      speculate: Optional[int] = None,
                      kv_dtype: Optional[str] = None,
                      host_swap_bytes: int = 0) -> dict:
    pool_bytes = None
    if layout == "paged" and args.pool_mb:
        # a byte budget: a quantized leg gets more pages from the same bytes
        pool_bytes = int(args.pool_mb * (1 << 20))
    engine = ServeEngine(cfg, model, slots=args.slots, max_len=args.max_len,
                         rt=rt, temperature=args.temperature,
                         decode_chunk=args.decode_chunk,
                         prefill_chunk=args.prefill_chunk,
                         cache_layout=layout, page_size=args.page_size,
                         num_pages=args.num_pages,
                         prefix_caching=prefix_caching,
                         speculate=speculate, kv_dtype=kv_dtype,
                         pool_bytes=pool_bytes,
                         host_swap_bytes=host_swap_bytes, mesh=mesh,
                         device=args.device, seed=args.seed)
    lens = _trace_lens(args)
    warmup_s = None
    if not args.no_warmup:
        warmup_s = round(engine.warmup(sorted(set(lens))), 4)
        _sync(engine.device)

    runs = []
    for _ in range(max(1, args.repeats)):
        for k in engine.stats:
            engine.stats[k] = 0
        # each repeat serves the identical trace: a warm index would absorb
        # runs 2..N, so every run starts from an empty one — and so does
        # the proposer, whose warm table would report same-trace-rerun
        # acceptance instead of the duplicate traffic's
        engine.clear_prefix_cache()
        if engine.proposer is not None:
            engine.proposer.clear()
        rng = np.random.default_rng(args.seed)
        sp = args.shared_prefix_len
        shared = rng.integers(0, cfg.vocab, size=(sp,)) if sp else None
        launches0 = kernel_launches()
        quant0 = quant_kernel_launches()
        n_pos0 = n_pos_kernel_launches()
        if engine.kv is not None:
            engine.kv.swap_ms = {k: 0.0 for k in engine.kv.swap_ms}
        t0 = time.perf_counter()
        reqs = []
        for rid, plen in enumerate(lens):
            prompt = rng.integers(0, cfg.vocab, size=(plen - sp,)) if sp \
                else rng.integers(0, cfg.vocab, size=(plen,))
            if sp:
                prompt = np.concatenate([shared, prompt])
            req = Request(rid=rid, prompt=prompt.astype(np.int32),
                          max_new_tokens=args.new_tokens)
            reqs.append(req)
            engine.submit(req)
        for j in range(args.duplicates):
            # duplicate traffic: resend earlier prompts verbatim (FIFO
            # admission sends a duplicate after its original completed —
            # the cross-request drafting workload)
            req = Request(rid=len(lens) + j,
                          prompt=reqs[j % len(lens)].prompt.copy(),
                          max_new_tokens=args.new_tokens)
            reqs.append(req)
            engine.submit(req)
        engine.run()
        _sync(engine.device)
        launches = _delta(kernel_launches(), launches0)
        quant = {k: _delta(v, quant0[k])
                 for k, v in quant_kernel_launches().items()}
        n_pos = {k: {n: c for n, c in _delta(v, n_pos0[k]).items() if c}
                 for k, v in n_pos_kernel_launches().items()}
        swap_ms = None if engine.kv is None else dict(engine.kv.swap_ms)
        runs.append((time.perf_counter() - t0, dict(engine.stats), reqs,
                     launches, quant, n_pos, swap_ms))
    runs.sort(key=lambda r: r[0])
    dt, stats, reqs, launches, quant, n_pos, swap_ms = runs[len(runs) // 2]
    engine.stats.update(stats)

    total_new = sum(len(r.generated) for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    ttfts = [r.ttft for r in reqs if r.ttft is not None]
    memory = engine.memory_stats()
    finite = engine.logits_finite()
    prefix_on = engine.kv is not None and engine.kv.prefix_enabled
    spec_k = engine.spec_k
    graph = engine.decode_graph_info()
    if engine.kv is not None:
        # the trace has drained: a quiescent point, so the pool's host
        # state must audit clean (raises AssertionError otherwise)
        engine.kv.check_invariants()
    del engine                   # free this layout's caches before the next
    _empty_cache(args.device)
    out = {
        "cache_layout": layout,
        "prefix_caching": prefix_on,
        "prefix": {
            "hits": stats["prefix_hits"],
            "hit_rate": round(stats["prefix_hits"] / len(reqs), 3),
            "tokens_reused": stats["tokens_reused"],
            "cow_copies": stats["cow_copies"],
            "tokens_prefilled": stats["tokens_prefilled"],
            "prompt_tokens": prompt_tokens,
            "prefill_savings": round(
                1.0 - stats["tokens_prefilled"] / max(prompt_tokens, 1), 3),
        },
        "warmup_s": warmup_s,
        "wall_s": round(dt, 4),
        "tok_per_s": round(total_new / dt, 2),
        "ttft_s": {
            "mean": round(float(np.mean(ttfts)), 4) if ttfts else None,
            "p50": round(float(np.median(ttfts)), 4) if ttfts else None,
            "max": round(float(np.max(ttfts)), 4) if ttfts else None,
        },
        "steps_per_s": round(stats["decode_steps"] / dt, 2),
        "dispatches": {
            "prefill": stats["prefill_dispatches"],
            "decode": stats["decode_dispatches"],
            "decode_steps": stats["decode_steps"],
        },
        "tokens_decoded": stats["tokens_decoded"],
        "preemptions": stats["preemptions"],
        "peak_live_tokens": stats["peak_live_tokens"],
        "memory": memory,
        # CUDA kernel launches during the reported run (0 on the CPU), and
        # those on quantized pools by code dtype
        "kernel_launches": launches,
        "kernel_launches_by_kv_dtype": quant,
        # the decode kernels' launches by draft positions (1: decode steps,
        # k + 1: verify dispatches)
        "kernel_launches_by_n_pos": n_pos,
        # host ms of the swap tier's demotions and promotions in that run
        "host_swap_ms": swap_ms,
        "logits_finite": finite,
        # the captured decode step: its mode, the run's replays, and the
        # capture's seconds, pool bytes and counted launches a replay
        "decode_graph": graph,
        "_outputs": [list(r.generated) for r in reqs],
    }
    if spec_k is not None:
        out["speculation"] = {
            "k": spec_k,
            "dispatches": stats["spec_dispatches"],
            "proposed": stats["spec_proposed"],
            "accepted": stats["spec_accepted"],
            "accept_rate": round(
                stats["spec_accepted"] / max(1, stats["spec_proposed"]), 3),
            # committed tokens per model evaluation (every decode dispatch,
            # speculative or not, is one): what has to beat 1.0 for
            # speculation to pay
            "accepted_per_dispatch": round(
                stats["tokens_decoded"] / max(1, stats["decode_dispatches"]),
                3),
        }
    return out


def speculation_arg(args, cfg: ModelConfig,
                    sharded: bool = False) -> Optional[int]:
    """The ``--speculate`` K the legs serve with (None: off); a K the
    engine would refuse (``sharded``: with ``--mesh``) exits here, before
    the model is built."""
    spec = None if args.no_speculate else args.speculate
    if spec is None:
        return None
    why = speculation_refusal(cfg, spec, temperature=args.temperature,
                              sharded=sharded)
    if why is not None:
        raise SystemExit(f"--speculate {spec} refused for {args.arch}: "
                         f"{why}")
    return spec


def _token_config(args, cfg: Optional[ModelConfig]) -> ModelConfig:
    """``cfg``, or the config ``args.arch`` names; exits on an arch whose
    front end does not take token prompts."""
    if cfg is None:
        cfg = get_config(args.arch)
    if cfg.frontend != "tokens":
        # the reference's launcher fails on these configs (its engine
        # embeds the synthetic token prompts through frontend_proj)
        raise SystemExit(
            f"--arch {args.arch}: the {cfg.frontend!r} front end takes "
            f"precomputed [B, S, d] embeddings, and the serving engine "
            f"serves token prompts only; run it at the model level "
            f"(repro_torch.model.transformer.forward / prefill / "
            f"decode_step)")
    return cfg


def serve_bench(args, cfg: Optional[ModelConfig] = None,
                devices=None) -> dict:
    """Build the model and engine, serve the synthetic trace, return the
    metrics (``_outputs`` holds the generated streams, in request order).
    ``cfg`` overrides the config ``args.arch`` names (a library caller's
    cut of a registered arch, e.g. fewer layers); ``devices`` are those
    ``--mesh`` draws on (default: the visible CUDA devices)."""
    cfg = _token_config(args, cfg)
    layouts = ["dense", "paged"] if args.cache_layout == "both" \
        else [args.cache_layout]
    mesh = _parse_mesh(args.mesh, devices)
    if mesh is not None and "paged" not in layouts:
        raise SystemExit("--mesh shards the paged pool; add "
                         "--cache-layout paged (or both)")
    spec = speculation_arg(args, cfg, sharded=mesh is not None)
    rt = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
    model = tf.init(cfg, args.seed, rt, device=args.device)
    prefix = not args.no_prefix_cache
    per_layout = {lo: _serve_one_layout(args, cfg, model, rt, lo,
                                        prefix_caching=prefix,
                                        speculate=spec)
                  for lo in layouts}
    if args.shared_prefix_len and "paged" in layouts and prefix:
        # shared-prefix trace mode: the paged layout once more with the
        # prefix cache off — greedy streams must be identical either way
        per_layout["paged_noprefix"] = _serve_one_layout(
            args, cfg, model, rt, "paged", prefix_caching=False,
            speculate=spec)
        layouts = layouts + ["paged_noprefix"]
    base_lo = "paged" if "paged" in layouts else layouts[0]
    if spec is not None:
        # the speculation A/B: the identical trace once more WITHOUT
        # speculation on the primary layout — outputs_match then holds
        # spec to non-spec streams, and the tok/s ratio is the speedup
        per_layout[base_lo + "_nospec"] = _serve_one_layout(
            args, cfg, model, rt, base_lo, prefix_caching=prefix)
        layouts = layouts + [base_lo + "_nospec"]
    if mesh is not None:
        # the device-sharded pool: the identical trace once more with the
        # pool split over the mesh — outputs_match then holds the sharded
        # streams to the single-pool ones, and memory.sharding.per_device
        # shows the 1/tp residency
        per_layout["paged_sharded"] = _serve_one_layout(
            args, cfg, model, rt, "paged", prefix_caching=prefix, mesh=mesh)
        layouts = layouts + ["paged_sharded"]
    swap_bytes = int((args.host_swap_gb or 0) * (1 << 30))
    if swap_bytes and "paged" in per_layout:
        # the swap tier is lossless (pages round-trip bit for bit through
        # host memory), so this leg joins outputs_match
        per_layout["paged_swap"] = _serve_one_layout(
            args, cfg, model, rt, "paged", prefix_caching=prefix,
            speculate=spec, host_swap_bytes=swap_bytes)
        layouts = layouts + ["paged_swap"]
    quant_leg = None
    if args.kv_dtype and "paged" in per_layout:
        # quantized pages change the numbers: this leg stays out of
        # outputs_match and its drift from the exact paged leg is reported
        # as quant_quality; with --host-swap-gb it carries the swap tier
        quant_leg = "paged_quant"
        per_layout[quant_leg] = _serve_one_layout(
            args, cfg, model, rt, "paged", prefix_caching=prefix,
            speculate=spec, kv_dtype=args.kv_dtype,
            host_swap_bytes=swap_bytes)
        layouts = layouts + [quant_leg]
    outputs = {lo: per_layout[lo].pop("_outputs") for lo in layouts}
    metrics = {
        "arch": args.arch,
        "n_layers": cfg.n_layers,
        "requests": args.requests,
        "slots": args.slots,
        "prompt_len": args.prompt_len,
        "prompt_len_max": args.prompt_len_max,
        "new_tokens": args.new_tokens,
        "decode_chunk": args.decode_chunk,
        "page_size": args.page_size,
        "num_pages": args.num_pages,
    }
    # the primary layout's fields stay top-level, as in the reference
    metrics.update({k: v for k, v in per_layout[layouts[0]].items()
                    if k != "cache_layout"})
    metrics["cache_layout"] = args.cache_layout
    metrics["shared_prefix_len"] = args.shared_prefix_len
    metrics["kv_dtype"] = args.kv_dtype
    metrics["pool_mb"] = args.pool_mb
    metrics["host_swap_gb"] = args.host_swap_gb or 0
    metrics["layouts"] = per_layout
    match_legs = [lo for lo in layouts if lo != quant_leg]
    if len(match_legs) >= 2:
        metrics["outputs_match"] = all(
            outputs[lo] == outputs[match_legs[0]] for lo in match_legs[1:])
    if quant_leg is not None:
        # the quantized leg's greedy-stream drift from the exact paged leg:
        # the positionwise token match rate and the streams that survive
        ref, q = outputs["paged"], outputs[quant_leg]
        tot = hit = exact = 0
        for a, b in zip(ref, q):
            tot += max(len(a), len(b))
            hit += sum(1 for x, y in zip(a, b) if x == y)
            exact += int(a == b)
        metrics["quant_quality"] = {
            "kv_dtype": args.kv_dtype,
            "vs_layout": "paged",
            "token_match_rate": round(hit / max(1, tot), 4),
            "exact_streams": exact,
            "streams": len(ref),
        }
    if "dense" in per_layout and "paged" in per_layout:
        d, p = per_layout["dense"], per_layout["paged"]
        metrics["paged_vs_dense_tok_per_s"] = round(
            p["tok_per_s"] / max(d["tok_per_s"], 1e-9), 3)
    if spec is not None:
        metrics["duplicates"] = args.duplicates
        metrics["speculation"] = dict(
            per_layout[base_lo]["speculation"],
            spec_vs_base_tok_per_s=round(
                per_layout[base_lo]["tok_per_s"]
                / max(per_layout[base_lo + "_nospec"]["tok_per_s"], 1e-9),
                3))
    if mesh is not None:
        metrics["mesh"] = {"tp": int(mesh.shape["model"]),
                           "axes": list(mesh.axis_names),
                           "devices": [str(d) for d in mesh.devices]}
        if "paged" in per_layout:
            metrics["sharded_vs_paged_tok_per_s"] = round(
                per_layout["paged_sharded"]["tok_per_s"]
                / max(per_layout["paged"]["tok_per_s"], 1e-9), 3)
    metrics["device"] = device_info(torch.device(args.device))
    metrics["_outputs"] = outputs[layouts[0]]
    metrics["_outputs_by_layout"] = outputs
    return metrics


def _async_trace(args, cfg) -> tuple:
    """The open-loop trace: (prompts, decode budgets).  The usual seeded
    trace (shared prefix / mixed lengths supported), with every
    ``--long-every``-th request replaced by a ``--long-prompt-len``
    prompt with its own ``--long-new-tokens`` budget — short interactive
    streams decode while long-prompt jobs keep arriving, and a
    synchronous engine's whole-prompt admission prefill stalls every
    in-flight stream (the interleave stress case)."""
    rng = np.random.default_rng(args.seed)
    lens = _trace_lens(args)
    budgets = [args.new_tokens] * len(lens)
    if args.long_prompt_len:
        k = max(2, args.long_every or 3)
        long_new = args.long_new_tokens or args.new_tokens
        for i in range(len(lens)):
            if i % k == k - 1:
                lens[i] = args.long_prompt_len
                budgets[i] = long_new
    sp = args.shared_prefix_len
    shared = rng.integers(0, cfg.vocab, size=(sp,)) if sp else None
    prompts = []
    for plen in lens:
        tail = rng.integers(0, cfg.vocab, size=(plen - sp,)) if sp \
            else rng.integers(0, cfg.vocab, size=(plen,))
        prompts.append(
            (np.concatenate([shared, tail]) if sp else tail)
            .astype(np.int32))
    return prompts, budgets


def _fresh_requests(prompts, budgets, arrivals, t0) -> list:
    return [AsyncRequest(rid=i, prompt=p.copy(), max_new_tokens=int(b),
                         arrival=t0 + float(a))
            for i, (p, b, a) in enumerate(zip(prompts, budgets,
                                              arrivals))]


def _async_engine(args, cfg, model, rt, *, layout, prefix_caching,
                  clock=None, mesh=None) -> AsyncServeEngine:
    return AsyncServeEngine(
        cfg, model, slots=args.slots, max_len=args.max_len, rt=rt,
        temperature=args.temperature, decode_chunk=args.decode_chunk,
        prefill_chunk=args.prefill_chunk, cache_layout=layout,
        page_size=args.page_size, num_pages=args.num_pages,
        prefix_caching=prefix_caching, prefill_quantum=args.prefill_quantum,
        clock=clock, mesh=mesh, device=args.device, seed=args.seed)


def _leg_summary(engines, reqs, launches: dict) -> dict:
    """The reference's per-leg summary (latency tails, dispatches,
    preemptions, reuse; summed over replicas) with the leg's kernel
    launches, whether every logits block stayed finite, and the device."""
    out = latency_metrics(reqs)
    out["dispatches"] = {
        k: sum(e.stats[s] for e in engines) for k, s in (
            ("prefill", "prefill_dispatches"),
            ("decode", "decode_dispatches"),
            ("decode_steps", "decode_steps"))}
    out["preemptions"] = sum(e.stats["preemptions"] for e in engines)
    out["tokens_reused"] = sum(e.stats["tokens_reused"] for e in engines)
    out["kernel_launches"] = launches
    out["decode_graph"] = {
        "modes": sorted({e.decode_graph_mode for e in engines}),
        "replays": sum(e.stats["decode_graph_replays"] for e in engines)}
    out["logits_finite"] = all(e.logits_finite() for e in engines)
    out["device"] = device_info(engines[0].device)
    for e in engines:
        if e.kv is not None:
            # the trace has drained: the pool's host state must audit clean
            e.kv.check_invariants()
    return out


def _timed_serve(device: torch.device, serve) -> dict:
    """Run ``serve()`` and return the kernel launches it made."""
    _sync(device)
    launches0 = kernel_launches()
    serve()
    _sync(device)
    return _delta(kernel_launches(), launches0)


def serve_async_bench(args, cfg: Optional[ModelConfig] = None,
                      devices=None) -> dict:
    """Open-loop async serving bench: the same seeded Poisson arrival
    trace served through (a) the async engine on dense / paged /
    paged+prefix — greedy streams held to a synchronous engine's
    (``outputs_match``), (b) the synchronous engine open-loop on the
    paged+prefix layout for the tail-latency comparison
    (``itl_p95_sync_over_async``), and (c, ``--dp N``) N replicas behind
    the prefix-affinity router for the routed prefix reuse, each replica's
    pool sharded over its own ``--mesh tp=M`` devices (drawn from
    ``devices``, by default the visible CUDA devices).  ``cfg`` as in
    :func:`serve_bench`."""
    if args.speculate and not args.no_speculate:
        raise SystemExit("--speculate does not combine with --async yet "
                         "(the fused verify dispatch conflicts with "
                         "mid-prefill slots)")
    cfg = _token_config(args, cfg)
    mesh = _parse_mesh(args.mesh, devices)
    tp = 1 if mesh is None else int(mesh.shape["model"])
    meshes = None
    if args.dp > 1:
        try:
            meshes = make_replica_meshes(args.dp, tp, devices)
        except ValueError as e:
            raise SystemExit(f"--dp {args.dp} --mesh {args.mesh}: {e}")
    rt = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
    model = tf.init(cfg, args.seed, rt, device=args.device)
    prompts, budgets = _async_trace(args, cfg)
    lens = sorted({len(p) for p in prompts})
    arr = poisson_arrivals(args.arrival_rate, len(prompts), seed=args.seed)

    # every leg's greedy streams must equal the synchronous engine's:
    # scheduling changes when a token is computed, never what
    outputs, timed = {}, {}
    legs = {"dense": ("dense", False),
            "paged_noprefix": ("paged", False),
            "paged": ("paged", True)}
    for name, (layout, prefix) in legs.items():
        eng = _async_engine(args, cfg, model, rt, layout=layout,
                            prefix_caching=prefix)
        warm = None
        if not args.no_warmup:
            warm = round(eng.warmup(lens), 4)
        reqs = _fresh_requests(prompts, budgets, arr, eng.clock.now())
        launches = _timed_serve(eng.device, lambda: eng.serve_trace(reqs))
        outputs[name] = [list(r.generated) for r in reqs]
        timed[name] = _leg_summary([eng], reqs, launches)
        timed[name]["warmup_s"] = warm
        timed[name]["interleave"] = eng.interleave
        del eng                  # free this leg's caches before the next
        _empty_cache(args.device)

    sync_ref = ServeEngine(
        cfg, model, slots=args.slots, max_len=args.max_len, rt=rt,
        temperature=args.temperature, decode_chunk=args.decode_chunk,
        prefill_chunk=args.prefill_chunk, cache_layout="paged",
        page_size=args.page_size, num_pages=args.num_pages,
        prefix_caching=True, device=args.device, seed=args.seed)
    if not args.no_warmup:
        sync_ref.warmup(lens)
    sync_clock = WallClock()
    sreqs = _fresh_requests(prompts, budgets, arr, sync_clock.now())
    launches = _timed_serve(sync_ref.device, lambda: serve_open_loop(
        sync_ref, sreqs, clock=sync_clock))
    outputs["sync"] = [list(r.generated) for r in sreqs]
    outputs_match = all(outputs[n] == outputs["sync"] for n in legs)
    sync_lat = _leg_summary([sync_ref], sreqs, launches)
    del sync_ref
    _empty_cache(args.device)

    a = timed["paged"]
    ratio = None
    if a["itl_s"]["p95"] and sync_lat["itl_s"]["p95"]:
        ratio = round(sync_lat["itl_s"]["p95"] / a["itl_s"]["p95"], 3)

    metrics = {
        "arch": args.arch,
        "n_layers": cfg.n_layers,
        "mode": "async_open_loop",
        "requests": len(prompts),
        "slots": args.slots,
        "arrival_rate": args.arrival_rate,
        "seed": args.seed,
        "prompt_len": args.prompt_len,
        "long_prompt_len": args.long_prompt_len or 0,
        "long_every": args.long_every or 3,
        "shared_prefix_len": args.shared_prefix_len,
        "new_tokens": args.new_tokens,
        "decode_chunk": args.decode_chunk,
        "prefill_quantum": args.prefill_quantum or (args.prefill_chunk
                                                    or 32),
        "page_size": args.page_size,
        "outputs_match": outputs_match,
        "async": a,
        "async_legs": timed,
        "sync_open_loop": sync_lat,
        "itl_p95_sync_over_async": ratio,
        "tok_per_s": a["tok_per_s"],
        "ttft_s": a["ttft_s"],
        "device": device_info(torch.device(args.device)),
    }

    if args.dp > 1:
        # every replica shares the model's weights and owns its page pool,
        # unsharded at tp = 1 (make_replica_meshes gives no mesh) or
        # sharded over its own tp devices
        clock = WallClock()
        engines = []
        for replica_mesh in meshes:
            e = _async_engine(args, cfg, model, rt, layout="paged",
                              prefix_caching=True, clock=clock,
                              mesh=replica_mesh)
            if not args.no_warmup:
                e.warmup(lens)
            engines.append(e)
        dpe = DataParallelAsyncEngine(engines)
        # arrival-time routing is the point: the prefix index evolves as
        # earlier requests prefill, so a lower rate gives each arrival a
        # registered prefix to match
        dp_rate = args.dp_arrival_rate or args.arrival_rate
        dp_arr = poisson_arrivals(dp_rate, len(prompts), seed=args.seed)
        dreqs = _fresh_requests(prompts, budgets, dp_arr, clock.now())
        launches = _timed_serve(engines[0].device,
                                lambda: dpe.serve_trace(dreqs))
        outputs["dp"] = [list(r.generated) for r in dreqs]
        leg = _leg_summary(engines, dreqs, launches)
        metrics["dp"] = dict(
            dpe.stats_summary(),
            tp=tp,
            arrival_rate=dp_rate,
            latency=latency_metrics(dreqs),
            outputs_match=outputs["dp"] == outputs["sync"],
            dispatches=leg["dispatches"],
            preemptions=leg["preemptions"],
            kernel_launches=launches,
            logits_finite=leg["logits_finite"],
            decode_graph=leg["decode_graph"],
            device=leg["device"],
        )
        metrics["outputs_match"] = outputs_match and \
            metrics["dp"]["outputs_match"]
        del dpe, engines, e
        _empty_cache(args.device)
    metrics["_outputs_by_leg"] = outputs
    return metrics


def _empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma2-9b-smoke")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain torch versions)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-len-max", type=int, default=None,
                    help="mixed-length trace: prompts uniform in "
                         "[prompt-len, prompt-len-max]")
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--repeats", type=int, default=3,
                    help="serve the trace N times and report the median run")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-chunk", type=int, default=16,
                    help="tokens decoded per fused dispatch")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="split prompts into chunks of this many tokens "
                         "inside the prefill dispatch")
    ap.add_argument("--cache-layout", default="dense",
                    choices=("dense", "paged", "both"),
                    help="KV-cache layout; 'both' A/Bs the two and "
                         "cross-checks greedy outputs")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per page (paged layout)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="full-class pool size in pages (paged layout); "
                         "default = dense-equivalent slots*max_len/page")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="trace mode: every prompt starts with the same "
                         "N-token prefix; the paged layout is also served "
                         "with the prefix cache off and joins "
                         "outputs_match")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable automatic prefix caching on the paged "
                         "layout")
    ap.add_argument("--speculate", type=int, default=None, metavar="K",
                    help="speculative decoding (greedy only): draft K "
                         "tokens a slot with the n-gram proposer and verify "
                         "the chain in one dispatch; adds a "
                         "'<layout>_nospec' leg on the same trace, which "
                         "joins outputs_match")
    ap.add_argument("--no-speculate", action="store_true",
                    help="force speculation off (overrides --speculate)")
    ap.add_argument("--duplicates", type=int, default=0, metavar="N",
                    help="trace mode: append N requests resending earlier "
                         "prompts verbatim (cycling over the originals)")
    ap.add_argument("--kv-dtype", default=None, choices=("fp8_e4m3", "int8"),
                    help="also serve the paged layout on pages of these "
                         "codes with fp16 scales ('paged_quant', out of "
                         "outputs_match; its drift under 'quant_quality')")
    ap.add_argument("--pool-mb", type=float, default=None,
                    help="full-class pool budget in MiB for the paged legs "
                         "(overrides --num-pages): a quantized leg gets "
                         "more pages from the same bytes")
    ap.add_argument("--host-swap-gb", type=float, default=0,
                    help="host swap tier of this many GiB: evicted prefix "
                         "pages demote to host memory and promote back on "
                         "a hit; adds a lossless 'paged_swap' leg to "
                         "outputs_match")
    ap.add_argument("--mesh", default=None,
                    help="shard the paged pool across devices: tp=N splits "
                         "every page array's kv-head / latent-rank axis "
                         "over N devices and serves the trace once more as "
                         "the 'paged_sharded' leg (in outputs_match; "
                         "per-device bytes under memory.sharding); with "
                         "--async --dp M, each replica shards over its "
                         "own N devices")
    ap.add_argument("--async", dest="run_async", action="store_true",
                    help="open-loop async serving: seeded Poisson arrivals "
                         "at --arrival-rate, per-token timestamps, prefill "
                         "quanta interleaved with decode; reports TTFT / "
                         "ITL tails and holds every leg's greedy streams to "
                         "the synchronous engine's (writes "
                         "BENCH_torch_serving_async.json unless --json "
                         "overrides)")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="offered load in requests/s for --async")
    ap.add_argument("--prefill-quantum", type=int, default=None,
                    help="tokens per interleaved prefill slice on the "
                         "async engine (default: --prefill-chunk or 32)")
    ap.add_argument("--long-prompt-len", type=int, default=0,
                    help="async trace: every --long-every-th request gets "
                         "a prompt this long")
    ap.add_argument("--long-every", type=int, default=3,
                    help="period of long prompts in the async trace")
    ap.add_argument("--long-new-tokens", type=int, default=None,
                    help="decode budget of the long-prompt requests "
                         "(default: --new-tokens)")
    ap.add_argument("--dp", type=int, default=1,
                    help="async: serve the trace once more through N paged "
                         "replicas behind the prefix-affinity router (tp "
                         "per replica from --mesh)")
    ap.add_argument("--dp-arrival-rate", type=float, default=None,
                    help="offered load of the --dp leg (default: "
                         "--arrival-rate)")
    ap.add_argument("--json", default="BENCH_torch_serving.json",
                    help="write metrics here ('' to disable)")
    ap.add_argument("--no-compile-cache", action="store_true")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the engine warmup (first-use costs then land "
                         "in the timed trace)")
    return ap


def main(argv: Optional[list] = None, cfg: Optional[ModelConfig] = None,
         devices=None) -> dict:
    """Run the launcher on ``argv``; ``cfg`` and ``devices`` as in
    :func:`serve_bench`."""
    args = _parser().parse_args(argv)
    if args.run_async:
        return _main_async(args, cfg, devices)
    metrics = serve_bench(args, cfg, devices)
    hidden = {k: metrics.pop(k) for k in ("_outputs", "_outputs_by_layout")}
    print(f"served {metrics['requests']} requests "
          f"({metrics['tokens_decoded']} new tokens) in "
          f"{metrics['wall_s']:.2f}s → {metrics['tok_per_s']:.1f} tok/s "
          f"({metrics['slots']} slots, layout={metrics['cache_layout']}, "
          f"{metrics['dispatches']['decode']} decode dispatches, "
          f"{metrics['dispatches']['prefill']} prefill dispatches, "
          f"TTFT p50 {metrics['ttft_s']['p50']}s) on "
          f"{metrics['device']['kind']}")
    for lo, m in metrics["layouts"].items():
        mem = m["memory"]
        print(f"  {lo}: {m['tok_per_s']:.1f} tok/s, peak resident "
              f"{mem['peak_resident_cache_bytes']} B "
              f"({mem['bytes_per_live_token']} B/live-token), "
              f"physical {mem['physical_cache_bytes']} B, "
              f"preemptions {m['preemptions']}")
        ht = mem.get("host_tier")
        if ht and ht.get("enabled"):
            print(f"    host swap tier: {ht['demotions']} demotions, "
                  f"{ht['promotions']} promotions (hit rate "
                  f"{ht['promote_hit_rate']:.2f}), {ht['host_drops']} "
                  f"drops, {ht['demoted_pages']} pages "
                  f"({ht['demoted_bytes']} B) resident on host; host ms "
                  f"demote {m['host_swap_ms']['demote']:.2f}, promote "
                  f"{m['host_swap_ms']['promote']:.2f}")
        sh = mem.get("sharding")
        if sh:
            pd = sh["per_device"]
            print(f"    pool sharded tp={sh['tp']} over '{sh['axis']}': "
                  f"per-device peak resident "
                  f"{pd['peak_resident_cache_bytes']} B, physical "
                  f"{pd['physical_cache_bytes']} B")
        pf = m["prefix"]
        if pf["tokens_reused"]:
            print(f"    prefix cache: {pf['hits']} hits "
                  f"(rate {pf['hit_rate']}), {pf['tokens_reused']} tokens "
                  f"reused, {pf['cow_copies']} COW copies, prefill "
                  f"dispatch savings {pf['prefill_savings']:.1%} "
                  f"({pf['tokens_prefilled']}/{pf['prompt_tokens']} "
                  f"prompt tokens prefilled)")
    if "outputs_match" in metrics:
        print(f"  greedy outputs match across layouts: "
              f"{metrics['outputs_match']}")
    if "sharded_vs_paged_tok_per_s" in metrics:
        print(f"  sharded/paged tok/s = "
              f"{metrics['sharded_vs_paged_tok_per_s']} on "
              f"{metrics['mesh']['devices']}")
    qq = metrics.get("quant_quality")
    if qq:
        print(f"  quantized leg ({qq['kv_dtype']}): token match rate "
              f"{qq['token_match_rate']} vs {qq['vs_layout']}, "
              f"{qq['exact_streams']}/{qq['streams']} streams exact")
    sp = metrics.get("speculation")
    if sp:
        print(f"  speculation k={sp['k']}: accept rate {sp['accept_rate']} "
              f"({sp['accepted']}/{sp['proposed']} drafts), "
              f"{sp['accepted_per_dispatch']} committed tokens/dispatch, "
              f"spec/base tok/s = {sp['spec_vs_base_tok_per_s']}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(metrics, fh, indent=1)
    metrics.update(hidden)
    return metrics


def _main_async(args, cfg: Optional[ModelConfig], devices=None) -> dict:
    if args.json == "BENCH_torch_serving.json":
        args.json = "BENCH_torch_serving_async.json"
    metrics = serve_async_bench(args, cfg, devices)
    hidden = metrics.pop("_outputs_by_leg")
    a, s = metrics["async"], metrics["sync_open_loop"]
    print(f"async open-loop @ {metrics['arrival_rate']} req/s: "
          f"{a['served']}/{a['requests']} served, "
          f"{a['tok_per_s']:.1f} tok/s, TTFT p95 "
          f"{a['ttft_s']['p95']}s, ITL p95 {a['itl_s']['p95']}s "
          f"(sync open-loop ITL p95 {s['itl_s']['p95']}s → "
          f"sync/async = {metrics['itl_p95_sync_over_async']}) on "
          f"{metrics['device']['kind']}")
    print(f"  greedy streams match sync engine: "
          f"{metrics['outputs_match']}")
    dp = metrics.get("dp")
    if dp:
        print(f"  dp={dp['dp']} x tp={dp['tp']} routed: tokens_reused "
              f"{dp['tokens_reused']} (per replica "
              f"{[p['tokens_reused'] for p in dp['per_replica']]}), "
              f"routing {dp['routing']['prefix_routed']} by prefix / "
              f"{dp['routing']['load_routed']} by load")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(metrics, fh, indent=1)
    metrics["_outputs_by_leg"] = hidden
    return metrics


if __name__ == "__main__":
    main()
