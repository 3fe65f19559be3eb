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
with a dense MLP; on the card K ≤ 64 / G - 1 for a GQA arch with G query
heads per kv head), and serves the primary layout (paged when served)
once more without it, ``<layout>_nospec``, which joins ``outputs_match``;
each speculative leg reports a ``speculation`` block (drafts proposed
and accepted, committed tokens per dispatch) and the top level
``spec_vs_base_tok_per_s``.  ``--duplicates N`` appends N requests that
resend earlier prompts verbatim (FIFO admission sends each after its
original completes: the traffic where cross-request drafting pays);
``--no-speculate`` overrides ``--speculate``.

MLA archs serve on both layouts (dense: the latent cache through K2's
E ≠ F branch; paged: K4), and ``--cache-layout both`` holds their
streams to each other in ``outputs_match``; ``deepseek-v3-671b[-smoke]``
serves with its MoE cut — every FFN dense, as its first ``first_k_dense``
layers are — until MoE is ported (item 5b), and the JSON says so
(``moe_cut``).

The reference's other legs take the same flags here and exit with the
ROADMAP item that ports them: ``--mesh`` and ``--async``/``--dp``.
``--no-compile-cache`` is accepted and does nothing (XLA's cache has no
counterpart here).
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.kernels.fusemax import fusemax_attention_cuda
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving.engine import (
    Request, ServeEngine, speculation_refusal,
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


def serve_config(arch: str) -> ModelConfig:
    """The config the launcher serves for ``arch``: an MLA arch with MoE
    layers is served with its MoE cut (every FFN a dense one of ``d_ff``,
    as in its dense prefix) because MoE is not ported yet (ROADMAP §1
    item 5b); every other arch as registered."""
    cfg = get_config(arch)
    if cfg.mla is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=None, family="dense")
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_one_layout(args, cfg, model, rt, layout: str,
                      prefix_caching: bool = True,
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
                         host_swap_bytes=host_swap_bytes, device=args.device,
                         seed=args.seed)
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
    if engine.kv is not None:
        # the trace has drained: a quiescent point, so the pool's host
        # state must audit clean (raises AssertionError otherwise)
        engine.kv.check_invariants()
    del engine                   # free this layout's caches before the next
    if torch.device(args.device).type == "cuda":
        torch.cuda.empty_cache()
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


def speculation_arg(args, cfg: ModelConfig) -> Optional[int]:
    """The ``--speculate`` K the legs serve with (None: off); a K the
    engine would refuse exits here, before the model is built."""
    spec = None if args.no_speculate else args.speculate
    if spec is None:
        return None
    why = speculation_refusal(cfg, spec, temperature=args.temperature,
                              cuda=torch.device(args.device).type == "cuda")
    if why is not None:
        raise SystemExit(f"--speculate {spec} refused for {args.arch}: "
                         f"{why}")
    return spec


def serve_bench(args, cfg: Optional[ModelConfig] = None) -> dict:
    """Build the model and engine, serve the synthetic trace, return the
    metrics (``_outputs`` holds the generated streams, in request order).
    ``cfg`` overrides the config ``args.arch`` names (a library caller's
    cut of a registered arch, e.g. fewer layers)."""
    moe_cut = False
    if cfg is None:
        cfg = serve_config(args.arch)
        moe_cut = cfg != get_config(args.arch)
    spec = speculation_arg(args, cfg)
    rt = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
    model = tf.init(cfg, args.seed, rt, device=args.device)
    layouts = ["dense", "paged"] if args.cache_layout == "both" \
        else [args.cache_layout]
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
        "moe_cut": moe_cut,
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
    metrics["device"] = device_info(torch.device(args.device))
    metrics["_outputs"] = outputs[layouts[0]]
    metrics["_outputs_by_layout"] = outputs
    return metrics


#: flags of legs not ported yet → (is it set?, ROADMAP item)
_UNPORTED = (
    (lambda a: bool(a.mesh), "--mesh", "§1 item 8, device-sharded pool"),
    (lambda a: a.run_async, "--async", "§1 item 7, async front end and dp"),
    (lambda a: a.dp > 1, "--dp", "§1 item 7, async front end and dp"),
)


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
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--async", dest="run_async", action="store_true")
    ap.add_argument("--arrival-rate", type=float, default=4.0)
    ap.add_argument("--prefill-quantum", type=int, default=None)
    ap.add_argument("--long-prompt-len", type=int, default=0)
    ap.add_argument("--long-every", type=int, default=3)
    ap.add_argument("--long-new-tokens", type=int, default=None)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--dp-arrival-rate", type=float, default=None)
    ap.add_argument("--json", default="BENCH_torch_serving.json",
                    help="write metrics here ('' to disable)")
    ap.add_argument("--no-compile-cache", action="store_true")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the engine warmup (first-use costs then land "
                         "in the timed trace)")
    return ap


def main(argv: Optional[list] = None,
         cfg: Optional[ModelConfig] = None) -> dict:
    """Run the launcher on ``argv``; ``cfg`` as in :func:`serve_bench`."""
    args = _parser().parse_args(argv)
    for is_set, flag, item in _UNPORTED:
        if is_set(args):
            raise SystemExit(f"{flag} is not ported to repro_torch yet "
                             f"(ROADMAP {item})")
    metrics = serve_bench(args, cfg)
    hidden = {k: metrics.pop(k) for k in ("_outputs", "_outputs_by_layout")}
    print(f"served {metrics['requests']} requests "
          f"({metrics['tokens_decoded']} new tokens) in "
          f"{metrics['wall_s']:.2f}s → {metrics['tok_per_s']:.1f} tok/s "
          f"({metrics['slots']} slots, layout={metrics['cache_layout']}, "
          f"{metrics['dispatches']['decode']} decode dispatches, "
          f"{metrics['dispatches']['prefill']} prefill dispatches, "
          f"TTFT p50 {metrics['ttft_s']['p50']}s) on "
          f"{metrics['device']['kind']}"
          + (" — MoE cut: every FFN dense (ROADMAP §1 item 5b)"
             if metrics["moe_cut"] else ""))
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


if __name__ == "__main__":
    main()
