"""Roofline pass: per-card FLOPs / bytes / collectives by depth
extrapolation.

Port of ``repro.launch.roofline_pass``.  The reference compiles two
small unrolled depth variants per cell (XLA counts a scanned layer once)
and extrapolates every quantity, affine in the repeats of the dominant
layer run, to the full depth:

    q(reps) = q_fixed + reps · q_layer

On meta tensors the dry run counts the full depth as cheaply as a short
one, so here the pass is a check of that affinity: on a uniform stack the
extrapolated count equals the full-depth count
(:func:`run_cell`'s ``full_depth`` beside ``quantities``).

Writes ``$REPRO_TORCH_DRYRUN_OUT/roofline/<arch>__<shape>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback

from repro_torch.analysis.roofline import card_peaks, out_dir, roofline
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.launch import dryrun as dr


def depth_variants(cfg):
    """Returns (variants, reps_of_variant, reps_full) — each variant is a
    structurally-identical config with reduced repeats of the dominant
    layer run."""
    r = dataclasses.replace
    if cfg.moe is not None and cfg.moe.first_k_dense:      # deepseek
        return ([r(cfg, n_layers=5), r(cfg, n_layers=7)], [2, 4], 58)
    if cfg.moe is not None and cfg.moe.moe_every == 2:     # llama4
        return ([r(cfg, n_layers=4), r(cfg, n_layers=8)], [2, 4], 24)
    if cfg.local_global_every:                             # gemma2
        return ([r(cfg, n_layers=4), r(cfg, n_layers=8)], [2, 4], 21)
    if cfg.family == "hybrid":                             # hymba
        return ([r(cfg, n_layers=5, hybrid_global_layers=(0, 2, 4)),
                 r(cfg, n_layers=7, hybrid_global_layers=(0, 3, 6))],
                [2, 4], 29)
    if cfg.family == "ssm":                                # xlstm
        return ([r(cfg, n_layers=6, slstm_layers=(1, 3)),
                 r(cfg, n_layers=8, slstm_layers=(1, 3))],
                [4, 6], 10)
    return ([r(cfg, n_layers=2), r(cfg, n_layers=4)], [2, 4], cfg.n_layers)


def measure(cfg, shape, microbatches, **kw) -> dict:
    """One variant's dry-run quantities per card."""
    rec = dr.lower_cell(cfg.name, shape, cfg=cfg, microbatches=microbatches,
                        **kw)
    return {"flops": rec["cost"]["flops"],
            "bytes": rec["cost"]["bytes_accessed"],
            "coll": rec["collectives"]["total_bytes"],
            "memory": rec["memory"]}


def extrapolate(qa, qb, ra, rb, rf):
    slope = {k: (qb[k] - qa[k]) / (rb - ra)
             for k in ("flops", "bytes", "coll")}
    return {k: qa[k] + slope[k] * (rf - ra)
            for k in ("flops", "bytes", "coll")}, slope


def run_cell(arch, shape, force=False, microbatches=1, **kw):
    """The extrapolated quantities of one cell beside the full depth's and
    their roofline (``kw``: :func:`~repro_torch.launch.dryrun.lower_cell`
    overrides)."""
    path = out_dir("roofline", f"{arch}__{shape}.json")
    if os.path.exists(path) and not force:
        print(f"[skip] {arch}/{shape}")
        with open(path) as f:
            return json.load(f)
    cfg = kw.pop("cfg", None) or get_config(arch)
    cell = SHAPES[shape]
    mb = microbatches if cell.kind == "train" else 1
    try:
        variants, reps, rf = depth_variants(cfg)
        qa = measure(variants[0], shape, mb, **kw)
        qb = measure(variants[1], shape, mb, **kw)
        q, slope = extrapolate(qa, qb, reps[0], reps[1], rf)
        full = measure(cfg, shape, mb, **kw)
        tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                      else 1)
        rep = roofline(arch=arch, shape=shape, mesh="single", chips=256,
                       hlo_flops=q["flops"], hlo_bytes=q["bytes"],
                       collective_bytes=q["coll"], tokens=tokens,
                       train=cell.kind == "train", cfg=cfg)
        rec = {"arch": arch, "shape": shape, "ok": True,
               "card": card_peaks().name, "method": "depth-extrapolated",
               "variants": {"a": qa, "b": qb, "reps": reps, "full": rf},
               "per_layer": slope, "quantities": q,
               "full_depth": {k: full[k] for k in ("flops", "bytes",
                                                   "coll")},
               "roofline": rep.to_dict()}
    except Exception as e:
        rec = {"arch": arch, "shape": shape, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-1500:]}
    os.makedirs(out_dir("roofline"), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "ok  " if rec.get("ok") else "FAIL"
    print(f"[{status}] roofline {arch}/{shape}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    fails = 0
    for arch, cfg in ARCHS.items():
        if args.arch and arch != args.arch:
            continue
        for shape in SHAPES:
            if args.shape and shape != args.shape:
                continue
            if cell_applicable(cfg, shape):
                fails += 0 if run_cell(arch, shape, args.force).get("ok") \
                    else 1
    print(f"roofline pass done; {fails} failures")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
