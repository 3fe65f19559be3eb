#!/usr/bin/env python3
"""How far chip_smoke's split-stress cases of the latent kernels sit from
their gates, over several draws of their inputs.

    python3 benchmarks/torch_latent_split_draws.py [--seeds 8] \
        [--out chiprun_out/latent_split_draws.json]

Run from the root of a checkout on a machine with one CUDA card.  For each
seed it runs ``chip_smoke.run_latent_split_cases`` (K4 and K2's latent
branch on DeepSeek's latent, 128 heads: scores in the hundreds, low
mantissa bits, verify rows, pages every chunk straddles) on inputs drawn
from a generator seeded with it, and reports per case and seed the
kernel's distance to its plain fp32 version (what chip_smoke gates at
1e-4) beside the kernel's and the plain version's distances to a float64
reference, and both of chip_smoke's gates: kernel vs plain within 1e-4,
and the kernel no farther from float64 than the plain version plus
``chip_smoke.F64_SLACK``.  Prints one JSON line per case and seed, then a
summary line per case (the largest of each distance, and the draws that
would fail each gate); exits 0 whatever the draws give.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_latent_split_draws: no CUDA device visible",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import decode as dec
    from repro_torch.launch import serve
    from repro_torch.model.layers import strict_fp32

    strict_fp32()
    cs.phase_device(torch, serve)      # the card's name and power limit
    rows = []
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        for r in cs.run_latent_split_cases(torch, gen, dec):
            row = dict(seed=seed, kernel=r["kernel"], case=r["case"],
                       kernel_vs_plain=r["max_abs_err"], gate=r["atol"],
                       ok_vs_plain=r["ok_vs_plain"],
                       kernel_vs_f64=r["vs_f64"]["kernel"],
                       plain_vs_f64=r["vs_f64"]["plain"],
                       f64_slack=r["f64_slack"], ok_vs_f64=r["ok_vs_f64"])
            print(json.dumps(row), flush=True)
            rows.append(row)
    summary = []
    for case in dict.fromkeys(r["case"] for r in rows):
        mine = [r for r in rows if r["case"] == case]
        summary.append(dict(
            case=case, draws=len(mine),
            max_kernel_vs_plain=max(r["kernel_vs_plain"] for r in mine),
            max_kernel_vs_f64=max(r["kernel_vs_f64"] for r in mine),
            max_plain_vs_f64=max(r["plain_vs_f64"] for r in mine),
            failing_seeds_vs_plain=[r["seed"] for r in mine
                                    if not r["ok_vs_plain"]],
            failing_seeds_vs_f64=[r["seed"] for r in mine
                                  if not r["ok_vs_f64"]]))
        print(json.dumps(summary[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
