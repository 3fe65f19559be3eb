"""The dry-run and roofline tables, the Einsum-cascade taxonomy table, and
the cascade analyzer as a gate.

Port of ``repro.analysis.report``:

  python -m repro_torch.analysis.report                # §Dry-run, §Roofline,
                                                       # the taxonomy table
  python -m repro_torch.analysis.report --check        # analyzer + probes,
                                                       # the kernels (card)
  python -m repro_torch.analysis.report --check --impl torch  # the plain
                                                       # versions (CPU)

``--check`` exits non-zero on any mismatch between a declaration and its
analysis or its implementation; on a host without a card it exits
non-zero unless ``--impl torch`` asks for the plain versions.  The tables
read the dry run's records (``repro_torch.launch.dryrun``:
``$REPRO_TORCH_DRYRUN_OUT/<mesh>/*.json``) and the roofline pass's
(``…/roofline/*.json``): FLOPs by ``FlopCounterMode``, reckoned bytes,
collective bytes by kind, and the roofline terms at the card's published
peaks.  The reference's XLA fields (compile seconds, HLO memory analysis)
have no counterpart there, and no column here.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.analysis.roofline import out_dir

#: the dry run's cells, in the order the tables list them
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

#: set to append a deliberately misdeclared cascade, so that the gate is
#: seen to fail (its self-test)
INJECT_BAD_ENV = "REPRO_TORCH_ANALYSIS_INJECT_BAD"


def _load(dirpath: str) -> dict:
    recs = {}
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"])] = r
    return recs


def _order(key):
    arch, shape = key
    return (arch, SHAPE_ORDER.index(shape) if shape in SHAPE_ORDER
            else len(SHAPE_ORDER), shape)


def _fmt_bytes(n):
    if n is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


def _fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}µs"


def _cards(recs) -> str:
    """The card names the records' peaks are of."""
    names = sorted({r["card"] for r in recs if r.get("card")})
    return ", ".join(names) or "card not recorded"


def dryrun_table() -> str:
    """One row per dry-run record of the single- and multi-pod meshes."""
    lines = [
        "| arch | shape | mesh | cards | params/card | est. peak/card "
        "(fits) | FLOPs/card | bytes/card | collective bytes/card "
        "(dominant kind) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    seen = []
    for mesh in ("single", "multi"):
        recs = _load(out_dir(mesh))
        for key in sorted(recs, key=_order):
            r = recs[key]
            seen.append(r)
            if not r.get("ok"):
                lines.append(f"| {key[0]} | {key[1]} | {mesh} | - | FAILED: "
                             f"{r.get('error', '?')} | | | | |")
                continue
            mem, coll = r["memory"], r["collectives"]
            by_kind = coll["bytes_by_kind"]
            top = max(by_kind, key=by_kind.get) if by_kind else "-"
            lines.append(
                f"| {key[0]} | {key[1]} | {mesh} | {r['chips']} | "
                f"{_fmt_bytes(mem['param_bytes'])} | "
                f"{_fmt_bytes(mem['peak_bytes_est'])} ({mem['fits']}) | "
                f"{r['cost']['flops']:.3g} | "
                f"{_fmt_bytes(r['cost']['bytes_accessed'])} | "
                f"{_fmt_bytes(coll['total_bytes'])} ({top}) |")
    return f"Peaks of: {_cards(seen)}\n\n" + "\n".join(lines)


def roofline_table() -> str:
    """One row per roofline-pass record (depth-extrapolated counts)."""
    recs = _load(out_dir("roofline"))
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPS/card | useful ratio | roofline fraction |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(recs, key=_order):
        r = recs[key]
        if not r.get("ok"):
            lines.append(f"| {key[0]} | {key[1]} | FAILED: "
                         f"{r.get('error', '?')} | | | | | | |")
            continue
        rf = r["roofline"]
        lines.append(
            f"| {key[0]} | {key[1]} | {_fmt_s(rf['compute_s'])} | "
            f"{_fmt_s(rf['memory_s'])} | {_fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {rf['model_flops_per_chip']:.3g} | "
            f"{rf['useful_ratio']:.2f} | {rf['roofline_fraction']:.3f} |")
    return f"Peaks of: {_cards(recs.values())}\n\n" + "\n".join(lines)


def summarize() -> dict:
    """{(arch, shape): roofline} of the roofline pass's ``ok`` records."""
    return {key: r["roofline"] for key, r in _load(
        out_dir("roofline")).items() if r.get("ok")}


def check(entries=None, *, structural: bool = True, impl: str = "torch",
          size=None, out=sys.stdout, results=None) -> int:
    """Run the cascade analyzer (+ the structural probes of
    :mod:`repro_torch.analysis.lint` at ``impl`` and ``size``) as a gate.

    Returns the number of failures (0 == gate passes).  ``entries``
    overrides the registry for tests; with ``REPRO_TORCH_ANALYSIS_INJECT_BAD``
    set, a 3-pass cascade declared 1-pass is appended.  ``results``, a
    list, receives the probes' per-entry results (their cases and shared
    memory) for a caller that reports them.
    """
    from repro_torch.analysis import passes as _passes
    from repro_torch.analysis.cascade import O1, REGISTRY, CascadeEntry
    from repro_torch.core.taxonomy import attention_3pass

    entries = list(REGISTRY if entries is None else entries)
    if os.environ.get(INJECT_BAD_ENV):
        entries.append(CascadeEntry(
            name="injected-bad-1pass-claim",
            build=attention_3pass,
            expected_passes=1,
            footprint=O1,
            bucket="1-pass",
        ))

    failures = 0
    for r in _passes.full_report(entries):
        if r["ok"]:
            print(f"  ok  {r['name']}: {r['passes']}-pass, "
                  f"{r['footprint']} live footprint", file=out)
        else:
            failures += 1
            for p in r["problems"]:
                print(f"FAIL  {r['name']}: {p}", file=out)

    if structural:
        from repro_torch.analysis.lint import lint_all
        for r in lint_all(entries, impl=impl, size=size):
            if results is not None:
                results.append(r)
            if r["ok"]:
                for pr in r["probes"]:
                    how = (f"traced {pr['traced']}, {pr['passes']}-pass"
                           if "traced" in pr else
                           f"{impl}, {len(pr['cases'])} cases")
                    print(f"  ok  {r['name']}: {pr['probe']} ({how})",
                          file=out)
            else:
                failures += 1
                print(f"FAIL  {r['name']}: {r['error']}", file=out)

    print(f"cascade check: {failures} failure(s) across "
          f"{len(entries)} declared cascades", file=out)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.report")
    ap.add_argument(
        "--check", action="store_true",
        help="run the cascade analyzer + structural probes as a gate "
             "(exit non-zero on any declaration/implementation mismatch)")
    ap.add_argument(
        "--impl", choices=("torch", "cuda"), default="cuda",
        help="probe the kernels on the card at the main paths' widths "
             "(cuda, the default) or the plain versions on the CPU (torch)")
    args = ap.parse_args(argv)
    if args.check:
        import torch
        if args.impl == "cuda" and not torch.cuda.is_available():
            sys.exit("report --check probes the CUDA kernels and this host "
                     "has no card; --impl torch runs the plain versions on "
                     "the CPU")
        sys.exit(1 if check(impl=args.impl) else 0)
    print("## §Dry-run (all cells × both meshes)\n")
    print(dryrun_table())
    print("\n## §Roofline (single pod, depth-extrapolated counts)\n")
    print(roofline_table())
    from repro_torch.analysis.passes import taxonomy_table
    print("\n## §Einsum-cascade analysis (declared cascades, proved "
          "bounds)\n")
    print(taxonomy_table())


if __name__ == "__main__":
    main()
