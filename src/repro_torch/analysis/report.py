"""The Einsum-cascade taxonomy table, and the cascade analyzer as a gate.

Port of ``repro.analysis.report``:

  python -m repro_torch.analysis.report                # the taxonomy table
  python -m repro_torch.analysis.report --check        # analyzer + probes,
                                                       # plain versions (CPU)
  python -m repro_torch.analysis.report --check --impl cuda   # the kernels

``--check`` exits non-zero on any mismatch between a declaration and its
analysis or its implementation.  The reference's dry-run and roofline
tables read XLA's compiled artifacts; the port's wait for ROADMAP item
10c, so only the taxonomy table prints here.
"""
from __future__ import annotations

import argparse
import os
import sys

#: set to append a deliberately misdeclared cascade, so that the gate is
#: seen to fail (its self-test)
INJECT_BAD_ENV = "REPRO_TORCH_ANALYSIS_INJECT_BAD"


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
                    print(f"  ok  {r['name']}: {pr['probe']} ({impl}, "
                          f"{len(pr['cases'])} cases)", file=out)
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
        "--impl", choices=("torch", "cuda"), default="torch",
        help="probe the plain versions on the CPU (torch) or the kernels "
             "on the card at the main paths' widths (cuda)")
    args = ap.parse_args(argv)
    if args.check:
        sys.exit(1 if check(impl=args.impl) else 0)
    from repro_torch.analysis.passes import taxonomy_table
    print("## Einsum-cascade analysis (declared cascades, proved bounds)\n")
    print(taxonomy_table())


if __name__ == "__main__":
    main()
