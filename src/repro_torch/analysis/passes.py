"""Machine-readable cascade analysis: pass counts + footprint proofs.

Runs the mapping-independent analysis of :mod:`repro_torch.core.passes` over the
registry of declared kernel cascades (:mod:`repro_torch.analysis.cascade`) and
emits, per cascade:

  * total passes over the sequence rank M (the paper's §III-A bound),
  * per-tensor minimum pass counts (the generations in which each
    tensor's full M extent is written or read),
  * the live-footprint class — ``O(1)`` when no tensor is traversed in
    two distinct generations, ``O(S)`` when some full fiber must stay
    live across a pass barrier under *every* mapping (§III-B),
  * whether the results match the declared expectations.

This is the symbolic half of the CI gate; the structural half (matching
declarations against actual kernel geometry) is :mod:`repro_torch.analysis.lint`.
"""
from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.core.passes import analyze
from repro_torch.analysis.cascade import O1, OS, CascadeEntry, REGISTRY


def analyze_entry(entry: CascadeEntry) -> dict:
    """Symbolic analysis of one registry entry (pure Python)."""
    cascade = entry.build()
    a = analyze(cascade, entry.rank)
    full_fiber = sorted(a.full_fiber_tensors())
    footprint = OS if full_fiber else O1
    tensors = {
        t: {"gens": list(gens), "passes": len(set(gens)),
            "full_fiber": len(set(gens)) > 1}
        for t, gens in sorted(a.traversal_gens.items())
    }
    problems = []
    if a.passes != entry.expected_passes:
        problems.append(
            f"declared {entry.expected_passes}-pass but analysis proves "
            f"{a.passes} passes over {entry.rank}")
    if footprint != entry.footprint:
        problems.append(
            f"declared {entry.footprint} live footprint but analysis "
            f"proves {footprint}"
            + (f" (full fibers: {', '.join(full_fiber)})" if full_fiber
               else ""))
    return {
        "name": entry.name,
        "cascade": cascade.name,
        "rank": entry.rank,
        "passes": a.passes,
        "expected_passes": entry.expected_passes,
        "bucket": entry.bucket,
        "footprint": footprint,
        "expected_footprint": entry.footprint,
        "full_fiber_tensors": full_fiber,
        "tensors": tensors,
        "kernels": list(entry.kernels),
        "peers": list(entry.peers),
        "ok": not problems,
        "problems": problems,
    }


def full_report(entries: Optional[Iterable[CascadeEntry]] = None) -> list[dict]:
    """Analyze every registry entry (or an explicit list, for tests)."""
    return [analyze_entry(e) for e in (REGISTRY if entries is None
                                       else entries)]


def taxonomy_table(entries: Optional[Iterable[CascadeEntry]] = None) -> str:
    """The generated taxonomy table (EXPERIMENTS.md §Einsum-cascade)."""
    rows = full_report(entries)
    lines = [
        "| cascade | kernels | passes over M | passes per tensor | "
        "live footprint | bucket (Table I peers) |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        per_tensor = ", ".join(
            f"{t}:{info['passes']}" for t, info in r["tensors"].items()
            if info["passes"] > 1 or t in ("K", "V", "CKV", "KR", "QK"))
        peers = f" ({', '.join(r['peers'])})" if r["peers"] else ""
        mark = "" if r["ok"] else " ⚠"
        lines.append(
            f"| {r['name']}{mark} | {'<br>'.join(r['kernels'])} | "
            f"{r['passes']} | {per_tensor or '1 each'} | "
            f"{r['footprint']} | {r['bucket']}{peers} |")
    return "\n".join(lines)


__all__ = ["analyze_entry", "full_report", "taxonomy_table"]
