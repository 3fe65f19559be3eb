"""Pass-count and live-footprint analysis over Einsum cascades (paper §III).

The paper's key analytical device: given a cascade of Einsums, derive — for
any rank ``R`` and *independent of mapping* — how many **passes** over ``R``
fibers the cascade requires, where an additional pass arises whenever some
Einsum must read ``R``-indexed data *after* an earlier Einsum has fully
traversed the same fiber (a read → full-reduce → read chain, §III-A).

Model
-----
We propagate two per-tensor quantities through the cascade DAG (all relative
to a fixed analysis rank ``R``, for one abstract fiber, e.g. fixed ``p``):

  ``avail(T)``  number of complete passes over R that must have finished
                before the *first* elements of T can stream, and
  ``ready(T)``  number of passes finished when T is *entirely* produced.

Tensors are classified per consumption:

  * **full-R** — the tensor's standard ranks cover the whole extent of R
    (via the partition tree and aliases).  Reading it end-to-end *is* a
    pass; each such read is a *traversal* occurring in generation
    ``wait(consumer) + 1``.
  * **partial-R** — carries some but not all subranks of R (e.g. the
    ``LM[m1, p]`` bookkeeping in Cascade 5: one value per M0-block).
    Traversing it is O(M/M0) work, not a pass.
  * **iterative** — indexed at the current coordinate of an iterative rank:
    a prefix-only dependency (running max/denominator); leaf tensors
    streamed this way are traversed once by the iteration itself.
  * **final** — only the last iterate is read (Eq. 53); needs ``ready``.

Propagation for an Einsum ``P`` with output ``O``::

    wait(P)  = max over inputs U of
                 avail(U)   if U is full-R elementwise, partial-R element-
                            wise, or an iterative/prefix reference
                 ready(U)   if U carries no live R data per element
                            (scalars, final reads, partial-R fully dropped)
    avail(O) = wait(P) + 1  if P fully reduces a full-R input (every R
                            coordinate must be consumed before any output
                            element exists)            else wait(P)
    ready(O) = wait(P) + 1  if P traverses R (any standard full-R input, or
                            it executes inside an iteration that walks R)
                            else wait(P)

    every standard full-R input (and iteratively-streamed full-R leaf)
    is *traversed* in generation wait(P) + 1.

``passes(R) = max traversal generation``.  This reproduces the paper's
classifications exactly (Cascade 1 → 2, Cascades 2/3 → 1, attention 3-pass /
2-pass / 1-pass → 3/2/1, 3-pass + §IV-D division deferral → 2) and is, by
construction, mapping-independent: it uses only producer/consumer structure,
never a loop order.

The same machinery yields the algorithmic-minimum live footprint (§III-B):
a full-R tensor written/read in two *different* generations sits across a
pass barrier, so its entire R fiber must stay live (buffered or spilled and
re-loaded) under every possible mapping.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.einsum import Cascade, Einsum, RankUse, TensorRef


# ---------------------------------------------------------------------------
# Rank coverage
# ---------------------------------------------------------------------------

def _resolve(cascade: Cascade, name: str) -> str:
    """Follow alias chain (iteration variable -> the rank it walks)."""
    seen = set()
    while name in cascade.aliases and name not in seen:
        seen.add(name)
        name = cascade.aliases[name]
    return name


def _covers(cascade: Cascade, rank_names: frozenset[str], rank: str) -> bool:
    """Do ``rank_names`` address the full extent of ``rank``?"""
    resolved = frozenset(_resolve(cascade, r) for r in rank_names)

    def cover(r: str) -> bool:
        if r in resolved:
            return True
        children = cascade.partitions.get(r)
        if children:
            return all(cover(c) for c in children)
        return False

    return cover(rank)


def _r_subranks(cascade: Cascade, rank: str) -> frozenset[str]:
    return cascade.subranks(rank)


# ---------------------------------------------------------------------------
# Core propagation
# ---------------------------------------------------------------------------

@dataclass
class _Info:
    avail: int = 0
    ready: int = 0


@dataclass
class PassAnalysis:
    """Result of analyzing one cascade w.r.t. one rank."""

    cascade: Cascade
    rank: str
    passes: int
    #: tensor -> sorted tuple of generations in which its full-R extent is
    #: written or read (≥2 distinct generations ⇒ O(|R|) live footprint).
    traversal_gens: dict[str, tuple[int, ...]] = field(default_factory=dict)

    def full_fiber_tensors(self) -> frozenset[str]:
        """Tensors whose whole R fiber must stay live under any mapping."""
        return frozenset(
            t for t, gens in self.traversal_gens.items() if len(set(gens)) > 1
        )


def analyze(cascade: Cascade, rank: str) -> PassAnalysis:
    cascade.validate()
    sub = _r_subranks(cascade, rank)
    leaves = cascade.leaf_tensors()
    info: dict[str, _Info] = {t: _Info(0, 0) for t in leaves}
    traversals: dict[str, list[int]] = {}

    def note_traversal(tensor: str, gen: int) -> None:
        traversals.setdefault(tensor, []).append(gen)

    def standard_names(t: TensorRef) -> frozenset[str]:
        return t.standard_rank_names()

    def has_r(t: TensorRef) -> bool:
        return any(r.name in sub for r in t.ranks)

    def is_full_r(t: TensorRef) -> bool:
        # Standard or iterative indices both address coordinates of R for
        # coverage purposes (an iterative index walks the full extent).
        names = frozenset(
            r.name for r in t.ranks if not r.final
        )
        return _covers(cascade, names, rank)

    def standard_full_r(t: TensorRef) -> bool:
        return _covers(cascade, standard_names(t), rank)

    for e in cascade.einsums:
        if e.init:
            # Initialization equations define leaves / zero-states.
            info.setdefault(e.output.name, _Info(0, 0))
            continue

        out_r_standard = {
            r.name for r in e.output.ranks
            if r.name in sub and not (r.iterative or r.final)
        }
        iterates_r = any(
            r.iterative and _resolve(cascade, r.name) in sub | {rank}
            for t in (e.output, *e.inputs)
            for r in t.ranks
        )

        wait = 0
        full_reduce = False
        traversed_inputs: list[str] = []

        for t in e.inputs:
            iterative_ref = any(r.iterative for r in t.ranks)
            final_ref = any(r.final for r in t.ranks)
            filtered_ref = any(r.filtered and r.name in sub for r in t.ranks)
            u = info.get(t.name, _Info(0, 0))

            if final_ref:
                wait = max(wait, u.ready)
                continue
            if filtered_ref:
                # §II-C3: a filtered expression touches a *subset* of each
                # R fiber — it streams alongside the consumer and never
                # acts as a full-fiber barrier (no traversal, no reduce).
                wait = max(wait, u.avail)
                continue
            if iterative_ref:
                # Prefix dependency; a *leaf* streamed through the iteration
                # is traversed once by the pass the iteration performs.
                wait = max(wait, u.avail)
                if t.name in leaves and is_full_r(t):
                    traversed_inputs.append(t.name)
                continue
            if standard_full_r(t):
                # Full-R tensor, read end-to-end: a traversal.
                traversed_inputs.append(t.name)
                wait = max(wait, u.avail)
                r_names = standard_names(t) & sub
                if not (r_names & out_r_standard):
                    # every R coordinate consumed before any output element
                    full_reduce = True
                continue
            if has_r(t):
                # Partial-R bookkeeping (e.g. LM[m1, p]).
                r_names = standard_names(t) & sub
                if r_names & out_r_standard:
                    wait = max(wait, u.avail)   # streams alongside
                else:
                    wait = max(wait, u.ready)   # reduced away: needs all
                continue
            # No R content: scalars / other-rank tensors.
            wait = max(wait, u.ready)

        gen = wait + 1
        for t_name in traversed_inputs:
            note_traversal(t_name, gen)

        traverses = bool(traversed_inputs) or iterates_r
        avail = wait + 1 if full_reduce else wait
        ready = wait + 1 if traverses else wait
        # A full-R output is itself written over a whole generation.
        if standard_full_r(e.output) and traverses:
            note_traversal(e.output.name, gen)
        info[e.output.name] = _Info(avail=avail, ready=max(ready, avail))

    n_passes = max((g for gens in traversals.values() for g in gens), default=0)
    return PassAnalysis(
        cascade=cascade,
        rank=rank,
        passes=n_passes,
        traversal_gens={t: tuple(sorted(g)) for t, g in traversals.items()},
    )


def count_passes(cascade: Cascade, rank: str) -> int:
    """Number of passes over ``rank`` fibers (paper §III-A), for any mapping."""
    return analyze(cascade, rank).passes


@dataclass(frozen=True)
class FootprintReport:
    """Algorithmic-minimum live footprint of one tensor (paper §III-B)."""

    tensor: str
    full_fiber: bool  # must the whole R fiber stay live?


def min_live_footprint(cascade: Cascade, rank: str) -> dict[str, FootprintReport]:
    """Which tensors must keep a full ``rank`` fiber live (O(|R|) buffer or
    spill/reload traffic), under *every* mapping?  (paper §III-B)"""
    a = analyze(cascade, rank)
    out: dict[str, FootprintReport] = {}
    for t, gens in a.traversal_gens.items():
        out[t] = FootprintReport(tensor=t, full_fiber=len(set(gens)) > 1)
    return out


def classify_passes(cascade: Cascade, rank: str) -> str:
    """Human-readable taxonomy bucket (paper Table I)."""
    return f"{count_passes(cascade, rank)}-pass"
