"""Extended-Einsum cascade IR (paper §II-C, §III).

A minimal, analysis-oriented implementation of the EDGE / TeAAL "cascade of
Einsums" abstraction used by FuseMax:

  * a :class:`TensorRef` names a tensor and the ranks it is indexed by,
  * an :class:`Einsum` is one equation ``output = f(inputs)`` with explicit
    map/reduce actions and (optionally) *iterative* ranks (EDGE generative
    ranks, paper §II-C4),
  * a :class:`Cascade` is an ordered DAG of Einsums plus rank metadata
    (partitions such as ``M -> (M1, M0)``, paper §V "Fusion and
    Partitioning").

The IR is deliberately *symbolic*: it captures exactly the information the
paper's pass analysis (§III) needs — which ranks each Einsum touches, which
it reduces away, and which dependencies are prefix-only (iterative) — and no
more.  Numeric evaluation lives in :mod:`repro_torch.core.cascades_numeric`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Sequence


@dataclass(frozen=True)
class RankUse:
    """One rank index appearing on a tensor reference.

    Attributes:
      name: rank name (shape name), e.g. ``"M0"``.
      iterative: True when the tensor is indexed at the *current iteration
        coordinate* of an iterative rank (EDGE ``RY_{i+1}``-style access) —
        the dependency induced through this index is prefix-only and never
        forces a re-traversal of the fiber (paper §II-C4, §III-C2).
      filtered: True for filtering rank expressions such as ``k: k <= i``
        (paper §II-C3); a filtered consumption touches a *subset* of the
        fiber and therefore cannot act as a full-fiber barrier.
      final: True when only the final coordinate of an iterative rank is
        read (e.g. ``RNV_{f, M1, p}`` in Cascade 5, Eq. 53).  Reading a
        single coordinate is not a pass over the fiber.
    """

    name: str
    iterative: bool = False
    filtered: bool = False
    final: bool = False


def _as_rankuse(r: "str | RankUse") -> RankUse:
    if isinstance(r, RankUse):
        return r
    if not isinstance(r, str):
        raise TypeError(f"rank must be str or RankUse, got {type(r)}")
    # String shorthands: "i*" iterative, "k<=i" filtered, "M1$" final.
    if r.endswith("*"):
        return RankUse(r[:-1], iterative=True)
    if r.endswith("$"):
        return RankUse(r[:-1], final=True)
    if "<=" in r or "<" in r:
        return RankUse(r.split("<")[0].strip(), filtered=True)
    return RankUse(r)


@dataclass(frozen=True)
class TensorRef:
    """A tensor name plus the ranks indexing it, e.g. ``SN[m1, m0, p]``."""

    name: str
    ranks: tuple[RankUse, ...]

    @staticmethod
    def make(name: str, ranks: Sequence["str | RankUse"] = ()) -> "TensorRef":
        return TensorRef(name, tuple(_as_rankuse(r) for r in ranks))

    def rank_names(self) -> frozenset[str]:
        return frozenset(r.name for r in self.ranks)

    def standard_rank_names(self) -> frozenset[str]:
        """Ranks indexed in the ordinary (non-iterative, non-final) way."""
        return frozenset(
            r.name for r in self.ranks if not (r.iterative or r.final)
        )

    def __str__(self) -> str:  # pragma: no cover - debug aid
        def fmt(r: RankUse) -> str:
            s = r.name.lower()
            if r.iterative:
                s += "*"
            if r.final:
                s = r.name  # final coordinate printed as shape name
            if r.filtered:
                s += "≤i"
            return s

        if not self.ranks:
            return self.name
        return f"{self.name}[{', '.join(fmt(r) for r in self.ranks)}]"


def T(name: str, *ranks: "str | RankUse") -> TensorRef:
    """Terse constructor: ``T("SN", "M1", "M0", "P")``."""
    return TensorRef.make(name, ranks)


@dataclass(frozen=True)
class Einsum:
    """One (extended) Einsum equation.

    ``reduce_op`` applies to every input rank not present in the output
    (classic Einsum reduction semantics).  ``compute`` is a free-form label
    for the map-action compute operator (×, ÷, exp, max, …) used for
    pretty-printing and for op-count accounting in the analytical model.
    """

    output: TensorRef
    inputs: tuple[TensorRef, ...]
    compute: str = "×"
    reduce_op: str = "+"
    label: str = ""
    init: bool = False  # True for EDGE Initialization equations

    def input_rank_names(self) -> frozenset[str]:
        out: set[str] = set()
        for t in self.inputs:
            out |= t.rank_names()
        return frozenset(out)

    def reduced_ranks(self) -> frozenset[str]:
        """Ranks consumed as *standard* input ranks and absent from the
        output — i.e. fully reduced by this Einsum (non-iterative,
        non-filtered, non-final reads of the whole fiber)."""
        out_ranks = self.output.rank_names()
        reduced: set[str] = set()
        for t in self.inputs:
            for r in t.ranks:
                if r.iterative or r.filtered or r.final:
                    continue
                if r.name not in out_ranks:
                    reduced.add(r.name)
        # A rank read iteratively anywhere in this Einsum is not a full
        # reduction barrier (prefix dependency only).
        for t in self.inputs:
            for r in t.ranks:
                if r.iterative and r.name in reduced:
                    reduced.discard(r.name)
        return frozenset(reduced)

    def __str__(self) -> str:  # pragma: no cover - debug aid
        rhs = f" {self.compute} ".join(str(t) for t in self.inputs)
        red = ""
        missing = self.reduced_ranks()
        if missing and self.reduce_op != "+":
            red = f" :: ∨_{{{','.join(sorted(missing)).lower()}}} {self.reduce_op}"
        return f"{self.output} = {rhs}{red}"


class CascadeError(ValueError):
    pass


@dataclass
class Cascade:
    """An ordered sequence of Einsums forming a DAG through tensor names."""

    name: str
    einsums: list[Einsum] = field(default_factory=list)
    # rank partitioning metadata: parent rank -> tuple of child ranks,
    # e.g. {"M": ("M1", "M0")} (paper §V / Cascade 5 Eqs. 37-38).
    partitions: dict[str, tuple[str, ...]] = field(default_factory=dict)
    # ranks that alias another rank's coordinates (e.g. iteration variable
    # "I" walking rank "K" in Cascade 3): alias -> target.
    aliases: dict[str, str] = field(default_factory=dict)

    # -- construction -----------------------------------------------------
    def add(self, einsum: Einsum) -> "Cascade":
        self.einsums.append(einsum)
        return self

    def partition(self, parent: str, children: Sequence[str]) -> "Cascade":
        self.partitions[parent] = tuple(children)
        return self

    def alias(self, alias: str, target: str) -> "Cascade":
        self.aliases[alias] = target
        return self

    # -- structure --------------------------------------------------------
    def producers(self) -> dict[str, Einsum]:
        """tensor name -> Einsum producing it (last write wins for
        iterative tensors; initialization writes are ignored)."""
        prod: dict[str, Einsum] = {}
        for e in self.einsums:
            if e.init:
                continue
            prod[e.output.name] = e
        return prod

    def leaf_tensors(self) -> frozenset[str]:
        produced = {e.output.name for e in self.einsums}
        leaves: set[str] = set()
        for e in self.einsums:
            for t in e.inputs:
                if t.name not in produced:
                    leaves.add(t.name)
        return frozenset(leaves)

    def subranks(self, rank: str) -> frozenset[str]:
        """All rank names that index positions of `rank`: itself, its
        partition children (recursively) and aliases of any of those."""
        out = {rank}
        frontier = [rank]
        while frontier:
            r = frontier.pop()
            for child in self.partitions.get(r, ()):
                if child not in out:
                    out.add(child)
                    frontier.append(child)
        for a, tgt in self.aliases.items():
            if tgt in out:
                out.add(a)
        return frozenset(out)

    def validate(self) -> None:
        """Check the cascade is a well-formed DAG (each non-init Einsum's
        inputs are leaves, earlier outputs, or its own iterative self)."""
        seen: set[str] = {e.output.name for e in self.einsums if e.init}
        leaves = self.leaf_tensors()
        for e in self.einsums:
            if e.init:
                continue
            for t in e.inputs:
                if t.name in leaves or t.name in seen:
                    continue
                if t.name == e.output.name and any(
                    r.iterative for r in t.ranks
                ):
                    continue  # iterative self-reference (RY_{i+1} = f(RY_i))
                raise CascadeError(
                    f"{self.name}: Einsum '{e.output.name}' reads "
                    f"'{t.name}' before it is produced"
                )
            seen.add(e.output.name)

    def __str__(self) -> str:  # pragma: no cover - debug aid
        lines = [f"Einsum Cascade: {self.name}"]
        inits = [e for e in self.einsums if e.init]
        if inits:
            lines.append("  Initialization:")
            lines += [f"    {e}" for e in inits]
            lines.append("  Extended Einsums:")
        lines += [f"    {e}" for e in self.einsums if not e.init]
        return "\n".join(lines)
