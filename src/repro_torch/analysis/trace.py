"""Pass counts read off the port's torch code: the counterpart of the
reference's jaxpr tracer (``repro.analysis.lint.trace_m_passes``).

The reference traces a function to a jaxpr and propagates, equation by
equation, two generations per value: ``avail``, the pass in which its
elements stream, and ``ready``, the pass after which all of it is known.
A tensor that carries the (distinctively sized) sequence axis is
*traversed* by each equation that reads it, in generation ``wait + 1``,
where ``wait`` is the latest generation its operands are available or
ready at; a reduction over the whole sequence yields a value ready one
generation later.  The largest generation is the pass count; a tensor
traversed in two generations stays live across a pass barrier, an O(S)
footprint.

Here :class:`~torch.overrides.TorchFunctionMode` runs ``fn`` eagerly on
small CPU tensors and sees one call per ``torch.einsum``, ``amax``,
``where``, ``__getitem__`` — the granularity of a jaxpr's equations.
(At the aten level, under ``TorchDispatchMode``, an einsum becomes
``view`` / ``permute`` / ``bmm`` and a view can fold the sequence axis
into a neighbour, which hides it from a rule that reads sizes.)  Tensors
are tracked by identity for the whole trace.  The mode is not
re-entrant, so what a recorded call does inside is not recorded again;
a call that returns one of its inputs unchanged (``x.float()`` on fp32)
is, like JAX's elided conversion, no equation at all.  The generic rule
is the reference's, equation for equation.

torch has no ``scan``: the port's plain versions walk key tiles in
Python loops, which trace unrolled.  The reference's generic rule never
raises a generation through a *partial* tile, so an unrolled two-loop
2-pass function would trace as 1 pass.  The counterpart of its ``scan``
rule comes from data flow instead:

* a *tile* — a slice or gather (``__getitem__``, ``index_select``,
  ``narrow``, ``split`` …) of a full sequence tensor X that is not full
  itself — carries the positions of X it holds (found by applying the
  same indexing to a map of X's positions) and a read event of its own;
  views of one storage (K and K reshaped into blocks) are one X.
  It is a read of X, noted against X, in the generation of each call
  that consumes it: one more than the generation its other operands are
  ready at;
* values computed from a tile keep its positions while they keep its
  innermost position axis; a value that reduces it away records the
  reads it depends on, by generation (its *coverage*);
* a value becomes *complete* over X at generation g once the reads of
  generation g it depends on cover X's whole sequence: the running state
  after the last tile, or a global max built from every tile.  It is
  then ready at g, and a read that waits on it is at g + 1 — except a
  read of the *last* tile folded into the completion (the latest read
  event it covers): the online cascade folds each tile into the running
  max and then rescales that same tile by it, which is no second read.
  Any other tile it covers, kept from the first loop and read again, is
  read at g + 1; the exempt read still counts towards coverage at g + 1,
  so that a third loop over kept tiles waits on the second.

That gives 1 for the online loop, 2 for a loop that finds the global max
and then sweeps again, and 3 for the three-loop form.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.cascade import O1, OS, CascadeEntry


class LintError(AssertionError):
    """A kernel's structure contradicts its declared cascade."""


@dataclass
class TorchTrace:
    passes: int
    #: shapes of tensors traversed in ≥ 2 distinct generations (O(S) live)
    multi_gen: list


#: calls that take part of their first operand: on a full sequence tensor
#: whose result is not full, they make tiles
INDEXING = frozenset({
    "__getitem__", "index_select", "narrow", "select", "gather",
    "take_along_dim", "split", "split_with_sizes", "chunk", "unbind",
    "tensor_split",
})


@dataclass
class _Info:
    avail: int = 0
    #: ready without the completions of ``cov`` (those are added on reading)
    base: int = 0
    #: tile positions: root → {read event: frozenset of positions}
    pos: dict = field(default_factory=dict)
    #: innermost position-axis sizes of the tiles in ``pos``
    extents: frozenset = frozenset()
    #: reads depended on: root → {generation: {event: positions}}
    cov: dict = field(default_factory=dict)


def _name(func) -> str:
    return getattr(func, "__name__", str(func))


def _in_place(name: str) -> bool:
    return name == "__setitem__" or (name.startswith("__i")
                                     and name.endswith("__")) \
        or (name.endswith("_") and not name.endswith("__"))


def _merge_cov(dst: dict, src: dict) -> None:
    for root, by_gen in src.items():
        d_root = dst.setdefault(root, {})
        for g, evs in by_gen.items():
            d_root.setdefault(g, {}).update(evs)


class _Recorder(TorchFunctionMode):
    """Records the generation rule over every torch call it sees."""

    def __init__(self, m_total: int, m_pairs: tuple):
        super().__init__()
        self.m_total = m_total
        self.m_pairs = m_pairs
        self.part_sizes = {d for p in m_pairs for d in p}
        self.info: dict = {}
        self.keep: list = []          # every tensor seen: ids stay unique
        self.notes: dict = {}
        self.shapes: dict = {}
        self.all_pos: dict = {}       # root → frozenset of its positions
        self.events = itertools.count()

    # -- the reference's size classes --------------------------------------
    def is_full(self, shape) -> bool:
        if self.m_total in shape:
            return True
        return any(a in shape and b in shape for a, b in self.m_pairs)

    def is_partial(self, shape) -> bool:
        return not self.is_full(shape) and any(d in shape
                                               for d in self.part_sizes)

    def has_m(self, shape) -> bool:
        return self.is_full(shape) or self.is_partial(shape)

    # -- bookkeeping -------------------------------------------------------
    def get(self, t: torch.Tensor) -> _Info:
        return self.info.get(id(t), _Info())

    def put(self, t: torch.Tensor, info: _Info) -> None:
        self.keep.append(t)
        self.info[id(t)] = info

    def note(self, key, shape, gen: int) -> None:
        self.notes.setdefault(key, set()).add(gen)
        self.shapes.setdefault(key, tuple(shape))

    def ready(self, info: _Info, exclude: frozenset,
              exempt: dict | None = None) -> int:
        """``info``'s ready generation.  A completion at g whose last read
        event is one of ``exclude`` (the tiles being read now) counts only
        if it holds without that event; otherwise the event is added to
        ``exempt`` at g + 1, the generation the read would have had."""
        r = info.base
        for root, by_gen in info.cov.items():
            for g, evs in by_gen.items():
                if g <= r:
                    continue
                last = max(evs)
                seen = set().union(*(pos for ev, pos in evs.items()
                                     if ev != last or ev not in exclude))
                if seen >= self.all_pos[root]:
                    r = g
                elif seen | evs[last] >= self.all_pos[root] \
                        and exempt is not None:
                    exempt.setdefault(root, {}).setdefault(g + 1, {})[
                        last] = evs[last]
        return r

    def position_map(self, x: torch.Tensor) -> torch.Tensor:
        """int64 tensor of ``x``'s shape: each element's sequence position
        (the axis of size ``m_total``, else ``a·i_a + i_b`` over a pair's
        two axes)."""
        shape = tuple(x.shape)
        if self.m_total in shape:
            d = len(shape) - 1 - shape[::-1].index(self.m_total)
            view = [1] * len(shape)
            view[d] = self.m_total
            return torch.arange(self.m_total).reshape(view).expand(shape)
        for a, b in self.m_pairs:
            if a in shape and b in shape:
                ia, ib = shape.index(a), shape.index(b)
                va, vb = [1] * len(shape), [1] * len(shape)
                va[ia], vb[ib] = a, b
                return (torch.arange(a).reshape(va) * b
                        + torch.arange(b).reshape(vb)).expand(shape)
        raise ValueError(f"shape {shape} carries no sequence axis")

    # -- the mode ----------------------------------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _name(func)
        ins = []
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor) and all(a is not b for b in ins):
                ins.append(a)
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if _in_place(name) and ins:
            outs = [ins[0]]
        elif not outs or any(o is i for o in outs for i in ins):
            return out       # metadata, or an input returned unchanged
        x = args[0] if args else None
        if (name in INDEXING and isinstance(x, torch.Tensor)
                and not self.get(x).pos and self.is_full(x.shape)
                and not all(self.is_full(o.shape) for o in outs)):
            self._tiles(func, args, kwargs, outs)
        else:
            self._generic(ins, outs)
        return out

    def _tiles(self, func, args, kwargs, outs) -> None:
        """Tiles of the full sequence tensor ``args[0]``: positions and a
        read event each; the read itself is noted where they are used."""
        x = args[0]
        # views of one storage (k and k.reshape(..., 3, 48, ...)) number
        # their positions alike, so they are one root
        root = ("storage", x.untyped_storage().data_ptr())
        self.keep.append(x)
        self.shapes.setdefault(root, tuple(x.shape))
        pmap = self.position_map(x)
        self.all_pos.setdefault(root, frozenset(pmap.unique().tolist()))
        p_outs = [o for o in tree_flatten(func(pmap, *args[1:], **kwargs))[0]
                  if isinstance(o, torch.Tensor)]
        idx = [self.get(a) for a in tree_flatten((args[1:], kwargs))[0]
               if isinstance(a, torch.Tensor)]
        src = self.get(x)
        wait = max([src.avail] + [self.ready(i, frozenset()) for i in idx])
        cov: dict = {}
        for i in [src] + idx:
            _merge_cov(cov, i.cov)
        for o, po in zip(outs, p_outs):
            if self.is_full(o.shape):
                self._generic([x], [o])
                continue
            ev = next(self.events)
            self.put(o, _Info(avail=wait, base=wait,
                              pos={root: {ev: frozenset(
                                  po.unique().tolist())}},
                              extents=frozenset(_extent(po)), cov=cov))

    def _generic(self, ins, outs) -> None:
        self.keep.extend(ins)
        infos = [self.get(t) for t in ins]
        extents = frozenset().union(*(i.extents for i in infos if i.pos))
        carries = [bool(extents & set(o.shape)) for o in outs]
        outs_m = any(carries) or any(self.has_m(o.shape) for o in outs)
        exclude = frozenset(ev for i in infos
                            for evs in i.pos.values() for ev in evs)
        w_eff = w_base = 0
        traversed = set()
        exempt: dict = {}
        for t, i in zip(ins, infos):
            shp = tuple(t.shape)
            if i.pos or self.is_full(shp) or (self.is_partial(shp)
                                              and outs_m):
                w_eff, w_base = max(w_eff, i.avail), max(w_base, i.avail)
                if not i.pos and self.is_full(shp):
                    traversed.add(id(t))
            else:
                w_eff = max(w_eff, self.ready(i, exclude, exempt))
                w_base = max(w_base, i.base)
        gen = w_eff + 1
        cov: dict = {}
        _merge_cov(cov, exempt)
        pos: dict = {}
        for t, i in zip(ins, infos):
            _merge_cov(cov, i.cov)
            if id(t) in traversed:
                self.note(id(t), t.shape, gen)
            for root, evs in i.pos.items():
                self.note(root, self.shapes[root], gen)
                cov.setdefault(root, {}).setdefault(gen, {}).update(evs)
                pos.setdefault(root, {}).update(evs)
        step = 1 if traversed else 0
        for o, carry in zip(outs, carries):
            if carry or self.has_m(o.shape):
                info = _Info(avail=w_eff, base=max(w_eff, w_base + step),
                             cov=cov)
                if carry:
                    info.pos = pos
                    info.extents = extents & set(o.shape)
                elif traversed and self.is_full(o.shape):
                    self.note(id(o), o.shape, gen)
            else:
                info = _Info(avail=w_base + step, base=w_base + step,
                             cov=cov)
            self.put(o, info)


def _extent(pos: torch.Tensor) -> list:
    """The size of ``pos``'s innermost position axis (the one along which
    positions step least), as a one-element list, or [] for one position."""
    best = None
    for d, n in enumerate(pos.shape):
        if n < 2:
            continue
        step = int((pos.narrow(d, 1, 1) - pos.narrow(d, 0, 1))
                   .abs().flatten()[0])
        if step and (best is None or step < best[0]):
            best = (step, n)
    return [] if best is None else [best[1]]


def trace_m_passes(
    fn: Callable,
    args: Sequence,
    *,
    m_total: int,
    m_pairs: Sequence[tuple] = (),
) -> TorchTrace:
    """Count passes over the sequence axis in a torch implementation.

    ``m_total`` is the (distinctively-sized) sequence extent of the probe
    shapes; ``m_pairs`` lists (n_blocks, block) factorizations used by
    blocked layouts — a tensor carrying both factors covers the full
    sequence, one carrying a single factor is partial bookkeeping.
    Probe shapes must keep all other axis sizes distinct from these.
    ``fn`` runs once, eagerly, on ``args``; its output is what an
    untraced call returns.
    """
    rec = _Recorder(m_total, tuple(tuple(p) for p in m_pairs))
    with rec:
        fn(*args)
    passes = max((g for gens in rec.notes.values() for g in gens),
                 default=0)
    multi = sorted({rec.shapes[t] for t, gens in rec.notes.items()
                    if len(gens) > 1})
    return TorchTrace(passes=passes, multi_gen=multi)


def assert_torch_path(
    fn: Callable,
    args: Sequence,
    entry: CascadeEntry,
    *,
    m_total: int,
    m_pairs: Sequence[tuple] = (),
    label: str = "",
) -> TorchTrace:
    """Trace a torch implementation and match it against its declaration."""
    tr = trace_m_passes(fn, args, m_total=m_total, m_pairs=m_pairs)
    name = f"{entry.name}[{label}]" if label else entry.name
    if tr.passes != entry.expected_passes:
        raise LintError(
            f"{name}: torch path performs {tr.passes} passes over the "
            f"sequence, declaration says {entry.expected_passes}")
    if entry.footprint == O1 and tr.multi_gen:
        raise LintError(
            f"{name}: declared O(1) live footprint but tensors of shape "
            f"{tr.multi_gen} stay live across a pass barrier")
    if entry.footprint == OS and not tr.multi_gen:
        raise LintError(
            f"{name}: declared O(S) footprint but no full fiber crosses "
            f"a pass barrier — declaration is too pessimistic")
    return tr


__all__ = ["LintError", "TorchTrace", "assert_torch_path", "trace_m_passes"]
