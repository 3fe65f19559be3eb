"""The decode step captured once as a CUDA graph and replayed.

The reference runs a whole decode chunk as one compiled program: its
engine jits a ``lax.while_loop`` over the decode step, the caches and the
per-slot state donated (``repro.serving.engine``,
``repro.model.transformer.decode_loop``).  On the card the port expresses
"one dispatch" as a ``torch.cuda.CUDAGraph``: one decode step of the whole
batch is captured once per engine and every step of every chunk replays
it, one launch a step instead of one per operator.

A graph replays the addresses it captured, so everything the step reads
or writes lives in storage that outlives it:

* :class:`repro_torch.model.transformer.DecodeState` — the decode loop's
  static buffers: ``kv_len``, ``remaining``, ``last_logits``, the step's
  token row ``tok`` and one block table per paged class (the tables'
  widths are fixed per pool); the loop loads them before a chunk;
* the caches — every leaf keeps its storage for the engine's life: the
  attention layers write their K/V in place, and the SSM decode steps
  copy their new state into the old tensors
  (:func:`repro_torch.model.ssm.step_into`).

The step is :func:`repro_torch.model.transformer.step_in_place`, the one
body of :func:`~repro_torch.model.transformer.decode_loop`; the engine
passes :meth:`DecodeGraph.step` to that loop as its step.
:class:`DecodeGraph` runs its first :data:`WARMUP_STEPS` steps eagerly on
a side stream (they are real steps: they load the kernels' libraries and
lazily loaded modules, create the cuBLAS handles and set the kernels'
attributes), captures the next one, replays it for that step and every
later one, and raises — never recaptures — if a cache leaf or a buffer
moved (:meth:`DecodeGraph.check`, once a dispatch).

The kernels' launch counters are Python-side, so a replay counts nothing
by itself: the capture records each counter's change over the captured
step (:func:`counter_snapshot` / :func:`counter_delta`), takes it back
(capture launches nothing), and each replay adds it once
(:func:`counter_add`).
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.distributed.sharding import leaf_parts
from repro_torch.kernels import COUNTED_WRAPPERS
from repro_torch.model import transformer as tf

#: eager steps an engine runs before it captures its step
WARMUP_STEPS = 2


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------

def counter_snapshot(wrappers=COUNTED_WRAPPERS) -> dict:
    """Every ``launches*`` counter of ``wrappers`` (an int, or a dict of
    ints by key), copied: ``{(wrapper name, attribute): value}``."""
    snap = {}
    for w in wrappers:
        for name, value in vars(w).items():
            if name.startswith("launches"):
                snap[(w.__name__, name)] = \
                    dict(value) if isinstance(value, dict) else value
    return snap


def counter_delta(after: dict, before: dict) -> dict:
    """``after - before`` per counter (per key of a dict counter), the
    counters and keys that did not move left out."""
    out = {}
    for k, a in after.items():
        b = before.get(k, {} if isinstance(a, dict) else 0)
        if isinstance(a, dict):
            d = {key: n - b.get(key, 0) for key, n in a.items()
                 if n != b.get(key, 0)}
        else:
            d = a - b
        if d:
            out[k] = d
    return out


def counter_add(delta: dict, times: int = 1,
                wrappers=COUNTED_WRAPPERS) -> None:
    """Add ``times`` × ``delta`` (from :func:`counter_delta`) to the
    wrappers' counters."""
    by_name = {w.__name__: w for w in wrappers}
    for (wname, attr), d in delta.items():
        w = by_name[wname]
        if isinstance(d, dict):
            counts = getattr(w, attr)
            for key, n in d.items():
                counts[key] = counts.get(key, 0) + n * times
                if not counts[key]:
                    del counts[key]
        else:
            setattr(w, attr, getattr(w, attr) + d * times)


# ---------------------------------------------------------------------------
# The captured step
# ---------------------------------------------------------------------------

def cache_leaves(caches: list) -> list:
    """Every tensor of a cache list (attention and SSM leaves, each shard
    of a sharded leaf), in a fixed order."""
    out = []
    for c in caches:
        for part in ("attn", "ssm"):
            for name in sorted(c.get(part, {})):
                leaf = c[part][name]
                out.extend(leaf.parts if hasattr(leaf, "parts")
                           else leaf_parts(leaf))
    return out


def signature(tensors: list) -> list:
    """(address, shape, dtype, device) of each tensor."""
    return [(t.data_ptr(), tuple(t.shape), t.dtype, t.device)
            for t in tensors]


def graph_refusal(caches: list, device: torch.device) -> Optional[str]:
    """Why a decode step on ``caches`` cannot be captured on ``device``,
    as the engine's ``decode_graph`` mode says it, or None."""
    if device.type != "cuda":
        return f"eager: {device.type}"
    if device.index is None:           # "cuda" is the current device
        device = torch.device("cuda", torch.cuda.current_device())
    if {t.device for t in cache_leaves(caches)} != {device}:
        return "eager: devices"        # capture is per device
    return None


class DecodeGraph:
    """One decode step of an engine, captured once and replayed.

    :meth:`step` advances ``state`` and ``caches`` by one step: eagerly on
    a side stream for the first :data:`WARMUP_STEPS` calls, then it
    captures :func:`~repro_torch.model.transformer.step_in_place` and
    replays it, on that call and every later one.  The captured step must
    leave every cache leaf and buffer where it was, and :meth:`check`
    raises :class:`RuntimeError` unless their addresses, shapes and dtypes
    are those captured; a capture error propagates.  ``replays`` counts
    the replays; ``capture_s`` and ``pool_bytes`` (the device memory the
    capture reserved: the graph's private pool) are set by the capture,
    ``launches_per_step`` (the kernels' counter changes a replay adds) too.
    The graph and its pool are freed with this object."""

    def __init__(self, cfg, model, caches: list, state: tf.DecodeState,
                 rt, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        dev = state.last_logits.device
        why = graph_refusal(caches, dev)
        if why is not None:
            raise ValueError(f"DecodeGraph needs one CUDA device for every "
                             f"buffer and cache leaf ({why})")
        self.cfg, self.model, self.caches = cfg, model, caches
        self.state, self.rt = state, rt
        self.temperature, self.generator = temperature, generator
        self.device = dev
        self.graph = None
        self.warm = 0
        self.replays = 0
        self.capture_s = None
        self.pool_bytes = None
        self.launches_per_step = None
        self._sig = None

    def _run(self) -> None:
        tf.step_in_place(self.cfg, self.model, self.caches, self.state,
                         self.rt, self.temperature, self.generator)

    def _signature(self) -> list:
        return signature(cache_leaves(self.caches) + self.state.buffers())

    def _eager(self) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._run()
        torch.cuda.current_stream(self.device).wait_stream(side)

    def _capture(self) -> None:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        # the capture empties the cache before it starts: so does this, so
        # the growth of the reserved bytes is the graph's private pool
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0.0:
            graph.register_generator_state(self.generator)
        sig = self._signature()
        before = counter_snapshot()
        with torch.cuda.graph(graph):
            self._run()
        delta = counter_delta(counter_snapshot(), before)
        counter_add(delta, -1)          # the capture itself ran nothing
        torch.cuda.synchronize(self.device)
        if self._signature() != sig:
            # a writer in the step rebound a leaf to a tensor of the graph's
            # pool: every replay would read the pre-capture state
            raise RuntimeError("decode graph: the captured step rebinds a "
                               "cache leaf or a step buffer; every writer "
                               "in the step must write in place")
        self.graph = graph
        self.launches_per_step = delta
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved0
        self._sig = sig

    def check(self, caches: list) -> None:
        """Raise :class:`RuntimeError` unless ``caches`` is the list the
        graph was built on and, once captured, every cache leaf and step
        buffer has its captured address, shape and dtype: the engine calls
        this once a dispatch, since only the writers between dispatches
        could move a leaf."""
        if caches is not self.caches:
            raise RuntimeError("decode graph: the engine's cache list was "
                               "replaced since the capture")
        if self._sig is not None and self._signature() != self._sig:
            raise RuntimeError(
                "decode graph: a cache leaf or a step buffer moved or "
                "changed shape since the capture; the graph replays the "
                "captured addresses, so every writer between replays must "
                "write in place")

    def step(self) -> None:
        """One step: eager while warming up, then the capture, then a
        replay."""
        if self.graph is None:
            if self.warm < WARMUP_STEPS:
                self._eager()
                self.warm += 1
                return
            self._capture()
        self.graph.replay()
        counter_add(self.launches_per_step, 1)
        self.replays += 1
