"""Async continuous-batching front end over :class:`ServeEngine`.

Port of ``repro.serving.scheduler``.  The host-only parts (clocks,
Poisson arrivals, requests and token streams, the :class:`AsyncScheduler`
state machine, the synchronous open-loop baseline, the latency summary,
the prefix-affinity router and the data-parallel engine) are copies of
the reference's; :class:`AsyncServeEngine` binds the scheduler to the
port's engine.

The synchronous engine serves a *trace*: requests arrive as a list and
tokens come back at the end.  Open-loop traffic arrives on its own clock
(Poisson arrivals here), every stream wants its next token *now*, and
the numbers that matter are the tails of TTFT (time to first token) and
ITL (inter-token latency) against offered load:

  * :class:`AsyncScheduler` — a pure host-side state machine deciding
    what to dispatch next.  Requests move through ``waiting → prefill →
    active → done`` (``waiting`` again on preemption, ``shed`` when an
    SLA deadline expires before admission).  Admission is earliest-
    deadline-first (FIFO among equals).  Whenever both are runnable the
    policy *strictly alternates* one prefill quantum with one fused
    decode dispatch: between two decode dispatches at most ONE
    ``prefill_quantum``-token slice runs, so a long prompt admitted
    mid-flight delays in-flight streams' ITL by one quantum, never by
    its whole prefill.
  * :class:`AsyncServeEngine` — the scheduler bound to the engine.
    Intake (``submit_async`` → :class:`TokenStream`) is decoupled from
    device dispatch (``pump()``, one scheduler turn); iterating a stream
    pumps the engine until its next token lands, and every token carries
    a timestamp.  Long prompts prefill in ``prefill_quantum`` slices
    interleaved with decode dispatches through the engine's own prefill
    (``_prefill_into_slots`` at a history offset), block-table growth and
    preempt-youngest recompute policy.
  * :class:`PrefixAffinityRouter` / :class:`DataParallelAsyncEngine` — N
    engine replicas; the router matches a prompt's leading pages against
    every replica's prefix index (``kv.match_prefix``) at *arrival* time
    and routes to the replica holding the longest prefix (else the least
    outstanding work), so shared-prefix traffic lands on one replica.

Why masked decode steps cannot corrupt a mid-prefill slot.  The fused
decode loop runs *every* slot each step; a slot with ``remaining == 0``
is masked: its sampled token is discarded and ``kv_len`` does not
advance, but the dummy token's K/V is still written at ``kv_len - 1``.
A slot mid-prefill at ``progress`` written tokens is parked at ``kv_len
= progress + 1``, so every masked write lands at position ``progress``,
the *next unwritten* one.  That position lies in a slot-private page
(progressive registration indexes only fully written pages), nothing
reads it (the slot's own masked output is discarded), and the next
quantum rewrites ``[progress, progress + c)`` with the true K/V before
the slot becomes active.  The dense layout and configs with SSM state
prefill each prompt whole at admission instead (a masked step would
advance recurrent state mid-prompt, which nothing rewrites).  Either
way greedy streams equal the synchronous engine's on the same request
set: scheduling moves *when* a token is computed, never *what*.

Progressive prefix registration: the async engine admits with
``register=False`` and calls ``kv.register_progress`` after each
quantum, so a page becomes matchable only once the dispatch writing it
is on the stream; a preempted long prompt's written pages stay indexed,
and its re-admission prefills only the tail.

Swap-tier promotions: ``kv.start_promote`` issues the host→device copies
of a hit on demoted pages at admission, on the current stream ahead of
any later prefill; the engine keeps the promotions staged (their host
buffers referenced) and hands them to ``kv.apply_promote`` right before
the slot's next prefill quantum, which keeps the buffers alive until the
copies have completed.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.engine import Request, ServeEngine


# -- clocks -----------------------------------------------------------------


class WallClock:
    """Real time (``time.perf_counter``); waiting sleeps."""

    def now(self) -> float:
        return time.perf_counter()

    def wait_until(self, t: float) -> None:
        d = t - self.now()
        if d > 0:
            time.sleep(d)


class VirtualClock:
    """Deterministic simulated time for scheduler tests: ``now()`` only
    moves when told to.  ``wait_until`` never sleeps."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, float(t))


def poisson_arrivals(rate: float, n: int, seed: int = 0,
                     t0: float = 0.0) -> np.ndarray:
    """``n`` open-loop Poisson arrival times at ``rate`` req/s (seeded
    exponential inter-arrival gaps; closed-loop clients would hide
    queueing delay by slowing their own submissions)."""
    if rate <= 0:
        raise ValueError(f"need rate > 0, got {rate}")
    rng = np.random.default_rng(seed)
    return t0 + np.cumsum(rng.exponential(1.0 / rate, size=n))


# -- requests & streams -----------------------------------------------------


@dataclasses.dataclass
class AsyncRequest(Request):
    """A :class:`Request` with an arrival time, an optional SLA deadline
    (absolute clock time — sheddable until admitted), and per-token
    timestamps (``token_times[i]`` is when ``generated[i]`` reached the
    host)."""
    arrival: float = 0.0
    deadline: Optional[float] = None
    token_times: list = dataclasses.field(default_factory=list)
    shed: bool = False


class TokenStream:
    """Per-request token stream: iterate (sync or ``async for``) to pull
    tokens as they are produced; starved iterations pump the engine.
    The stream closes when the request finishes (or is shed — check
    ``stream.req.shed``)."""

    def __init__(self, req: AsyncRequest, drive):
        self.req = req
        self._drive = drive
        self._q: collections.deque = collections.deque()
        self._closed = False

    def _push(self, tokens) -> None:
        self._q.extend(int(t) for t in tokens)

    def _close(self) -> None:
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed and not self._q

    def __iter__(self):
        while True:
            while self._q:
                yield self._q.popleft()
            if self._closed:
                return
            if not self._drive():          # pragma: no cover - defensive
                raise RuntimeError(
                    f"stream for rid={self.req.rid} stalled: engine idle "
                    f"with the request unfinished")

    async def __aiter__(self):
        while True:
            while self._q:
                yield self._q.popleft()
            if self._closed:
                return
            # yield control to the event loop between pumps so concurrent
            # consumers interleave; the pump itself is the device work
            await asyncio.sleep(0)
            if not self._drive():          # pragma: no cover - defensive
                raise RuntimeError(
                    f"stream for rid={self.req.rid} stalled: engine idle "
                    f"with the request unfinished")


# -- the scheduler state machine --------------------------------------------


@dataclasses.dataclass
class _SchedEntry:
    rid: int
    arrival: float
    prompt_len: int
    deadline: Optional[float]
    state: str = "waiting"       # waiting | prefill | active | done | shed
    progress: int = 0            # prefilled tokens this admission
    target: int = 0              # tokens to prefill this admission

    @property
    def edf_key(self):
        d = self.deadline if self.deadline is not None else math.inf
        return (d, self.arrival, self.rid)


class AsyncScheduler:
    """Pure host-side dispatch policy — no engine, no device, fully
    deterministic; unit-testable against a virtual clock and a fake
    executor.

    The driving loop (``AsyncServeEngine.pump``) each turn: (1) admits
    ``admissible(now)`` requests in EDF order until the engine runs out
    of slots/pages, reporting each via :meth:`admitted` (interleaved
    prefill) or :meth:`activated` (atomic prefill); (2) executes ONE
    :meth:`next_action` — ``("prefill", rid)`` / ``("decode",)`` /
    ``("wait", t)`` / ``("idle",)`` — reporting quantum completion via
    :meth:`advance` and stream completion via :meth:`finished`.
    Preemptions report :meth:`requeue`.  The caller must execute every
    action it is handed (the alternation flag advances when the action is
    issued)."""

    def __init__(self, *, prefill_quantum: int,
                 shed_expired: bool = False):
        self.prefill_quantum = max(1, int(prefill_quantum))
        self.shed_expired = shed_expired
        self.entries: Dict[int, _SchedEntry] = {}
        self._shed: List[int] = []
        self._last_was_prefill = False

    # -- intake / transitions ----------------------------------------------

    def submit(self, rid: int, *, arrival: float, prompt_len: int,
               deadline: Optional[float] = None) -> None:
        if rid in self.entries:
            raise ValueError(f"duplicate rid {rid}")
        self.entries[rid] = _SchedEntry(rid=rid, arrival=arrival,
                                        prompt_len=prompt_len,
                                        deadline=deadline)

    def admissible(self, now: float) -> List[int]:
        """Arrived, unadmitted rids in EDF order (deadline, arrival,
        rid).  With ``shed_expired``, waiting requests whose deadline
        already passed are shed first (SLA admission control: work that
        cannot meet its deadline is refused, not started)."""
        if self.shed_expired:
            for e in self.entries.values():
                if e.state == "waiting" and e.deadline is not None \
                        and now > e.deadline:
                    e.state = "shed"
                    self._shed.append(e.rid)
        ready = [e for e in self.entries.values()
                 if e.state == "waiting" and e.arrival <= now]
        return [e.rid for e in sorted(ready, key=lambda e: e.edf_key)]

    def take_shed(self) -> List[int]:
        out, self._shed = self._shed, []
        return out

    def admitted(self, rid: int, *, cached_len: int, target: int) -> None:
        """Interleaved admission: the request enters ``prefill`` with
        ``cached_len`` tokens already resident (prefix hit)."""
        e = self.entries[rid]
        e.state = "prefill"
        e.progress = int(cached_len)
        e.target = int(target)

    def activated(self, rid: int) -> None:
        """Atomic admission (dense layout / SSM configs): the whole
        prompt prefilled at admission, straight to ``active``."""
        e = self.entries[rid]
        e.state = "active"
        e.progress = e.target = e.prompt_len

    def advance(self, rid: int, n: int) -> bool:
        """A prefill quantum of ``n`` tokens dispatched for ``rid``;
        returns True when the prompt is complete (→ ``active``)."""
        e = self.entries[rid]
        e.progress += int(n)
        if e.progress >= e.target:
            e.state = "active"
            return True
        return False

    def requeue(self, rid: int) -> None:
        """Preemption: back to ``waiting`` with the original arrival (so
        EDF priority is retained — the preempted request outranks every
        later arrival, as the sync engine's queue-head reinsertion
        does)."""
        e = self.entries[rid]
        e.state = "waiting"
        e.progress = 0

    def finished(self, rid: int) -> None:
        self.entries[rid].state = "done"

    # -- the dispatch policy -----------------------------------------------

    def next_action(self, now: float) -> tuple:
        """ONE action to execute now.  Strict alternation between prefill
        quanta and decode chunks whenever both are runnable — the
        chunk-quantum ITL bound."""
        pre = [e for e in self.entries.values() if e.state == "prefill"]
        has_active = any(e.state == "active"
                         for e in self.entries.values())
        if pre and (not has_active or not self._last_was_prefill):
            self._last_was_prefill = True
            chosen = min(pre, key=lambda e: e.edf_key)
            return ("prefill", chosen.rid)
        if has_active:
            self._last_was_prefill = False
            return ("decode",)
        if pre:                            # pragma: no cover - unreachable
            self._last_was_prefill = True
            return ("prefill", min(pre, key=lambda e: e.edf_key).rid)
        t = self.next_arrival(now)
        return ("idle",) if t is None else ("wait", t)

    def next_arrival(self, now: float) -> Optional[float]:
        """Earliest future arrival among waiting requests, or None."""
        future = [e.arrival for e in self.entries.values()
                  if e.state == "waiting" and e.arrival > now]
        return min(future) if future else None

    def unfinished(self) -> int:
        return sum(1 for e in self.entries.values()
                   if e.state not in ("done", "shed"))


# -- the async engine -------------------------------------------------------


@dataclasses.dataclass
class _MidPrefill:
    """Host-side state of a slot whose prompt is mid-prefill."""
    req: AsyncRequest
    tokens: np.ndarray
    cached: int
    progress: int
    cow: list


def interleave_supported(cfg) -> bool:
    """Interleaved chunked prefill requires every layer's per-slot decode
    state to be positional K/V only: a masked decode step's dummy write
    parks at the next unwritten position and is rewritten by the next
    quantum, but SSM recurrent state advanced by a dummy token mid-prompt
    is unrecoverable.  (Windowed rings are fine — the parked write lands
    at the same logical ring slot the next quantum rewrites.)"""
    return all(s.ssm is None and not s.parallel_ssm
               for s in cfg.layer_specs())


class AsyncServeEngine(ServeEngine):
    """:class:`ServeEngine` behind an :class:`AsyncScheduler`: open-loop
    intake, per-request token streams, deadline-aware admission, and
    (paged, non-SSM configs) prefill quanta interleaved with decode
    dispatches.  Admission, paging and the preempt-youngest policy are
    inherited, and so is the device-sharded pool (``mesh=``, passed
    through to :class:`ServeEngine`); speculation is refused (the verify
    dispatch writes draft K/V beyond the parked position of a mid-prefill
    slot)."""

    def __init__(self, cfg, model, *, prefill_quantum: Optional[int] = None,
                 clock=None, shed_expired: bool = False, **kw):
        if kw.get("speculate") is not None:
            raise ValueError(
                "speculative decoding is not supported on the async "
                "engine yet: the fused verify dispatch writes a P-token "
                "draft chain for every slot, which would land beyond a "
                "mid-prefill slot's parked write position")
        super().__init__(cfg, model, **kw)
        self.clock = clock if clock is not None else WallClock()
        q = prefill_quantum if prefill_quantum is not None \
            else (self.prefill_chunk or 32)
        self.prefill_quantum = max(1, int(q))
        self.interleave = self.kv is not None and interleave_supported(cfg)
        self.shed_expired = shed_expired
        self.sched = AsyncScheduler(prefill_quantum=self.prefill_quantum,
                                    shed_expired=shed_expired)
        self._reqs: Dict[int, AsyncRequest] = {}
        self._streams: Dict[int, TokenStream] = {}
        self._mid: Dict[int, _MidPrefill] = {}      # slot → state
        self._slot_of: Dict[int, int] = {}          # rid → slot
        self._staged_promotes: list = []

    # -- intake -------------------------------------------------------------

    def submit_async(self, req: AsyncRequest,
                     stream: Optional[TokenStream] = None) -> TokenStream:
        """Register a request (admissible once ``clock.now() >=
        req.arrival``) and return its token stream.  Intake never touches
        the device — dispatch happens in :meth:`pump`."""
        if req.rid in self._reqs:
            raise ValueError(f"duplicate rid {req.rid}")
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} needs at least one "
                f"free cache slot for decode (max_len={self.max_len})")
        if self.kv is not None:
            self.kv.validate_request(len(req.prompt) + req.max_new_tokens)
        req._t_submit = time.perf_counter()
        self._reqs[req.rid] = req
        s = stream if stream is not None else TokenStream(req, self._drive)
        self._streams[req.rid] = s
        self.sched.submit(req.rid, arrival=req.arrival,
                          prompt_len=len(req.prompt),
                          deadline=req.deadline)
        return s

    # -- the event loop ------------------------------------------------------

    def pump(self) -> bool:
        """One scheduler turn: shed expired, admit arrivals, execute one
        dispatch action.  Returns True if anything happened (False →
        nothing runnable right now; see :meth:`_drive`)."""
        now = self.clock.now()
        did = False
        for rid in self.sched.admissible(now):
            if not self._admit_async(self._reqs[rid]):
                break                      # no slot / pages: HOL waits
            did = True
        for rid in self.sched.take_shed():
            req = self._reqs[rid]
            req.shed = req.done = True
            self._close_stream(rid)
            did = True
        action = self.sched.next_action(now)
        if action[0] == "prefill":
            self._prefill_quantum_dispatch(action[1])
            return True
        if action[0] == "decode":
            self._decode_tick()
            return True
        return did

    def _drive(self) -> bool:
        """Advance the world by one event: pump, or jump the clock to the
        next arrival.  False when nothing can ever happen again."""
        if self.pump():
            return True
        t = self.sched.next_arrival(self.clock.now())
        if t is None:
            return False
        self.clock.wait_until(t)
        return True

    def drain(self, max_turns: int = 1_000_000) -> None:
        """Run until every submitted request is finished or shed."""
        turns = 0
        while self._drive():
            turns += 1
            if turns > max_turns:          # pragma: no cover - defensive
                raise RuntimeError(f"drain exceeded {max_turns} turns")

    def serve_trace(self, requests: Sequence[AsyncRequest]
                    ) -> List[TokenStream]:
        streams = [self.submit_async(r) for r in requests]
        self.drain()
        return streams

    # -- admission -----------------------------------------------------------

    def _admit_async(self, req: AsyncRequest) -> bool:
        free = [i for i in range(self.slots)
                if self.active[i] is None and i not in self._mid]
        if not free:
            return False
        if not self.interleave:
            # atomic admission (dense layout / SSM configs): the whole
            # prompt prefills in one dispatch through the sync engine's
            # own admission, driven one request at a time
            self.queue.append(req)
            self._admit()
            if self.queue and self.queue[-1] is req:
                self.queue.pop()           # pages short: stays waiting
                return False
            slot = next(i for i, r in enumerate(self.active) if r is req)
            self._slot_of[req.rid] = slot
            self.sched.activated(req.rid)
            return True
        i = free[0]
        tokens = self._resume_tokens(req)
        info = self.kv.admit(i, tokens, len(tokens) + 1, register=False)
        if info is None:
            return False                   # pages short even after evict
        if info["promotes"]:
            # the host→device copies are issued now; the promotions stay
            # staged (their host buffers referenced) until the next prefill
            # quantum hands them to apply_promote (see _flush_promotes)
            self._staged_promotes.extend(
                self.kv.start_promote(info["promotes"]))
        if info["reused"]:
            self.stats["prefix_hits"] += 1
            self.stats["tokens_reused"] += info["reused"]
        self.stats["cow_copies"] += len(info["cow_pairs"])
        self._admit_seq += 1
        self._order[i] = self._admit_seq
        self._mid[i] = _MidPrefill(req=req, tokens=tokens,
                                   cached=info["cached_len"],
                                   progress=info["cached_len"],
                                   cow=list(info["cow_pairs"]))
        self._slot_of[req.rid] = i
        # parked: masked decode writes land at the next unwritten
        # position (kv_len - 1 == progress), which the next quantum
        # rewrites — see the module docstring
        self.kv_len[i] = info["cached_len"] + 1
        self.remaining[i] = 0
        self.sched.admitted(req.rid, cached_len=info["cached_len"],
                            target=len(tokens))
        return True

    # -- dispatch ------------------------------------------------------------

    def _flush_promotes(self) -> None:
        if self._staged_promotes:
            self.caches = self.kv.apply_promote(self.caches,
                                                self._staged_promotes)
            self._staged_promotes = []

    def _prefill_quantum_dispatch(self, rid: int) -> None:
        """ONE ``prefill_quantum``-token slice of one mid-prefill slot,
        through the sync engine's prefill (one row, the quantum's bucket,
        history offset ``progress``)."""
        slot = self._slot_of[rid]
        st = self._mid[slot]
        self._flush_promotes()
        if st.cow:
            self.caches = self.kv.apply_cow(self.caches, st.cow)
            st.cow = []
        L = len(st.tokens)
        off0 = st.progress
        c = min(self.prefill_quantum, L - off0)
        sb = self._bucket(c)
        toks = np.zeros((1, sb), np.int32)
        toks[0, :c] = st.tokens[off0:off0 + c]

        def row(x):
            return torch.tensor([x], dtype=torch.int32, device=self.device)

        self._prefill_into_slots(torch.from_numpy(toks).to(self.device),
                                 row(slot), row(L), off0, row(st.cached))
        self.stats["prefill_dispatches"] += 1
        self.stats["tokens_prefilled"] += c
        st.progress += c
        # pages fully written by this quantum become matchable now —
        # their writing dispatch is on the stream
        self.kv.register_progress(slot, st.tokens, st.progress)
        done = self.sched.advance(rid, c)
        if done:
            req = st.req
            del self._mid[slot]
            self.active[slot] = req
            self.kv_len[slot] = L
            budget = req.max_new_tokens - len(req.generated)
            self.remaining[slot] = min(budget,
                                       max(1, self.max_len - 1 - L))
        else:
            self.kv_len[slot] = st.progress + 1
        self._sync_live_peak()

    def _decode_tick(self) -> None:
        """One inherited fused decode dispatch, plus token timestamping,
        stream delivery, and completion notification."""
        before = {rid: len(r.generated) for rid, r in self._reqs.items()
                  if not r.done}
        self._decode_chunk()
        now = self.clock.now()
        for rid, n0 in before.items():
            req = self._reqs[rid]
            d = len(req.generated) - n0
            if d > 0:
                req.token_times.extend([now] * d)
                self._streams[rid]._push(req.generated[n0:])
            if req.done:
                self._close_stream(rid)

    def _close_stream(self, rid: int) -> None:
        self._streams[rid]._close()
        self._slot_of.pop(rid, None)
        self.sched.finished(rid)

    # -- preemption ----------------------------------------------------------

    def _preempt_candidates(self) -> list:
        return super()._preempt_candidates() + list(self._mid)

    def _preempt(self, slot: int) -> None:
        if slot in self._mid:
            # mid-prefill victim: its staged promotions complete before the
            # destination pages are released back to the index
            self._flush_promotes()
            st = self._mid.pop(slot)
            if st.cow:
                # deferred COW never dispatched — the copy target was
                # never read; apply anyway to release the held source ref
                self.caches = self.kv.apply_cow(self.caches, st.cow)
            self.kv.release(slot)
            self.kv_len[slot] = 0
            self.remaining[slot] = 0
            st.req.preemptions += 1
            self.stats["preemptions"] += 1
            self._slot_of.pop(st.req.rid, None)
            self.sched.requeue(st.req.rid)
            return
        req = self.active[slot]
        if req is not None and req.rid in self._reqs:
            self.kv.release(slot)
            self.active[slot] = None
            self.kv_len[slot] = 0
            self.remaining[slot] = 0
            req.preemptions += 1
            self.stats["preemptions"] += 1
            self._slot_of.pop(req.rid, None)
            self.sched.requeue(req.rid)
            return
        super()._preempt(slot)             # warmup's sync-path dummies

    # -- warmup --------------------------------------------------------------

    def warmup(self, prompt_len) -> float:
        """Inherited warmup (grouped prefills and decode loops), plus the
        interleaved path's quanta — cold offsets (0, q, 2q, …) with the
        index off, then two live-index passes for the prefix-hit offsets
        (cached + k·q), as the sync warmup's two phases."""
        t0 = time.perf_counter()
        super().warmup(prompt_len)
        if self.interleave:
            lens = (prompt_len,) if isinstance(prompt_len, int) \
                else prompt_len
            buckets = sorted({
                self._bucket(max(1, min(p, self.max_len - 1)))
                for p in lens})
            prefix_was = self.kv.prefix_enabled
            self.kv.prefix_enabled = False
            try:
                for b in buckets:
                    self._warm_async_trace(min(b, self.max_len - 1))
                if prefix_was:
                    self.kv.prefix_enabled = True
                    for b in buckets:
                        for _ in range(2):
                            self._warm_async_trace(
                                min(b, self.max_len - 1))
            finally:
                self.kv.prefix_enabled = prefix_was
            for k in self.stats:
                self.stats[k] = 0
            self.kv.clear_prefix()
            self.kv.reset_peaks()
        # warmup dummies must not linger in the request/stream registry
        self._reqs.clear()
        self._streams.clear()
        self._slot_of.clear()
        self._mid.clear()
        self._staged_promotes = []
        self.sched = AsyncScheduler(prefill_quantum=self.prefill_quantum,
                                    shed_expired=self.shed_expired)
        return time.perf_counter() - t0

    def _warm_async_trace(self, plen: int) -> None:
        t = self.clock.now()
        base = -1 - len(self._reqs)
        reqs = [AsyncRequest(rid=base - i,
                             prompt=np.zeros((plen,), np.int32),
                             max_new_tokens=self.decode_chunk, arrival=t)
                for i in range(self.slots)]
        for r in reqs:
            self.submit_async(r)
        self.drain()


# -- the synchronous open-loop baseline -------------------------------------


def serve_open_loop(engine: ServeEngine,
                    requests: Sequence[AsyncRequest],
                    clock=None) -> None:
    """Drive a *synchronous* :class:`ServeEngine` through the same
    open-loop arrival trace the async engine serves, timestamping tokens
    after every ``step()`` — the baseline for the interleaving A/B:
    admission here prefills whole prompts, so a long prompt arriving
    mid-flight stalls every in-flight stream for its full prefill."""
    clock = clock if clock is not None else WallClock()
    pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
    i = 0
    while True:
        now = clock.now()
        while i < len(pending) and pending[i].arrival <= now:
            engine.submit(pending[i])
            i += 1
        busy = engine.queue or any(r is not None for r in engine.active)
        if not busy:
            if i >= len(pending):
                break
            clock.wait_until(pending[i].arrival)
            continue
        before = [len(r.generated) for r in requests]
        engine.step()
        t = clock.now()
        for r, n0 in zip(requests, before):
            d = len(r.generated) - n0
            if d > 0:
                r.token_times.extend([t] * d)


def latency_metrics(requests: Sequence[AsyncRequest]) -> dict:
    """Tail latency summary over served requests: TTFT (first token time
    minus *arrival* — queueing counts) and ITL (gaps between consecutive
    token timestamps within each stream, pooled)."""
    served = [r for r in requests if r.token_times]
    ttfts = [r.token_times[0] - r.arrival for r in served]
    itls: List[float] = []
    for r in served:
        ts = r.token_times
        itls.extend(b - a for a, b in zip(ts, ts[1:]))

    def pcts(xs):
        if not xs:
            return {"p50": None, "p95": None, "p99": None, "max": None,
                    "mean": None}
        a = np.asarray(xs, np.float64)
        return {"p50": round(float(np.percentile(a, 50)), 5),
                "p95": round(float(np.percentile(a, 95)), 5),
                "p99": round(float(np.percentile(a, 99)), 5),
                "max": round(float(a.max()), 5),
                "mean": round(float(a.mean()), 5)}

    span = 0.0
    if served:
        t_end = max(r.token_times[-1] for r in served)
        t_start = min(r.arrival for r in requests)
        span = max(t_end - t_start, 1e-9)
    total = sum(len(r.generated) for r in served)
    return {"requests": len(requests), "served": len(served),
            "shed": sum(1 for r in requests if r.shed),
            "tokens": total, "span_s": round(span, 4),
            "tok_per_s": round(total / span, 2) if span else 0.0,
            "ttft_s": pcts(ttfts), "itl_s": pcts(itls)}


# -- data-parallel replicas & prefix-affinity routing -----------------------


class PrefixAffinityRouter:
    """Route a prompt to the replica whose prefix index already holds its
    leading pages.  The chained page-hash match (``kv.match_prefix``) is
    exactly the admission-time lookup, so a routed request's admission
    then *hits* what the router found; ties and cold prompts fall back to
    least outstanding work (prompt + unspent decode budget, in tokens).
    Routing happens at *arrival* time — the index evolves as earlier
    requests complete, which is the point of affinity."""

    def __init__(self, engines: Sequence[AsyncServeEngine]):
        self.engines = list(engines)
        self.stats = {"prefix_routed": 0, "load_routed": 0,
                      "per_replica": [0] * len(self.engines)}

    @staticmethod
    def load(engine: AsyncServeEngine) -> int:
        w = 0
        for r in engine._reqs.values():
            if not r.done:
                w += len(r.prompt) + r.max_new_tokens - len(r.generated)
        return w

    def route(self, prompt) -> int:
        prompt = np.asarray(prompt, np.int32)
        best, best_m = None, 0
        for i, e in enumerate(self.engines):
            kv = e.kv
            if kv is None or not kv.prefix_enabled:
                continue
            m = kv.match_prefix(prompt)
            if m > best_m:
                best, best_m = i, m
        if best is not None:
            self.stats["prefix_routed"] += 1
        else:
            loads = [self.load(e) for e in self.engines]
            best = int(np.argmin(loads))
            self.stats["load_routed"] += 1
        self.stats["per_replica"][best] += 1
        return best


class DataParallelAsyncEngine:
    """N engine replicas behind one intake point.  Requests are held
    until their arrival time, then routed (prefix affinity, least-loaded
    fallback) and submitted to the chosen replica.  All replicas share
    one clock; ``drain()`` round-robins their pumps so replica dispatch
    interleaves the way independent devices would."""

    def __init__(self, engines: Sequence[AsyncServeEngine]):
        if not engines:
            raise ValueError("need at least one replica")
        self.engines = list(engines)
        self.clock = self.engines[0].clock
        self.router = PrefixAffinityRouter(self.engines)
        self.assignment: Dict[int, int] = {}
        self._intake: List[AsyncRequest] = []
        self._streams: Dict[int, TokenStream] = {}

    def submit_async(self, req: AsyncRequest) -> TokenStream:
        s = TokenStream(req, self._drive)
        self._streams[req.rid] = s
        self._intake.append(req)
        self._intake.sort(key=lambda r: (r.arrival, r.rid))
        return s

    def _route_arrivals(self) -> bool:
        now = self.clock.now()
        did = False
        while self._intake and self._intake[0].arrival <= now:
            req = self._intake.pop(0)
            i = self.router.route(req.prompt)
            self.assignment[req.rid] = i
            self.engines[i].submit_async(req,
                                         stream=self._streams[req.rid])
            did = True
        return did

    def pump(self) -> bool:
        did = self._route_arrivals()
        for e in self.engines:
            did = e.pump() or did
        return did

    def _drive(self) -> bool:
        if self.pump():
            return True
        ts = [r.arrival for r in self._intake[:1]]
        ts += [t for t in (e.sched.next_arrival(self.clock.now())
                           for e in self.engines) if t is not None]
        if not ts:
            return False
        self.clock.wait_until(min(ts))
        return True

    def drain(self, max_turns: int = 1_000_000) -> None:
        turns = 0
        while self._drive():
            turns += 1
            if turns > max_turns:          # pragma: no cover - defensive
                raise RuntimeError(f"drain exceeded {max_turns} turns")

    def serve_trace(self, requests: Sequence[AsyncRequest]
                    ) -> List[TokenStream]:
        streams = [self.submit_async(r) for r in requests]
        self.drain()
        return streams

    def stats_summary(self) -> dict:
        per = []
        for e in self.engines:
            per.append({
                "tokens_reused": e.stats["tokens_reused"],
                "prefix_hits": e.stats["prefix_hits"],
                "tokens_decoded": e.stats["tokens_decoded"],
                "prefill_dispatches": e.stats["prefill_dispatches"],
                "decode_dispatches": e.stats["decode_dispatches"],
                "preemptions": e.stats["preemptions"],
            })
        return {
            "dp": len(self.engines),
            "per_replica": per,
            "tokens_reused": sum(p["tokens_reused"] for p in per),
            "prefix_hits": sum(p["prefix_hits"] for p in per),
            "tokens_decoded": sum(p["tokens_decoded"] for p in per),
            "routing": {k: (list(v) if isinstance(v, list) else v)
                        for k, v in self.router.stats.items()},
        }
