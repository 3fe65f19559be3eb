"""Fault tolerance: heartbeats, straggler detection, elastic re-mesh.

A copy of ``repro.distributed.fault_tolerance`` (which imports no JAX).

At 1000+ nodes the failure model is: (a) hard node loss (process gone),
(b) stragglers (slow-but-alive workers that stall every collective),
(c) transient step failures.  This module implements the control plane:

  * ``HeartbeatMonitor`` — deadline-based liveness + robust (median/MAD)
    straggler scoring over reported step durations.  A worker is ejected
    when it misses the deadline or is a persistent >kσ outlier.
  * ``ElasticMeshManager`` — given the surviving worker set, proposes the
    largest valid mesh (shrinking the data axis first, preserving the
    model axis: TP groups must stay intact because parameters are sharded
    across them), and drives checkpoint-restore onto the new mesh
    (``repro_torch.distributed.checkpoint.restore``).
  * ``retry_step`` — bounded retry wrapper for transient failures.

All logic is hardware-independent and unit-tested with simulated clusters
(tests/test_fault_tolerance.py); on a real deployment the heartbeat
transport is the cluster scheduler / coordination service.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float
    step_durations: list = dataclasses.field(default_factory=list)
    strikes: int = 0
    alive: bool = True


class HeartbeatMonitor:
    """Tracks liveness + step-duration outliers across workers."""

    def __init__(self, n_workers: int, *, deadline_s: float = 60.0,
                 straggler_sigma: float = 4.0, strike_limit: int = 3,
                 window: int = 20, clock: Callable[[], float] = time.time):
        self.deadline_s = deadline_s
        self.sigma = straggler_sigma
        self.strike_limit = strike_limit
        self.window = window
        self.clock = clock
        now = clock()
        self.workers = {
            i: WorkerState(i, last_heartbeat=now) for i in range(n_workers)
        }

    def heartbeat(self, worker_id: int,
                  step_duration: Optional[float] = None) -> None:
        w = self.workers[worker_id]
        w.last_heartbeat = self.clock()
        if step_duration is not None:
            w.step_durations.append(step_duration)
            if len(w.step_durations) > self.window:
                w.step_durations.pop(0)

    def _median_mad(self) -> tuple[float, float]:
        durs = [
            w.step_durations[-1]
            for w in self.workers.values()
            if w.alive and w.step_durations
        ]
        if not durs:
            return 0.0, 0.0
        durs = sorted(durs)
        med = durs[len(durs) // 2]
        mad = sorted(abs(d - med) for d in durs)[len(durs) // 2]
        return med, max(mad, 1e-9)

    def check(self) -> dict:
        """Returns {"dead": [...], "stragglers": [...]} and marks ejections."""
        now = self.clock()
        dead, stragglers = [], []
        med, mad = self._median_mad()
        for w in self.workers.values():
            if not w.alive:
                continue
            if now - w.last_heartbeat > self.deadline_s:
                w.alive = False
                dead.append(w.worker_id)
                continue
            if w.step_durations and mad > 0:
                # MAD-based robust z-score (1.4826 ≈ normal consistency)
                z = abs(w.step_durations[-1] - med) / (1.4826 * mad)
                if z > self.sigma and w.step_durations[-1] > med:
                    w.strikes += 1
                    if w.strikes >= self.strike_limit:
                        w.alive = False
                        stragglers.append(w.worker_id)
                else:
                    w.strikes = 0
        return {"dead": dead, "stragglers": stragglers}

    def alive_workers(self) -> list[int]:
        return sorted(w.worker_id for w in self.workers.values() if w.alive)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    n_devices: int


class ElasticMeshManager:
    """Chooses the largest valid mesh for the surviving device count.

    Invariants: the model (TP) axis size is preserved — parameters are
    sharded across TP groups, so a TP group is the atomic unit of loss;
    losing any device in a TP group drops the whole group.  The data axis
    shrinks to the largest value such that data·model ≤ survivors, and
    the pod axis collapses when a pod drops below quorum.
    """

    def __init__(self, model_parallel: int, devices_per_pod: int):
        self.mp = model_parallel
        self.dpp = devices_per_pod

    def plan(self, surviving_devices: int,
             n_pods: int = 1) -> Optional[MeshPlan]:
        groups = surviving_devices // self.mp
        if groups < 1:
            return None
        if n_pods > 1:
            groups_per_pod = self.dpp // self.mp
            pods = max(1, min(n_pods, groups // groups_per_pod))
            if pods > 1:
                data = groups // pods
                return MeshPlan((pods, data, self.mp),
                                ("pod", "data", "model"),
                                pods * data * self.mp)
        return MeshPlan((groups, self.mp), ("data", "model"),
                        groups * self.mp)


def retry_step(fn: Callable, *args, retries: int = 2,
               on_retry: Optional[Callable[[int, Exception], None]] = None):
    """Bounded retry for transient step failures."""
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except Exception as e:                          # pragma: no cover
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
    raise last


@dataclasses.dataclass
class RecoveryLog:
    """Append-only record of cluster events (for post-mortems/tests)."""
    events: list = dataclasses.field(default_factory=list)

    def record(self, kind: str, **kw) -> None:
        self.events.append({"kind": kind, **kw})
