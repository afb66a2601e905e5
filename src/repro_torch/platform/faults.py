"""Deterministic, seeded fault injection (DESIGN.md §12).

The nightly ``--chaos`` pass agitates the data plane from a free-running
thread — good for soak, useless as a gate: no two runs inject the same
faults.  This module replaces the lottery with a **plan**: a
:class:`FaultPlan` is a list of :class:`FaultEvent` s with exact trigger
points counted in *logical* progress units —

* **node events** fire when the job's N-th task completion is observed
  (``at_completions``), mutating the attached
  :class:`~repro_torch.core.datastore.ReplicatedDataStore`;
* **worker crashes** fire when worker ``target`` makes its K-th claim
  (``at_claims``), raising :class:`~repro_torch.core.recovery.WorkerCrash`
  inside that worker's loop — mid-task, after the claim, before
  settlement: exactly the window lease-based reclamation covers;
* **checkpoint crashes** fire on the K-th checkpoint save
  (``at_saves``), raising :class:`InjectedCrash` to simulate the process
  dying mid-save (the atomic tmp+rename protocol must leave the last
  good checkpoint restorable).

Trigger points are logical, so a plan is reproducible across machines
and backends; *which* task is the N-th completion may differ run to run,
but the recovery layers (lease reclamation + first-completion-wins dedup
+ the fixed reduce tree) guarantee the job RESULT is bit-identical to
the fault-free run regardless — that is the property ``bench_faults``
gates.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import recovery as rec

NODE_KINDS = ("node_latency", "node_error", "node_kill", "node_revive")
KINDS = NODE_KINDS + ("worker_crash", "checkpoint_crash")


class InjectedCrash(RuntimeError):
    """A planned checkpoint-write crash: simulates the process dying
    mid-save.  Propagates out of the run like a real crash would; the
    checkpoint directory must still hold the last committed step."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One planned fault.  ``target`` is a data-node id for node events,
    a worker id for ``worker_crash``, ignored for ``checkpoint_crash``.
    Exactly one of the ``at_*`` trigger points applies per kind."""

    kind: str
    target: int = 0
    at_completions: int = 0     # node events: N-th observed completion
    at_claims: int = 0          # worker_crash: target's K-th claim
    at_saves: int = 0           # checkpoint_crash: K-th checkpoint save
    factor: float = 1.0         # node_latency: latency multiplier

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"choose one of {KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, reusable fault schedule.  Build one explicitly or
    draw a seeded random plan with :meth:`from_seed` — either way two
    runs under the same plan inject the same faults at the same logical
    points."""

    events: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    @classmethod
    def from_seed(cls, seed: int, *, n_workers: int, n_nodes: int,
                  n_tasks: int, worker_crashes: int = 1,
                  node_kills: int = 1, latency_spikes: int = 1,
                  revive_after: Optional[int] = None) -> "FaultPlan":
        """Seeded chaos: crash ``worker_crashes`` distinct workers at
        random claim counts, kill ``node_kills`` distinct nodes at random
        completion points (revived ``revive_after`` completions later
        when given), and spike latency on ``latency_spikes`` nodes."""
        rng = random.Random(seed)
        events: List[FaultEvent] = []
        span = max(n_tasks, 2)
        for wid in rng.sample(range(n_workers),
                              min(worker_crashes, n_workers)):
            events.append(FaultEvent(
                "worker_crash", target=wid,
                at_claims=rng.randint(1, max(1, span // n_workers))))
        for nid in rng.sample(range(n_nodes), min(node_kills, n_nodes)):
            at = rng.randint(1, max(1, span // 2))
            events.append(FaultEvent("node_kill", target=nid,
                                     at_completions=at))
            if revive_after is not None:
                events.append(FaultEvent(
                    "node_revive", target=nid,
                    at_completions=at + revive_after))
        for nid in rng.sample(range(n_nodes),
                              min(latency_spikes, n_nodes)):
            events.append(FaultEvent(
                "node_latency", target=nid,
                at_completions=rng.randint(1, max(1, span // 2)),
                factor=rng.uniform(2.0, 8.0)))
        return cls(tuple(events))


class FaultInjector:
    """Drives one run's :class:`FaultPlan`.  One injector per run — it
    holds fired-state; the plan itself is reusable.

    Hooks (all thread-safe):

    * :meth:`attach_store` — give node events their target store;
    * :meth:`on_progress` — observe task completions (drivers wrap their
      ``emit`` with :meth:`wrap_emit`); due node events fire inline;
    * :meth:`worker_tick` — called by runner/pool workers right after a
      claim; raises :class:`~repro_torch.core.recovery.WorkerCrash` when a
      planned crash is due (once per event — the respawned worker reuses
      the id and must not crash again);
    * :meth:`checkpoint_tick` — called by the checkpointer before each
      save; raises :class:`InjectedCrash` when due.
    """

    def __init__(self, plan: FaultPlan, store: Optional[Any] = None):
        self.plan = plan
        self._store = store
        # optional repro_torch.platform.telemetry.TelemetryBus the driver or
        # service attaches; every fired event emits "fault_fired"
        self.telemetry = None
        self._lock = threading.Lock()
        self._completions = 0
        self._claims: Dict[int, int] = {}
        self._saves = 0
        self._fired: List[FaultEvent] = []
        self._pending: List[FaultEvent] = list(plan.events)
        # original latency models of spiked nodes (node_revive restores)
        self._orig_latency: Dict[int, Callable[[int], float]] = {}

    def attach_store(self, store: Any) -> None:
        self._store = store

    def _emit_fired(self, e: FaultEvent) -> None:
        bus = self.telemetry
        if bus is not None:
            bus.emit("fault_fired", fault_kind=e.kind, target=e.target,
                     at_completions=e.at_completions,
                     at_claims=e.at_claims, at_saves=e.at_saves)

    @property
    def fired(self) -> List[FaultEvent]:
        with self._lock:
            return list(self._fired)

    # -- node events (logical completion clock) ---------------------------
    def on_progress(self, n: int = 1) -> None:
        with self._lock:
            self._completions += n
            due = [e for e in self._pending
                   if e.kind in NODE_KINDS
                   and e.at_completions <= self._completions]
            for e in due:
                self._pending.remove(e)
                self._fired.append(e)
        for e in due:
            self._emit_fired(e)
            self._fire_node_event(e)

    def wrap_emit(self, emit: Optional[Callable[[int, Any], None]]
                  ) -> Callable[[int, Any], None]:
        """Wrap a driver's per-task ``emit`` so every completion ticks
        the logical clock (after the partial is offered — a fault fires
        between completions, never inside one)."""

        def wrapped(task_id: int, partial: Any) -> None:
            if emit is not None:
                emit(task_id, partial)
            self.on_progress(1)

        return wrapped

    def _fire_node_event(self, e: FaultEvent) -> None:
        store = self._store
        if store is None:
            return
        try:
            node = store._node(e.target)
        except KeyError:
            return                      # adaptive sizing removed the node
        if e.kind == "node_latency":
            with self._lock:
                self._orig_latency.setdefault(e.target, node.latency)
            orig = self._orig_latency[e.target]
            node.latency = lambda nbytes: orig(nbytes) * e.factor
        elif e.kind == "node_error":
            node.failing = True
        elif e.kind == "node_kill":
            node.failing = True
            store.mark_down(e.target)
        elif e.kind == "node_revive":
            node.failing = False
            with self._lock:
                orig = self._orig_latency.pop(e.target, None)
            if orig is not None:
                node.latency = orig
            store.revive(e.target)

    # -- worker crashes (per-worker claim clock) --------------------------
    def worker_tick(self, worker: int) -> None:
        fire = None
        with self._lock:
            self._claims[worker] = self._claims.get(worker, 0) + 1
            count = self._claims[worker]
            for e in self._pending:
                if (e.kind == "worker_crash" and e.target == worker
                        and count >= e.at_claims):
                    fire = e
                    break
            if fire is not None:
                self._pending.remove(fire)
                self._fired.append(fire)
        if fire is not None:
            self._emit_fired(fire)
            raise rec.WorkerCrash(
                f"injected crash: worker {worker} at claim "
                f"{self._claims[worker]}")

    # -- checkpoint crashes (save clock) ----------------------------------
    def checkpoint_tick(self) -> None:
        fire = None
        with self._lock:
            self._saves += 1
            for e in self._pending:
                if (e.kind == "checkpoint_crash"
                        and self._saves >= e.at_saves):
                    fire = e
                    break
            if fire is not None:
                self._pending.remove(fire)
                self._fired.append(fire)
        if fire is not None:
            self._emit_fired(fire)
            raise InjectedCrash(
                f"injected crash: checkpoint save {self._saves}")

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"events_fired": float(len(self._fired)),
                    "events_pending": float(len(self._pending)),
                    "completions_seen": float(self._completions),
                    "checkpoint_saves_seen": float(self._saves)}
