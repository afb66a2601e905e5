"""Two-phase dynamic scheduler for tiny tasks (thesis §1.1.2, §3.4, Fig 7).

Phase 1 (probe): exactly one task is assigned to each worker; their
fetch/execution times seed the feedback loop.

Phase 2 (batched queues): the feedback loop assigns *batches* of tasks to
per-worker queues so a worker never waits between millisecond tasks; the
queue look-ahead ``k`` is set dynamically from the measured ratio of data
fetch time to task execution time (the prefetch window of §3.5).  Straggler
mitigation: round-robin refill that skips busy/slow workers, power-of-two
shortest-queue choice, and work stealing from the deepest queue when a
worker idles (thesis §4.2.4).

Fault model (thesis §3.3): job-level recovery — a worker failure aborts and
restarts the *whole job* (`JobFailure`), which the driver retries; optional
task-level mode re-queues the failed task but charges every task the
monitoring overhead ``cost_tl``.

Two drivers share this policy object:
  * :func:`simulate_job` — single-threaded discrete-event simulation with
    virtual time (used for scale-out/elasticity/heterogeneity benchmarks:
    this container has one physical core, so >1-worker wall-clock
    parallelism must be simulated; per-task durations are *measured* on the
    real workload first).
  * :class:`ThreadedRunner` — real threads + queues, real wall time (used
    for overhead microbenchmarks and the runnable examples).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import recovery as rec


@dataclasses.dataclass
class Task:
    task_id: int
    sample_ids: Tuple[int, ...]
    size_bytes: float
    payload: Any = None


@dataclasses.dataclass
class TaskResult:
    task_id: int
    worker_id: int
    start: float
    fetch_time: float
    exec_time: float
    value: Any = None


def rank_by_bucket(tasks: Sequence[Task],
                   key_fn: Callable[[Task], Any],
                   score_fn: Callable[[Task], float]) -> "deque[Task]":
    """Stable-sort tasks by each bucket's best locality score: whole
    buckets move together (same-shape waves / cross-job fusion keys
    stay contiguous), intra-bucket order stays FIFO, and ties keep
    arrival order.  Shared by both schedulers' claim ranking.

    The score is the driver's ``locality_score`` — predicted best-
    replica fetch seconds, with cache-resident tasks scoring ~0
    (DESIGN.md §14), so buckets whose blocks the pool already holds
    drain first and a cache admission/eviction re-ranks via
    ``request_rerank`` exactly like a node state change."""
    tasks = list(tasks)
    if len(tasks) <= 1:
        return deque(tasks)
    score: Dict[Any, float] = {}
    first_seen: Dict[Any, int] = {}
    for i, t in enumerate(tasks):
        b = key_fn(t)
        s = float(score_fn(t))
        if b not in score or s < score[b]:
            score[b] = s
        first_seen.setdefault(b, i)
    tasks.sort(key=lambda t: (score[key_fn(t)], first_seen[key_fn(t)]))
    return deque(tasks)


class JobFailure(RuntimeError):
    """Raised when a worker dies under job-level recovery; the driver
    restarts the entire job (thesis §3.3)."""

    def __init__(self, msg: str, failed_worker: Optional[int] = None):
        super().__init__(msg)
        self.failed_worker = failed_worker


@dataclasses.dataclass
class SchedulerConfig:
    initial_batch: int = 1            # phase-1 probe tasks per worker
    min_queue_depth: int = 2
    max_queue_depth: int = 64
    power_of_two: bool = True         # two-choice shortest-queue refill
    work_stealing: bool = True
    recovery: str = "job"             # "job" | "task"
    cost_tl: float = 0.20             # task-level monitoring slowdown (Fig 6)
    # speculative re-execution of stragglers: when the backlog is empty,
    # idle workers clone in-flight tasks whose age exceeds
    # ``straggler_factor ×`` the execution-time EMA.  ``False`` off,
    # ``True`` the bare age rule, ``"auto"`` additionally requires the
    # clone to be worth its standing tax per the §3.3 cost model
    # (:func:`repro_torch.core.recovery.should_speculate`).  First completion
    # wins; per-task seeds keep clone results bit-identical.
    speculative: Any = False               # False | True | "auto"
    speculative_factor: float = 2.0        # legacy name for the age factor
    straggler_factor: Optional[float] = None   # overrides when set
    seed: int = 0
    # lease-based task reclamation (DESIGN.md §12): a claimed task whose
    # lease expires is requeued for another worker — the safety net for
    # workers that die without reporting.  First-completion-wins dedup
    # keeps a late original settlement harmless (at-most-once, results
    # bit-identical).  None disables leasing entirely.
    lease_seconds: Optional[float] = None

    def effective_straggler_factor(self) -> float:
        return (self.straggler_factor if self.straggler_factor is not None
                else self.speculative_factor)


class TwoPhaseScheduler:
    """Pure scheduling policy — no clock, no threads.  Drivers call
    :meth:`on_worker_idle` / :meth:`on_task_complete` and execute whatever
    assignments come back.

    ``locality_score(task)`` — when provided — is the predicted fetch
    latency of the task's best available data-node replica (the
    datastore's :meth:`~repro_torch.core.datastore.ReplicatedDataStore.
    predicted_task_fetch`); ready tasks are ranked so workers drain
    cheap-data tasks first, at whole ``bucket_key`` granularity so
    same-shape wave fusion survives the reordering.  The ranking is
    recomputed lazily after :meth:`request_rerank` (wired to the
    datastore's node state-change callback), under whatever lock the
    driver already holds for scheduler calls."""

    def __init__(self, n_workers: int, tasks: Sequence[Task],
                 cfg: SchedulerConfig = SchedulerConfig(), *,
                 locality_score: Optional[Callable[[Task], float]] = None,
                 bucket_key: Optional[Callable[[Task], Any]] = None,
                 telemetry=None):
        self.cfg = cfg
        self.n_workers = n_workers
        self.backlog: deque[Task] = deque(tasks)
        self.queues: List[deque[Task]] = [deque() for _ in range(n_workers)]
        self.inflight: Dict[int, Task] = {}
        self.inflight_by_worker: Dict[int, Task] = {}
        # EVERY claimed-but-unsettled task per worker (a wave claim is
        # many tasks) — what crash/lease reclamation recovers.  The
        # single-task ``inflight_by_worker`` keeps its legacy straggler
        # semantics alongside.
        self.claims_by_worker: Dict[int, Dict[int, Task]] = {}
        self._lease: Dict[int, float] = {}   # task_id -> lease expiry
        self._started_at: Dict[int, float] = {}
        self._first_worker: Dict[int, int] = {}
        self._speculated: set = set()
        self._completed: set = set()
        self.speculative_launches = 0
        self.speculation_wins = 0          # clone finished before original
        self.cancelled_tasks = 0           # dropped by cancel_pending()
        self.worker_crashes = 0            # crashed workers reclaimed
        self.reclaimed_tasks = 0           # tasks requeued by crash/lease
        self.lost_tasks = 0                # dropped permanently (degraded)
        self.results: List[TaskResult] = []
        self.depth_trace: List[int] = []   # dynamic-k after each completion
        # one aggregation path (DESIGN.md §13): the bus's aggregator owns
        # the depth_trace appends; a scheduler built without a bus gets a
        # fresh disabled one (aggregation still runs, ring stays empty)
        if telemetry is None:
            from repro_torch.platform.telemetry import null_bus
            telemetry = null_bus()
        self.telemetry = telemetry
        telemetry.bind_depths(self.depth_trace)
        self.avg_exec = None
        self.avg_fetch = None
        self._rng = np.random.default_rng(cfg.seed)
        self._phase2 = False
        self._alive = [True] * n_workers
        self.locality_score = locality_score
        self.bucket_key = bucket_key or (lambda t: len(t.sample_ids))
        self._rank_dirty = False
        self.reranks = 0
        if locality_score is not None:
            self._rank_backlog()

    # -- response-time-aware claim ordering ----------------------------------
    def request_rerank(self) -> None:
        """Mark the ready ranking stale (safe from any thread — the
        re-sort itself happens inside the next scheduler call, under the
        driver's lock)."""
        self._rank_dirty = True

    def _maybe_rerank(self) -> None:
        if self._rank_dirty:
            self._rank_dirty = False
            self._rank_backlog()

    def _rank_backlog(self) -> None:
        if self.locality_score is None or len(self.backlog) <= 1:
            return
        self.backlog = rank_by_bucket(self.backlog, self.bucket_key,
                                      self.locality_score)
        self.reranks += 1

    # -- feedback loop -------------------------------------------------------
    def _observe(self, result: TaskResult) -> None:
        a = 0.3
        self.avg_exec = (result.exec_time if self.avg_exec is None
                         else (1 - a) * self.avg_exec + a * result.exec_time)
        self.avg_fetch = (result.fetch_time if self.avg_fetch is None
                          else (1 - a) * self.avg_fetch + a * result.fetch_time)

    def queue_depth(self) -> int:
        """Dynamic look-ahead k: enough queued work to cover data fetch
        latency (k ≈ fetch/exec + 1), clamped (thesis §3.5)."""
        if not self.avg_exec:
            return self.cfg.min_queue_depth
        k = int(np.ceil((self.avg_fetch or 0.0) / max(self.avg_exec, 1e-9))) + 1
        return int(np.clip(k, self.cfg.min_queue_depth,
                           self.cfg.max_queue_depth))

    # -- assignment ----------------------------------------------------------
    def initial_assignments(self) -> List[Tuple[int, Task]]:
        """Phase 1: one probe task per worker (random order)."""
        order = self._rng.permutation(self.n_workers)
        out = []
        for w in order:
            for _ in range(self.cfg.initial_batch):
                if self.backlog:
                    t = self.backlog.popleft()
                    self.queues[w].append(t)
                    out.append((int(w), t))
        return out

    def _pick_worker_for_refill(self, preferred: int) -> int:
        if not self.cfg.power_of_two:
            return preferred
        other = int(self._rng.integers(self.n_workers))
        if not self._alive[other]:
            return preferred
        return (other if len(self.queues[other]) < len(self.queues[preferred])
                else preferred)

    def on_task_start(self, worker: int, task: Task,
                      now: Optional[float] = None) -> None:
        self.inflight[task.task_id] = task
        self.inflight_by_worker[worker] = task
        self.claims_by_worker.setdefault(worker, {})[task.task_id] = task
        t_now = time.perf_counter() if now is None else now
        if self.cfg.lease_seconds is not None:
            self._lease[task.task_id] = t_now + self.cfg.lease_seconds
        self._first_worker.setdefault(task.task_id, worker)
        # a speculative clone's start must not reset the straggler clock
        if task.task_id not in self._started_at:
            self._started_at[task.task_id] = t_now

    def on_task_complete(self, result: TaskResult,
                         ts: Optional[float] = None
                         ) -> List[Tuple[int, Task]]:
        """Record a result; return new (worker, task) queue assignments.
        First completion wins — a speculative duplicate's second
        completion is ignored (per-task seeds make both bit-identical).
        ``ts`` stamps the settle event in virtual time (simulated
        backend); wall-time drivers leave it unset."""
        self.inflight_by_worker.pop(result.worker_id, None)
        self.claims_by_worker.get(result.worker_id, {}).pop(
            result.task_id, None)
        if result.task_id in self._completed:
            return []
        self._completed.add(result.task_id)
        if (result.task_id in self._speculated
                and self._first_worker.get(result.task_id)
                != result.worker_id):
            self.speculation_wins += 1     # the clone beat the original
        self.inflight.pop(result.task_id, None)
        self._lease.pop(result.task_id, None)
        self._started_at.pop(result.task_id, None)
        self.results.append(result)
        self._observe(result)
        self._phase2 = True
        self._maybe_rerank()
        w = result.worker_id
        out: List[Tuple[int, Task]] = []
        depth = self.queue_depth()
        # the aggregation path appends ``depth`` to self.depth_trace
        self.telemetry.emit(
            "task_settled", ts=ts, task_id=result.task_id,
            worker=result.worker_id, depth=depth,
            fetch_seconds=result.fetch_time,
            exec_seconds=result.exec_time)
        # batched refill: top this worker's queue up to k (two-choice may
        # divert some of the batch to a shorter queue)
        while self.backlog and len(self.queues[w]) < depth:
            target = self._pick_worker_for_refill(w)
            t = self.backlog.popleft()
            self.queues[target].append(t)
            out.append((target, t))
        return out

    def on_worker_idle(self, worker: int,
                       now: Optional[float] = None) -> Optional[Task]:
        """Next task for an idle worker: its own queue, then the backlog,
        then stealing from the deepest queue, then (optionally) a
        speculative re-execution of the longest-running straggler."""
        if not self._alive[worker]:
            return None
        self._maybe_rerank()
        # lease-reclaimed duplicates: a requeued copy whose original
        # settled in the meantime is dropped at claim time, not run again
        q = self.queues[worker]
        while q:
            t = q.popleft()
            if t.task_id not in self._completed:
                return t
        while self.backlog:
            t = self.backlog.popleft()
            if t.task_id not in self._completed:
                return t
        if self.cfg.work_stealing:
            victim = max(range(self.n_workers),
                         key=lambda i: len(self.queues[i]))
            while len(self.queues[victim]) > 1:
                t = self.queues[victim].pop()      # steal from the tail
                if t.task_id not in self._completed:
                    return t
        if self.cfg.speculative and self.avg_exec and self._started_at:
            t_now = time.perf_counter() if now is None else now
            factor = self.cfg.effective_straggler_factor()
            threshold = factor * self.avg_exec
            candidates = [(t_now - started, tid) for tid, started
                          in self._started_at.items()
                          if tid not in self._speculated
                          and self.inflight_by_worker.get(worker, None)
                          is not self.inflight.get(tid)]
            candidates = [(age, tid) for age, tid in candidates
                          if age > threshold]
            if self.cfg.speculative == "auto":
                # §3.3 economics per clone: worth it only when the
                # expected saving beats the clone's standing tax
                candidates = [
                    (age, tid) for age, tid in candidates
                    if rec.should_speculate(age, self.avg_exec,
                                            straggler_factor=factor)]
            if candidates:
                _, tid = max(candidates)
                self._speculated.add(tid)
                self.speculative_launches += 1
                return self.inflight[tid]
        return None

    def next_speculation_time(self) -> Optional[float]:
        """Earliest clock time at which some in-flight task becomes
        speculation-eligible (None when speculation is off or nothing
        qualifies) — the virtual-time driver re-polls idle workers at
        exactly this moment instead of on a coarse exec-EMA grid, so a
        clone launches the instant the cost model allows it."""
        if not (self.cfg.speculative and self.avg_exec):
            return None
        factor = self.cfg.effective_straggler_factor()
        if self.cfg.speculative == "auto":
            # should_speculate additionally needs gain > clone tax
            factor = max(factor, 1.0 + rec.SPECULATION_CLONE_TAX)
        times = [started + factor * self.avg_exec
                 for tid, started in self._started_at.items()
                 if tid not in self._speculated]
        if not times:
            return None
        return min(times) + 1e-9       # strict-inequality epsilon

    def claim_batch(self, worker: int, first: Task, max_n: int,
                    key_fn: Callable[[Task], Any]) -> List[Task]:
        """Wave draining: extend ``first`` (already claimed via
        :meth:`on_worker_idle`) with more ready tasks whose shape key
        matches, popped FIFO from this worker's own queue and then the
        backlog.  The first key mismatch stops the drain so waves stay
        same-shape (one compiled kernel per wave); the caller bounds
        ``max_n`` (the driver sizes it per shape bucket so every worker
        gets a fair share and one worker cannot swallow the backlog).
        The caller must :meth:`on_task_start` every claimed task.

        Crash recovery tracks the FULL wave: every claimed task lands in
        ``claims_by_worker`` at :meth:`on_task_start`, so
        :meth:`on_worker_crash` / :meth:`reclaim_expired` recover every
        wave member of a dead worker, not just the last one (the legacy
        single-slot ``inflight_by_worker`` only feeds straggler
        speculation)."""
        q = self.queues[worker]
        out = [first]
        key = key_fn(first)
        while len(out) < max_n and q and key_fn(q[0]) == key:
            t = q.popleft()
            if t.task_id not in self._completed:
                out.append(t)
        while (len(out) < max_n and self.backlog
               and key_fn(self.backlog[0]) == key):
            t = self.backlog.popleft()
            if t.task_id not in self._completed:
                out.append(t)
        return out

    def cancel_pending(self) -> List[Task]:
        """DRAINING (DESIGN.md §10): drop every not-yet-started task —
        the backlog and all per-worker queues — leaving in-flight tasks
        to settle normally, after which :meth:`done` turns true.  The
        early-termination analogue of :meth:`MultiJobScheduler.
        cancel_job`; idempotent, returns what was dropped so the driver
        can account ``tasks_cancelled``."""
        dropped: List[Task] = list(self.backlog)
        self.backlog.clear()
        for q in self.queues:
            dropped.extend(q)
            q.clear()
        self.cancelled_tasks += len(dropped)
        if dropped:
            self.telemetry.emit("job_draining", n_cancelled=len(dropped))
        return dropped

    def on_worker_failure(self, worker: int) -> List[Task]:
        """Job-level: raise (driver restarts whole job).  Task-level:
        reclaim the dead worker's queued+inflight tasks for re-execution."""
        self._alive[worker] = False
        if self.cfg.recovery == "job":
            raise JobFailure(f"worker {worker} failed; job-level restart",
                             failed_worker=worker)
        reclaimed = list(self.queues[worker])
        self.queues[worker].clear()
        own = self.inflight_by_worker.pop(worker, None)
        claims = self.claims_by_worker.pop(worker, {})
        if own is not None:
            claims.setdefault(own.task_id, own)
        for t in claims.values():
            self.inflight.pop(t.task_id, None)
            self._lease.pop(t.task_id, None)
            reclaimed.append(t)
        for t in reclaimed:
            # reset the straggler clock: the re-execution must not
            # inherit the dead worker's elapsed time (it would be
            # instantly speculation-eligible)
            self._started_at.pop(t.task_id, None)
            self._first_worker.pop(t.task_id, None)
        self.backlog.extend(reclaimed)
        return reclaimed

    def on_worker_crash(self, worker: int, *,
                        respawn: bool = True) -> List[Task]:
        """A worker thread died mid-task (detected or injected): requeue
        EVERY claimed-but-unsettled task it held — the whole wave, plus
        its queued work — at the FRONT of the backlog so recovery work
        drains first.  Unlike :meth:`on_worker_failure` this never
        aborts the job: the runner respawns the worker under the same id
        (``respawn=True`` keeps it alive in the scheduler) and
        first-completion-wins dedup keeps any late settlement from the
        dead thread harmless.  Idempotent per crash."""
        self.worker_crashes += 1
        reclaimed = [t for t in self.queues[worker]
                     if t.task_id not in self._completed]
        self.queues[worker].clear()
        self.inflight_by_worker.pop(worker, None)
        claims = self.claims_by_worker.pop(worker, {})
        for tid, t in claims.items():
            if tid not in self._completed:
                reclaimed.append(t)
        seen: set = set()
        requeue: List[Task] = []
        for t in reclaimed:
            if t.task_id in seen:
                continue
            seen.add(t.task_id)
            self.inflight.pop(t.task_id, None)
            self._lease.pop(t.task_id, None)
            self._started_at.pop(t.task_id, None)
            self._first_worker.pop(t.task_id, None)
            requeue.append(t)
        self.backlog.extendleft(reversed(requeue))
        self.reclaimed_tasks += len(requeue)
        self.telemetry.emit("worker_crash", worker=worker,
                            reclaimed=len(requeue), respawn=respawn)
        if not respawn:
            self._alive[worker] = False
        return requeue

    def reclaim_expired(self, now: Optional[float] = None) -> List[Task]:
        """Lease expiry sweep (drivers call this from idle workers): any
        claimed task whose lease has lapsed is requeued at the front of
        the backlog for re-execution — the safety net for workers that
        die without a detectable crash.  The original claim stays live
        (a slow-but-alive worker may still settle first; dedup keeps it
        at-most-once), so the re-execution behaves exactly like a
        speculative clone with the task's own seed: bit-identical."""
        if self.cfg.lease_seconds is None or not self._lease:
            return []
        t_now = time.perf_counter() if now is None else now
        expired = [tid for tid, exp in self._lease.items()
                   if exp <= t_now and tid not in self._completed]
        out: List[Task] = []
        for tid in expired:
            self._lease.pop(tid, None)
            task = self.inflight.get(tid)
            if task is None:
                continue
            # reset the straggler clock for the re-execution
            self._started_at.pop(tid, None)
            self.backlog.appendleft(task)
            self.reclaimed_tasks += 1
            out.append(task)
        if out:
            self.telemetry.emit(
                "lease_reclaimed", n=len(out),
                task_ids=tuple(t.task_id for t in out))
        return out

    def on_tasks_lost(self, worker: int, tasks: Sequence[Task]) -> None:
        """Permanently drop claimed tasks whose data is gone (every
        replica down, retry budget spent): settle them OUT of the
        in-flight accounting without marking them completed, so a
        degraded drain can finish from what actually executed instead of
        hanging on tasks that can never settle."""
        claims = self.claims_by_worker.get(worker, {})
        for t in tasks:
            if t.task_id in self._completed:
                continue
            claims.pop(t.task_id, None)
            self.inflight.pop(t.task_id, None)
            self._lease.pop(t.task_id, None)
            self._started_at.pop(t.task_id, None)
            self._first_worker.pop(t.task_id, None)
            self.lost_tasks += 1
        self.inflight_by_worker.pop(worker, None)

    def done(self) -> bool:
        return (not self.backlog and not self.inflight
                and all(not q for q in self.queues))


# ---------------------------------------------------------------------------
# Multi-job service scheduling (service layer, DESIGN.md §8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiJobConfig:
    quantum: float = 8.0          # DRR credit added per visit (tasks)
    deadline_headroom: float = 1.5   # boost when slack < headroom·remaining
    default_task_seconds: float = 1e-3   # est. before any completion
    # straggler speculation (False | True | "auto" — as SchedulerConfig):
    # idle pool workers clone in-flight tasks older than
    # straggler_factor × the pool-wide exec EMA; first completion wins
    speculative: Any = False
    straggler_factor: float = 2.0
    # lease-based reclamation across the pool (None disables): claimed
    # tasks whose lease lapses are requeued to their job's front
    lease_seconds: Optional[float] = None


@dataclasses.dataclass
class ServiceJob:
    """One admitted job's scheduling state: a FIFO of job-tagged tasks
    plus the deficit-round-robin / deadline bookkeeping."""

    job_id: int
    pending: "deque[Task]"
    n_tasks: int
    fuse_key: Callable[[Task], Any]     # cross-job wave-fusion identity
    cap: Callable[[Task], int]          # wave width for a task's bucket
    priority: int = 0
    deadline: Optional[float] = None    # absolute (caller's clock)
    weight: float = 1.0
    deficit: float = 0.0
    inflight: int = 0
    completed: int = 0
    # response-time locality (predicted best-replica fetch seconds)
    locality_score: Optional[Callable[[Task], float]] = None
    # straggler-speculation bookkeeping (first completion wins)
    inflight_tasks: Dict[int, Task] = dataclasses.field(default_factory=dict)
    started_at: Dict[int, float] = dataclasses.field(default_factory=dict)
    speculated: set = dataclasses.field(default_factory=set)
    completed_ids: set = dataclasses.field(default_factory=set)

    @property
    def done(self) -> bool:
        return self.completed >= self.n_tasks


class MultiJobScheduler:
    """Ready-queue policy for many concurrent jobs on one resident pool.

    Pure policy, externally locked (like :class:`TwoPhaseScheduler`):
    the service pool calls :meth:`claim` under its lock and executes the
    returned batch outside it.

    * **Fairness** — deficit round robin across jobs, at *wave*
      granularity: serving a job credits it ``quantum × weight``
      task-units and debits the tasks actually taken, and each claim
      picks the least-served ready job (highest deficit, round-robin
      order breaking ties) in the highest priority tier — so a
      1000-task job cannot starve an 8-task job.  A wave is never
      truncated below its bucket width (padding would waste the
      difference); the deficit only carries the imbalance forward.
    * **Deadline boost** — a job whose slack (deadline − now) falls
      under ``deadline_headroom ×`` its estimated remaining runtime
      jumps the round-robin order (earliest deadline first among the
      urgent).
    * **Cross-job wave fusion** — a claimed batch starts FIFO from the
      chosen job and is then *filled* with ready tasks from other jobs
      whose ``fuse_key`` matches (same dataset arena + engine + block
      shape), so one device dispatch serves several jobs.  Fused tasks
      are charged to their own job's deficit, keeping fairness intact.
    """

    def __init__(self, n_workers: int,
                 cfg: MultiJobConfig = MultiJobConfig(), *,
                 telemetry=None):
        self.cfg = cfg
        if telemetry is None:
            from repro_torch.platform.telemetry import null_bus
            telemetry = null_bus()
        self.telemetry = telemetry
        self.n_workers = max(n_workers, 1)
        self.jobs: Dict[int, ServiceJob] = {}
        self._rr: deque[int] = deque()      # active round-robin order
        self.avg_task_seconds: Optional[float] = None
        self.fused_dispatches = 0           # batches spanning >1 job
        self.claims = 0
        self.speculative_launches = 0
        self.speculation_wins = 0
        self._rank_dirty = False
        self.reranks = 0
        # crash/lease recovery: every claimed-but-unsettled (job, task)
        # per worker, and per-claim lease expiries
        self.claimed_by: Dict[int, Dict[Tuple[int, int], Task]] = {}
        self._lease: Dict[Tuple[int, int], float] = {}
        self.worker_crashes = 0
        self.reclaimed_tasks = 0
        self.lost_tasks = 0

    # -- job lifecycle -------------------------------------------------------
    def add_job(self, job_id: int, tasks: Sequence[Task], *,
                fuse_key: Optional[Callable[[Task], Any]] = None,
                cap: Any = 1, priority: int = 0,
                deadline: Optional[float] = None,
                weight: float = 1.0,
                locality_score: Optional[Callable[[Task], float]] = None,
                ) -> ServiceJob:
        if job_id in self.jobs:
            raise ValueError(f"job {job_id} already scheduled")
        cap_fn = cap if callable(cap) else (lambda t, _c=int(cap): _c)
        job = ServiceJob(
            job_id=job_id, pending=deque(tasks), n_tasks=len(tasks),
            fuse_key=fuse_key or (lambda t: (job_id, t.task_id)),
            cap=cap_fn, priority=priority, deadline=deadline,
            weight=weight, locality_score=locality_score)
        if locality_score is not None:
            self._rank_job(job)
        self.jobs[job_id] = job
        self._rr.append(job_id)
        return job

    # -- response-time-aware claim ordering ----------------------------------
    def request_rerank(self) -> None:
        """Mark every job's ready ranking stale (safe from any thread —
        re-sorting happens inside the next :meth:`claim`, under the
        pool's lock)."""
        self._rank_dirty = True

    def _maybe_rerank(self) -> None:
        if not self._rank_dirty:
            return
        self._rank_dirty = False
        for job in self.jobs.values():
            if job.locality_score is not None:
                self._rank_job(job)

    def _rank_job(self, job: ServiceJob) -> None:
        if len(job.pending) <= 1:
            return
        job.pending = rank_by_bucket(job.pending, job.fuse_key,
                                     job.locality_score)
        self.reranks += 1

    def cancel_job(self, job_id: int) -> List[Task]:
        """Drop a job's queued tasks (in-flight ones finish and are
        discarded by the caller); returns what was dropped."""
        job = self.jobs.get(job_id)
        if job is None:
            return []
        dropped = list(job.pending)
        job.pending.clear()
        job.n_tasks -= len(dropped)
        self._drop_from_rotation(job_id)
        if job.inflight == 0:
            self.jobs.pop(job_id, None)
        return dropped

    def fail_job(self, job_id: int) -> None:
        """Remove a job whose batch errored: queued tasks are dropped and
        in-flight accounting is abandoned (the pool already owns the
        error fan-out); peers are unaffected — recovery is job-level,
        per job (thesis §3.3 applied per tenant)."""
        job = self.jobs.pop(job_id, None)
        if job is not None:
            job.pending.clear()
        self._drop_from_rotation(job_id)

    def _drop_from_rotation(self, job_id: int) -> None:
        """A job leaving ``self.jobs`` (or losing all pending tasks) must
        leave ``_rr`` too: :meth:`_pick` only prunes stale ids at the
        *front* of the rotation, so a mid-rotation leftover would index a
        popped job."""
        try:
            self._rr.remove(job_id)
        except ValueError:
            pass

    def pending_tasks(self) -> int:
        return sum(len(j.pending) for j in self.jobs.values())

    def has_ready(self) -> bool:
        return any(j.pending for j in self.jobs.values())

    def peek(self, n: int, now: float = 0.0) -> List[Tuple[ServiceJob,
                                                           Task]]:
        """Up to ``n`` upcoming (job, task) pairs, without claiming —
        the prefetcher's look-ahead window.  Ordered like :meth:`claim`
        would serve them (deadline-urgent job first, then priority tier
        and deficit, rotation breaking ties): a rotation-order peek
        would warm the WRONG job's fetches whenever a boost or a
        priority tier redirects the next claim."""
        rot = {jid: i for i, jid in enumerate(self._rr)}
        ready = [j for jid in self._rr
                 if (j := self.jobs.get(jid)) is not None and j.pending]
        ready.sort(key=lambda j: (-j.priority, -j.deficit,
                                  rot.get(j.job_id, 0)))
        urgent = self._urgent(now)
        if urgent is not None:
            ready = [urgent] + [j for j in ready if j is not urgent]
        out: List[Tuple[ServiceJob, Task]] = []
        for job in ready:
            for t in job.pending:
                out.append((job, t))
                if len(out) >= n:
                    return out
        return out

    # -- deadline model ------------------------------------------------------
    def _task_seconds(self) -> float:
        return self.avg_task_seconds or self.cfg.default_task_seconds

    def est_remaining(self, job: ServiceJob) -> float:
        """Remaining runtime if the pool served only this job."""
        left = len(job.pending) + job.inflight
        return left * self._task_seconds() / self.n_workers

    def _urgent(self, now: float) -> Optional[ServiceJob]:
        urgent = [j for j in self.jobs.values()
                  if j.pending and j.deadline is not None
                  and (j.deadline - now) < (self.cfg.deadline_headroom
                                            * self.est_remaining(j))]
        if not urgent:
            return None
        return min(urgent, key=lambda j: j.deadline)

    # -- claim ---------------------------------------------------------------
    def _pick(self, now: float) -> Optional[ServiceJob]:
        # lazily drop drained/cancelled entries from the rotation
        while self._rr and (self._rr[0] not in self.jobs
                            or not self.jobs[self._rr[0]].pending):
            self._rr.popleft()
        boosted = self._urgent(now)
        if boosted is not None:
            return boosted
        # ``.get``: defensive against rotation entries whose job was
        # removed out-of-band — never KeyError inside a pool worker
        ready = [j for jid in self._rr
                 if (j := self.jobs.get(jid)) is not None and j.pending]
        if not ready:
            return None
        top = max(j.priority for j in ready)
        tier = [j for j in ready if j.priority == top]
        # least-served first: highest deficit; ties fall to round-robin
        # order (max() keeps the first maximum, and served jobs rotate
        # to the back of ``_rr``)
        return max(tier, key=lambda j: j.deficit)

    def claim(self, now: float, max_n: Optional[int] = None,
              worker: Optional[int] = None) -> List[Tuple[ServiceJob,
                                                          Task]]:
        """Claim the next batch for an idle worker: ``[]`` when nothing
        is ready.  Every claimed task is marked in-flight; the caller
        reports each back through :meth:`on_task_complete`.  ``worker``
        tags the claim for crash/lease reclamation (a dead worker's
        claims are requeued by :meth:`on_worker_dead`)."""
        self._maybe_rerank()
        job = self._pick(now)
        if job is None:
            return []
        self.claims += 1
        job.deficit += self.cfg.quantum * job.weight
        first = job.pending[0]
        key = job.fuse_key(first)
        cap = max(int(job.cap(first)), 1)
        if max_n is not None:
            cap = min(cap, max_n)
        batch: List[Tuple[ServiceJob, Task]] = []
        while (job.pending and len(batch) < cap
               and job.fuse_key(job.pending[0]) == key):
            t = job.pending.popleft()
            # a lease-reclaimed duplicate whose original settled is
            # dropped at claim time, never re-executed
            if t.task_id in job.completed_ids:
                continue
            batch.append((job, t))
        # debit what was actually served; cap the carried credit at one
        # quantum so an idle-ish job cannot hoard turns
        job.deficit = min(job.deficit - len(batch), self.cfg.quantum)
        # rotate the served job to the back of the round-robin order
        self._drop_from_rotation(job.job_id)
        if job.pending:
            self._rr.append(job.job_id)
        # cross-job fusion fill: same fuse key, FIFO from each peer
        if cap > 1 and len(batch) < cap:
            for jid in list(self._rr):
                peer = self.jobs.get(jid)
                if peer is None or peer is job:
                    continue
                took = 0
                while (peer.pending and len(batch) < cap
                       and peer.fuse_key(peer.pending[0]) == key):
                    t = peer.pending.popleft()
                    if t.task_id in peer.completed_ids:
                        continue
                    batch.append((peer, t))
                    took += 1
                if took:
                    peer.deficit -= took    # fused service still counts
        if len({j.job_id for j, _ in batch}) > 1:
            self.fused_dispatches += 1
        for j, t in batch:
            j.inflight += 1
            j.inflight_tasks[t.task_id] = t
            j.started_at.setdefault(t.task_id, now)
            self._record_claim(worker, j.job_id, t, now)
        if batch:
            by_job: Dict[int, List[int]] = {}
            for j, t in batch:
                by_job.setdefault(j.job_id, []).append(t.task_id)
            for jid, tids in by_job.items():
                self.telemetry.emit("task_claimed", job_id=jid,
                                    task_ids=tuple(tids), worker=worker)
        return batch

    def _record_claim(self, worker: Optional[int], job_id: int,
                      task: Task, now: float) -> None:
        if worker is not None:
            self.claimed_by.setdefault(worker, {})[
                (job_id, task.task_id)] = task
        if self.cfg.lease_seconds is not None:
            self._lease[(job_id, task.task_id)] = (
                now + self.cfg.lease_seconds)

    def claim_speculative(self, now: float,
                          cfg_speculative: Any = None,
                          worker: Optional[int] = None,
                          ) -> List[Tuple[ServiceJob, Task]]:
        """Straggler speculation for an idle pool worker when nothing is
        ready: clone the oldest in-flight task whose age exceeds
        ``straggler_factor ×`` the pool-wide exec EMA (``"auto"`` mode
        additionally requires the clone to beat its standing tax per the
        §3.3 cost model).  The clone re-executes with the task's own
        seed, so first-completion-wins is bit-exact; each task is cloned
        at most once."""
        speculative = (self.cfg.speculative if cfg_speculative is None
                       else cfg_speculative)
        ema = self.avg_task_seconds
        if not speculative or not ema:
            return []
        factor = self.cfg.straggler_factor
        best: Optional[Tuple[float, ServiceJob, Task]] = None
        for job in self.jobs.values():
            for tid, started in job.started_at.items():
                if tid in job.speculated or tid in job.completed_ids:
                    continue
                task = job.inflight_tasks.get(tid)
                if task is None:
                    continue
                age = now - started
                if age <= factor * ema:
                    continue
                if speculative == "auto" and not rec.should_speculate(
                        age, ema, straggler_factor=factor):
                    continue
                if best is None or age > best[0]:
                    best = (age, job, task)
        if best is None:
            return []
        _, job, task = best
        job.speculated.add(task.task_id)
        job.inflight += 1
        self.speculative_launches += 1
        self._record_claim(worker, job.job_id, task, now)
        return [(job, task)]

    def on_task_abandoned(self, job_id: int, task_id: int,
                          worker: Optional[int] = None) -> None:
        """Settle a claimed task that will never complete — a
        speculative clone whose execution failed.  In-flight accounting
        only: the original still owns completion, and a lost redundant
        bet must never fail or finish the job."""
        if worker is not None:
            self.claimed_by.get(worker, {}).pop((job_id, task_id), None)
        job = self.jobs.get(job_id)
        if job is not None:
            job.inflight -= 1

    def on_task_complete(self, job_id: int,
                         exec_seconds: Optional[float],
                         task_id: Optional[int] = None,
                         speculative: bool = False,
                         worker: Optional[int] = None,
                         fetch_seconds: Optional[float] = None) -> bool:
        """Record one finished task; True when its job just completed.
        ``exec_seconds`` feeds the per-task-seconds EMA the deadline
        model uses; pass ``None`` to settle in-flight accounting without
        a timing sample (tasks claimed from an already-cancelled job
        never execute, and a 0.0 sample would drag the deadline-boost
        and admission estimates toward zero).  ``task_id`` enables
        first-completion-wins accounting for speculative clones: the
        duplicate completion settles the in-flight count without
        double-counting progress.  ``speculative`` marks a completion
        delivered by a :meth:`claim_speculative` batch — a clone only
        counts as a *win* when it, not the original, completed first."""
        if exec_seconds is not None:
            a = 0.3
            self.avg_task_seconds = (
                exec_seconds if self.avg_task_seconds is None
                else (1 - a) * self.avg_task_seconds + a * exec_seconds)
        if worker is not None and task_id is not None:
            self.claimed_by.get(worker, {}).pop((job_id, task_id), None)
        if task_id is not None:
            self._lease.pop((job_id, task_id), None)
        job = self.jobs.get(job_id)
        if job is None:
            return False
        job.inflight -= 1
        duplicate = (task_id is not None and task_id in job.completed_ids)
        if not duplicate:
            # depth/fetch_seconds feed the monitor's queue-depth SLI and
            # critical-path fetch attribution (DESIGN.md §15) — the
            # single-job scheduler's settle carries the same fields
            self.telemetry.emit(
                "task_settled", job_id=job_id, task_id=task_id,
                worker=worker, exec_seconds=exec_seconds,
                fetch_seconds=fetch_seconds, speculative=speculative,
                depth=sum(len(j.pending) for j in self.jobs.values()))
            job.completed += 1
            if task_id is not None:
                job.completed_ids.add(task_id)
                if speculative and task_id in job.speculated:
                    self.speculation_wins += 1
                job.inflight_tasks.pop(task_id, None)
                job.started_at.pop(task_id, None)
        # with task ids, genuine outstanding work is inflight_tasks —
        # the job completes at its FIRST full completion even while a
        # speculative clone still races (the duplicate settles against a
        # job that has already left the table); legacy callers without
        # task ids fall back to the raw in-flight count
        finished = (job.done
                    and ((not job.inflight_tasks) if task_id is not None
                         else job.inflight == 0))
        if finished and job.pending:
            # crash/lease requeues can leave already-completed
            # duplicates in pending; they never execute, so the job
            # finishes when every pending entry is such a duplicate
            finished = all(t.task_id in job.completed_ids
                           for t in job.pending)
            if finished:
                job.pending.clear()
                self._drop_from_rotation(job_id)
        if finished:
            self.jobs.pop(job_id, None)
            return True
        return False

    # -- crash / lease reclamation (DESIGN.md §12) ---------------------------
    def on_worker_dead(self, worker: int) -> List[Tuple[int, Task]]:
        """A pool worker thread died: requeue every claimed-but-
        unsettled task it held to the FRONT of its job's pending queue
        (recovery work drains first).  Settlement stays at-most-once —
        completed ids are skipped here and duplicates are dropped at
        claim time — so results are bit-identical to the fault-free
        run.  Returns the requeued (job_id, task) pairs."""
        self.worker_crashes += 1
        self.telemetry.emit("worker_crash", worker=worker)
        claims = self.claimed_by.pop(worker, {})
        requeued: List[Tuple[int, Task]] = []
        for (jid, tid), task in claims.items():
            self._lease.pop((jid, tid), None)
            job = self.jobs.get(jid)
            if job is None or tid in job.completed_ids:
                continue
            job.inflight -= 1
            job.inflight_tasks.pop(tid, None)
            job.started_at.pop(tid, None)
            job.speculated.discard(tid)
            job.pending.appendleft(task)
            if jid not in self._rr:
                self._rr.append(jid)
            self.reclaimed_tasks += 1
            requeued.append((jid, task))
        return requeued

    def reclaim_expired(self, now: float) -> List[Tuple[int, Task]]:
        """Lease-expiry sweep (idle pool workers call this): requeue
        claimed tasks whose lease lapsed.  The original claim's
        accounting stays live (a slow worker may still settle first —
        dedup keeps it at-most-once); the re-execution runs with the
        task's own seed, so the race is bit-identical either way."""
        if self.cfg.lease_seconds is None or not self._lease:
            return []
        expired = [k for k, exp in self._lease.items() if exp <= now]
        out: List[Tuple[int, Task]] = []
        for jid, tid in expired:
            self._lease.pop((jid, tid), None)
            job = self.jobs.get(jid)
            if job is None or tid in job.completed_ids:
                continue
            task = job.inflight_tasks.get(tid)
            if task is None:
                continue
            # like a speculative clone: the original may still settle
            job.speculated.add(tid)
            job.pending.appendleft(task)
            if jid not in self._rr:
                self._rr.append(jid)
            self.reclaimed_tasks += 1
            out.append((jid, task))
        if out:
            self.telemetry.emit(
                "lease_reclaimed", n=len(out),
                task_ids=tuple(t.task_id for _, t in out),
                job_ids=tuple(jid for jid, _ in out))
        return out

    def on_task_lost(self, job_id: int, task_id: int,
                     worker: Optional[int] = None) -> bool:
        """Permanent loss (every replica of the task's data is gone):
        settle the claim WITHOUT completion and shrink the job so a
        degraded drain can finish from what actually executed.  Returns
        True when the job just finished (degraded)."""
        if worker is not None:
            self.claimed_by.get(worker, {}).pop((job_id, task_id), None)
        self._lease.pop((job_id, task_id), None)
        job = self.jobs.get(job_id)
        if job is None:
            return False
        job.inflight -= 1
        job.inflight_tasks.pop(task_id, None)
        job.started_at.pop(task_id, None)
        if task_id not in job.completed_ids:
            job.n_tasks -= 1
            self.lost_tasks += 1
        finished = (job.done
                    and not job.inflight_tasks
                    and all(t.task_id in job.completed_ids
                            for t in job.pending))
        if finished:
            job.pending.clear()
            self._drop_from_rotation(job_id)
            self.jobs.pop(job_id, None)
            return True
        return False


# ---------------------------------------------------------------------------
# Discrete-event simulation driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimWorker:
    worker_id: int
    speed: float = 1.0                 # <1 ⇒ slower (heterogeneity, Fig 14)
    fail_at: Optional[float] = None    # inject a failure at this sim time


@dataclasses.dataclass
class SimParams:
    """Per-task cost model, calibrated from real measured runs."""
    exec_time: Callable[[Task], float]       # seconds on a speed-1.0 worker
    fetch_time: Callable[[Task], float]      # data-fetch latency
    launch_overhead: float = 0.0             # per-task start cost (Fig 5/6)
    startup_time: float = 0.0                # one-time job startup


@dataclasses.dataclass
class SimOutcome:
    makespan: float
    results: List[TaskResult]
    per_worker_busy: Dict[int, float]
    restarts: int = 0
    queue_depths: List[int] = dataclasses.field(default_factory=list)
    speculative_launches: int = 0
    speculation_wins: int = 0


def simulate_job(
    tasks: Sequence[Task],
    workers: Sequence[SimWorker],
    params: SimParams,
    cfg: SchedulerConfig = SchedulerConfig(),
    *,
    max_restarts: int = 3,
    locality_score: Optional[Callable[[Task], float]] = None,
    bucket_key: Optional[Callable[[Task], Any]] = None,
    stopper=None,
    telemetry=None,
) -> SimOutcome:
    """Run the two-phase scheduler under virtual time.  Prefetch overlap:
    a task's data fetch for queued work proceeds while the previous task
    executes, so effective per-task cost is max(exec, fetch) once the
    queue is warm (exactly the paper's pipeline in §3.5).  ``stopper`` —
    a :class:`~repro_torch.core.estimator.StoppingController` — is fed each
    completion and, once converged, the backlog is cancelled (DRAINING):
    the early-termination decision lands at the same completed-task
    count a real cluster would reach it at."""
    restarts = 0
    alive = list(workers)
    while True:
        try:
            return _simulate_once(tasks, alive, params, cfg, restarts,
                                  locality_score=locality_score,
                                  bucket_key=bucket_key, stopper=stopper,
                                  telemetry=telemetry)
        except JobFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            if stopper is not None:
                # job-level restart discards and re-executes every
                # completion; a latched (or partially fed) stopper would
                # drain the retry at its first settlement with an answer
                # far thinner than its recorded convergence claims
                stopper.reset()
            # the dead node does not rejoin; the job restarts on survivors
            survivors = [w for w in alive
                         if w.worker_id != e.failed_worker]
            if survivors:
                alive = survivors


def _simulate_once(tasks, workers, params, cfg, restarts, *,
                   locality_score=None, bucket_key=None,
                   stopper=None, telemetry=None) -> SimOutcome:
    """Worker identity inside the scheduler is positional (0..n-1); the
    SimWorker.worker_id is only used for reporting (survivor restarts
    renumber positions but keep ids)."""
    sched = TwoPhaseScheduler(len(workers), tasks, cfg,
                              locality_score=locality_score,
                              bucket_key=bucket_key, telemetry=telemetry)
    bus = sched.telemetry
    now = params.startup_time
    busy: Dict[int, float] = {w.worker_id: 0.0 for w in workers}
    # event heap: (time, seq, kind, worker_index, task)
    seq = itertools.count()
    heap: List[Tuple[float, int, str, int, Optional[Task]]] = []
    cost_mult = 1.0 + (cfg.cost_tl if cfg.recovery == "task" else 0.0)

    def task_cost(w: SimWorker, t: Task, queue_warm: bool) -> Tuple[float, float, float]:
        fetch = params.fetch_time(t)
        ex = (params.exec_time(t) / w.speed + params.launch_overhead) * cost_mult
        # warm queue ⇒ fetch overlapped with previous execution
        total = max(ex, fetch) if queue_warm else ex + fetch
        return total, fetch, ex

    for i, w in enumerate(workers):
        if w.fail_at is not None:
            heapq.heappush(heap, (w.fail_at, next(seq), "fail", i, None))

    for widx, task in sched.initial_assignments():
        t = sched.on_worker_idle(widx, now)
        if t is None:
            continue
        sched.on_task_start(widx, t, now)
        bus.emit("task_claimed", ts=now, task_ids=(t.task_id,),
                 worker=widx)
        total, fetch, ex = task_cost(workers[widx], t, queue_warm=False)
        heapq.heappush(heap, (now + total, next(seq), "done", widx, t))
        busy[workers[widx].worker_id] += total

    makespan = now
    has_event = [True] * len(workers)

    def dispatch(widx: int, at: float):
        nxt = sched.on_worker_idle(widx, at)
        if nxt is not None:
            sched.on_task_start(widx, nxt, at)
            bus.emit("task_claimed", ts=at, task_ids=(nxt.task_id,),
                     worker=widx)
            total, _, _ = task_cost(workers[widx], nxt, queue_warm=True)
            heapq.heappush(heap, (at + total, next(seq), "done", widx, nxt))
            busy[workers[widx].worker_id] += total
            has_event[widx] = True
        elif cfg.speculative and not sched.done() and sched.avg_exec:
            # re-poll exactly when a straggler first becomes
            # speculation-eligible (fall back to an exec-EMA tick)
            eligible_at = sched.next_speculation_time()
            when = (max(eligible_at, at + 1e-9) if eligible_at is not None
                    else at + sched.avg_exec)
            heapq.heappush(heap, (when, next(seq), "poll", widx, None))
            has_event[widx] = True

    while heap:
        now, _, kind, widx, task = heapq.heappop(heap)
        if kind == "fail":
            if sched.done():
                continue
            try:
                sched.on_worker_failure(widx)   # raises under job-level
            except JobFailure:
                # translate positional index to the stable worker id so the
                # restart loop can exclude the dead node
                raise JobFailure(
                    f"worker {workers[widx].worker_id} failed; "
                    "job-level restart",
                    failed_worker=workers[widx].worker_id) from None
            has_event[widx] = False
            # reclaimed tasks: wake any idle living workers
            for i in range(len(workers)):
                if sched._alive[i] and not has_event[i]:
                    dispatch(i, now)
            continue
        has_event[widx] = False
        if kind == "poll":
            if not sched.done():
                dispatch(widx, now)
            continue
        if not sched._alive[widx]:
            continue                        # completion from a dead worker
        total_prev, fetch, ex = task_cost(workers[widx], task,
                                          queue_warm=True)
        res = TaskResult(task.task_id, widx, now - total_prev, fetch, ex)
        # a straggler superseded by its speculative copy doesn't extend
        # the job (its late completion is discarded)
        is_dup = task.task_id in sched._completed
        sched.on_task_complete(res, ts=now)
        if not is_dup:
            makespan = max(makespan, now)
            if stopper is not None:
                # wave-settlement stopping check (DESIGN.md §10): on
                # convergence the ready work is dropped; the in-flight
                # "done" events already on the heap settle normally
                stopper.on_complete(task.task_id)
                if stopper.should_stop():
                    sched.cancel_pending()
        dispatch(widx, now)
    return SimOutcome(makespan=makespan, results=sched.results,
                      per_worker_busy=busy, restarts=restarts,
                      queue_depths=list(sched.depth_trace),
                      speculative_launches=sched.speculative_launches,
                      speculation_wins=sched.speculation_wins)


# ---------------------------------------------------------------------------
# Threaded driver (real wall time)
# ---------------------------------------------------------------------------


class ThreadedRunner:
    """Executes tasks with real threads; one queue per worker.  The worker
    callable receives (task) and returns a value; fetch is performed by the
    optional datastore before execution (overlapped via the queue).

    Wave mode: with ``run_batch`` set (and ``max_batch > 1``), an idle
    worker drains up to ``max_batch`` ready tasks of the same ``batch_key``
    shape in one claim and executes them through ``run_batch(tasks) ->
    values`` — one device dispatch per wave instead of per task.  Each
    task still yields its own :class:`TaskResult` (exec time split evenly)
    so the feedback loop and straggler accounting are unchanged."""

    def __init__(self, n_workers: int,
                 run_task: Callable[[Task], Any],
                 fetch: Optional[Callable[[Task], Any]] = None,
                 cfg: SchedulerConfig = SchedulerConfig(),
                 run_batch: Optional[Callable[[List[Task]],
                                              List[Any]]] = None,
                 batch_key: Optional[Callable[[Task], Any]] = None,
                 max_batch: int = 1,
                 batch_cap: Optional[Callable[[Task], int]] = None,
                 locality_score: Optional[Callable[[Task], float]] = None,
                 prefetcher=None, stopper=None,
                 crash_hook: Optional[Callable[[int], None]] = None,
                 max_respawns: int = 2,
                 telemetry=None):
        self.n_workers = n_workers
        if telemetry is None:
            from repro_torch.platform.telemetry import null_bus
            telemetry = null_bus()
        self.telemetry = telemetry
        self.run_task = run_task
        self.fetch = fetch
        self.cfg = cfg
        self.run_batch = run_batch
        self.batch_key = batch_key or (lambda t: len(t.sample_ids))
        self.max_batch = max_batch
        # fault injection (repro_torch.platform.faults): called with the
        # worker id right after each claim; raises WorkerCrash to
        # simulate the thread dying mid-task
        self.crash_hook = crash_hook
        # per-worker respawn budget: a crashed worker thread is
        # restarted under the same id until the budget runs out, after
        # which its work is reclaimed and the pool shrinks
        self.max_respawns = max_respawns
        self.worker_respawns = 0
        # per-shape wave-size cap (the driver pins one padded wave width
        # per shape bucket; claims must not exceed it)
        self.batch_cap = batch_cap
        # response-time-aware ranking + dynamic-k ahead-fetch (the
        # balanced scheduling loop, DESIGN.md §9)
        self.locality_score = locality_score
        self.prefetcher = prefetcher       # core.prefetch.TaskPrefetcher
        # error-bounded early termination (DESIGN.md §10): a
        # core.estimator.StoppingController consulted at every wave
        # settlement; on convergence the scheduler drains
        self.stopper = stopper
        # called with the live scheduler before workers start (drivers
        # wire data-plane state changes to request_rerank here)
        self.on_scheduler: Optional[Callable[[TwoPhaseScheduler],
                                             None]] = None
        self.last_scheduler: Optional[TwoPhaseScheduler] = None

    def run_job(self, tasks: Sequence[Task]) -> List[TaskResult]:
        sched = TwoPhaseScheduler(self.n_workers, tasks, self.cfg,
                                  locality_score=self.locality_score,
                                  bucket_key=self.batch_key,
                                  telemetry=self.telemetry)
        self.last_scheduler = sched
        if self.on_scheduler is not None:
            self.on_scheduler(sched)
        lock = threading.Lock()
        results: List[TaskResult] = []
        errors: List[BaseException] = []
        use_waves = self.run_batch is not None and self.max_batch > 1

        prefetcher = self.prefetcher if self.fetch is not None else None

        def worker_loop(wid: int):
            while True:
                batch = None
                upcoming: List[Task] = []
                with lock:
                    if errors:                 # a peer died: job-level
                        return                 # abort (thesis §3.3)
                    t = sched.on_worker_idle(wid)
                    if t is not None:
                        if use_waves:
                            cap = (min(self.max_batch, self.batch_cap(t))
                                   if self.batch_cap else self.max_batch)
                            batch = sched.claim_batch(wid, t, cap,
                                                      self.batch_key)
                            for x in batch:
                                sched.on_task_start(wid, x)
                        else:
                            sched.on_task_start(wid, t)
                        sched.telemetry.emit(
                            "task_claimed",
                            task_ids=tuple(x.task_id for x in batch)
                            if batch is not None else (t.task_id,),
                            worker=wid)
                        if prefetcher is not None:
                            # snapshot the next wave's tasks under the
                            # lock; their fetches go in flight while THIS
                            # wave executes (thesis §3.5 pipeline)
                            upcoming = list(itertools.islice(
                                itertools.chain(sched.queues[wid],
                                                sched.backlog),
                                prefetcher.lookahead()))
                if t is None:
                    with lock:
                        if sched.done():
                            return
                        # lease sweep while idle: requeue claims whose
                        # lease lapsed (a peer died without reporting)
                        sched.reclaim_expired()
                    time.sleep(1e-4)
                    continue
                claimed = batch if batch is not None else [t]
                try:
                    if self.crash_hook is not None:
                        self.crash_hook(wid)
                    t0 = time.perf_counter()
                    if prefetcher is not None:
                        # admit() drops cache-resident tasks: with
                        # cache-aware ranking they sort FIRST in the
                        # backlog, so the peeked look-ahead would be
                        # exactly the tasks that need no fetch (§14)
                        prefetcher.prefetch(
                            [(x.task_id, lambda _x=x: self.fetch(_x))
                             for x in upcoming if prefetcher.admit(x)])
                        for x in claimed:
                            prefetcher.ensure(
                                x.task_id, lambda _x=x: self.fetch(_x))
                    elif self.fetch is not None:
                        for x in claimed:
                            self.fetch(x)
                    t1 = time.perf_counter()
                    if batch is not None:
                        values = self.run_batch(batch)
                    else:
                        values = [self.run_task(t)]
                    t2 = time.perf_counter()
                except rec.WorkerCrash:
                    # this worker "died" mid-task: reclaim its whole
                    # claimed wave and exit the thread — the supervisor
                    # respawns it under the same id (DESIGN.md §12)
                    with lock:
                        sched.on_worker_crash(wid)
                    return
                except BaseException as e:     # noqa: BLE001
                    if (getattr(e, "permanent", False)
                            and self.stopper is not None):
                        # graceful degradation: this wave's data is
                        # permanently gone, but the job is epsilon-
                        # capable — drop the lost tasks, latch the stop
                        # at the achieved CI, and drain what's in flight
                        with lock:
                            sched.on_tasks_lost(wid, claimed)
                            self.stopper.force_stop(f"degraded: {e}")
                            sched.cancel_pending()
                        continue
                    if getattr(e, "permanent", False):
                        # exact job: fail with a structured partial-
                        # result report instead of a bare traceback
                        with lock:
                            sched.on_tasks_lost(wid, claimed)
                            e = rec.DegradedJobError(
                                f"job degraded: {e}", reason=str(e),
                                n_tasks=len(tasks),
                                completed=len(sched._completed),
                                completed_ids=sched._completed)
                            errors.append(e)
                        return
                    with lock:
                        errors.append(e)
                    return
                fetch_each = (t1 - t0) / len(claimed)
                exec_each = (t2 - t1) / len(claimed)
                if prefetcher is not None:
                    prefetcher.observe_exec(exec_each)
                with lock:
                    for x, value in zip(claimed, values):
                        res = TaskResult(x.task_id, wid, t0, fetch_each,
                                         exec_each, value)
                        results.append(res)
                        sched.on_task_complete(res)
                    # wave-settlement stopping check (DESIGN.md §10):
                    # once the estimate has converged, drop the ready
                    # work; peers' in-flight waves settle and done()
                    # flips when the last one lands
                    if (self.stopper is not None
                            and self.stopper.should_stop()):
                        sched.cancel_pending()

        sched.initial_assignments()
        threads: Dict[int, threading.Thread] = {
            w: threading.Thread(target=worker_loop, args=(w,))
            for w in range(self.n_workers)}
        respawns = {w: 0 for w in range(self.n_workers)}
        for th in threads.values():
            th.start()
        # supervision loop: join with a timeout and respawn dead worker
        # threads while the job is unfinished — a thread that exits
        # before done() is a crash (normal exits only happen at done()
        # or after parking an error), so its claims were (or are now)
        # reclaimed and a fresh thread under the same id picks them up
        while True:
            any_alive = False
            for w, th in list(threads.items()):
                th.join(0.02)
                if th.is_alive():
                    any_alive = True
                    continue
                with lock:
                    finished = bool(errors) or sched.done()
                if finished:
                    continue
                if respawns[w] < self.max_respawns:
                    respawns[w] += 1
                    self.worker_respawns += 1
                    sched.telemetry.emit("worker_respawn", worker=w,
                                         respawn_no=respawns[w])
                    nth = threading.Thread(target=worker_loop, args=(w,))
                    threads[w] = nth
                    nth.start()
                    any_alive = True
                else:
                    # respawn budget exhausted: reclaim (idempotent) and
                    # shrink the pool — survivors absorb the work
                    with lock:
                        sched.on_worker_crash(w, respawn=False)
            if not any_alive:
                break
        if errors:
            raise errors[0]
        if not sched.done() and (self.stopper is None
                                 or not self.stopper.stopped):
            raise JobFailure(
                "job incomplete: every worker exhausted its respawn "
                "budget")
        return results
