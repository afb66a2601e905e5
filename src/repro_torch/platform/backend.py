"""Execution backends behind one protocol (thesis §4 evaluation drivers).

``PlatformBackend`` is the seam between the driver's job plan (tasks +
compute + fetch closures) and an execution substrate:

  * :class:`ThreadedBackend` — real threads, real wall time, the two-phase
    scheduler's :class:`~repro_torch.core.scheduler.ThreadedRunner` (thesis §3.4
    phase 1/2 with work stealing).  Platform overheads (startup, per-task
    launch, DFS tax, task-level monitoring — Fig 5/6) are *spent* as real
    sleeps.
  * :class:`SimulatedBackend` — the discrete-event simulator
    (:func:`~repro_torch.core.scheduler.simulate_job`) under virtual time, for
    scale-out / elasticity / heterogeneity studies on a one-core container.
    Per-task costs are **measured on the real compute** first (all tasks,
    or one representative per block shape), then the same scheduler policy
    runs against those costs at any worker count.  Overheads are *charged*
    in virtual time (monitoring via the scheduler's ``cost_tl`` when the
    platform uses task-level recovery, DFS as an execution-time factor).

Both backends call the identical compute closure with the identical
per-task seed and stream partials into the same deterministic reduce tree,
so job statistics are bit-identical across backends for a fixed seed.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, Tuple

from repro_torch.core import recovery as rec
from repro_torch.core import scheduler as sch

Emit = Callable[[int, Any], None]
Compute = Callable[[sch.Task], Any]
ComputeWave = Callable[[List[sch.Task]], List[Any]]
Fetch = Optional[Callable[[sch.Task], Any]]


@dataclasses.dataclass
class BackendOutcome:
    makespan: float                      # startup + execution (s)
    results: List[sch.TaskResult]
    queue_depths: List[int]              # dynamic-k trace (thesis §3.5)
    speculative_launches: int = 0
    speculation_wins: int = 0            # clone completed first
    restarts: int = 0
    per_worker_busy: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    calibration_seconds: float = 0.0     # sim: real compute spent measuring


class PlatformBackend(Protocol):
    name: str

    def run(self, tasks: Sequence[sch.Task], *, compute: Optional[Compute],
            fetch: Fetch, plat, cfg: sch.SchedulerConfig, emit: Emit,
            shape_key: Optional[Callable[[sch.Task], Any]] = None,
            compute_wave: Optional[ComputeWave] = None,
            max_wave: int = 1,
            wave_cap: Optional[Callable[[sch.Task], int]] = None,
            locality_score: Optional[Callable[[sch.Task], float]] = None,
            prefetcher=None,
            on_scheduler: Optional[Callable[[Any], None]] = None,
            stopper=None,
            crash_hook: Optional[Callable[[int], None]] = None,
            telemetry=None,
            ) -> BackendOutcome:
        """Execute ``tasks``; stream each task's partial through ``emit``.
        ``shape_key(task)`` identifies the task's compiled block shape
        (per-shape cost calibration in the simulator; same-shape wave
        draining in the threaded backend).  ``compute_wave(batch)`` — when
        a backend supports it — executes up to ``max_wave`` same-shape
        tasks in one device dispatch, returning per-task partials;
        ``wave_cap(task)`` further bounds the wave size for that task's
        shape bucket (the driver's fixed padded wave width).
        ``locality_score(task)`` ranks ready tasks by predicted
        best-replica fetch latency (balanced scheduling, DESIGN.md §9);
        ``prefetcher`` is a :class:`~repro_torch.core.prefetch.TaskPrefetcher`
        overlapping upcoming fetches with execution; ``on_scheduler`` is
        called with the live scheduler so the driver can wire data-plane
        state changes to :meth:`request_rerank`; ``stopper`` is a
        :class:`~repro_torch.core.estimator.StoppingController` consulted at
        wave settlement — on convergence the scheduler cancels its
        pending tasks and the job drains (DESIGN.md §10);
        ``crash_hook(worker_id)`` is a fault-injection tick called per
        claim — it may raise :class:`~repro_torch.core.recovery.WorkerCrash`
        to kill that worker mid-task (DESIGN.md §12);
        ``telemetry`` is a
        :class:`~repro_torch.platform.telemetry.TelemetryBus` the backend
        threads scheduler events through (disabled bus = no-op sink)."""
        ...


# ---------------------------------------------------------------------------
# Real threads, real wall time
# ---------------------------------------------------------------------------


class ThreadedBackend:
    name = "threaded"

    def __init__(self, n_workers: int):
        self.n_workers = n_workers

    def run(self, tasks, *, compute, fetch, plat, cfg, emit,
            shape_key=None, compute_wave=None, max_wave=1, wave_cap=None,
            locality_score=None, prefetcher=None, on_scheduler=None,
            stopper=None, crash_hook=None, max_respawns=2,
            telemetry=None):
        assert compute is not None, "threaded backend needs real compute"

        def run_task(task: sch.Task):
            if plat.launch_overhead:
                time.sleep(plat.launch_overhead)
            t0 = time.perf_counter()
            value = compute(task)
            took = time.perf_counter() - t0
            if plat.dfs_tax:
                time.sleep(plat.dfs_tax * took)
            if plat.monitoring:
                time.sleep(0.20 * took)           # Fig 6 monitoring tax
            emit(task.task_id, value)
            return value

        run_wave = None
        if compute_wave is not None and max_wave > 1:
            # one launch + one device dispatch amortized over the wave;
            # runtime taxes (DFS, monitoring) still scale with real compute
            def run_wave(batch: List[sch.Task]) -> List[Any]:
                if plat.launch_overhead:
                    time.sleep(plat.launch_overhead)
                t0 = time.perf_counter()
                values = compute_wave(batch)
                took = time.perf_counter() - t0
                if plat.dfs_tax:
                    time.sleep(plat.dfs_tax * took)
                if plat.monitoring:
                    time.sleep(0.20 * took)
                # one partial per claimed task, in claim order — the
                # sharded wave path pads per-device lanes, and a
                # mis-stripped pad would otherwise emit a wrong partial
                # under a real task id via this zip
                assert len(values) == len(batch), \
                    f"wave returned {len(values)} partials for " \
                    f"{len(batch)} tasks"
                for task, value in zip(batch, values):
                    emit(task.task_id, value)
                return values

        runner = sch.ThreadedRunner(self.n_workers, run_task, fetch=fetch,
                                    cfg=cfg, run_batch=run_wave,
                                    batch_key=shape_key,
                                    max_batch=max_wave,
                                    batch_cap=wave_cap,
                                    locality_score=locality_score,
                                    prefetcher=prefetcher,
                                    stopper=stopper,
                                    crash_hook=crash_hook,
                                    max_respawns=max_respawns,
                                    telemetry=telemetry)
        runner.on_scheduler = on_scheduler
        t0 = time.perf_counter()
        time.sleep(plat.startup_time)
        results = runner.run_job(tasks)
        makespan = time.perf_counter() - t0
        sched = runner.last_scheduler
        return BackendOutcome(
            makespan=makespan, results=results,
            queue_depths=list(sched.depth_trace) if sched else [],
            speculative_launches=sched.speculative_launches if sched else 0,
            speculation_wins=sched.speculation_wins if sched else 0,
            restarts=runner.worker_respawns)


# ---------------------------------------------------------------------------
# Resident multi-job worker pool (service substrate, DESIGN.md §8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PoolJob:
    """One job as the resident pool sees it: job-tagged tasks plus the
    execution/streaming callbacks the service wires up.  ``run_batch``
    is the job's *query-class* closure — every job sharing a fuse key
    shares the same closure (same arena, engine, workload), which is
    what makes cross-job wave fusion a plain batched call."""

    job_id: int
    tasks: Sequence[sch.Task]
    seed: int
    run_batch: Callable[[List[Tuple["PoolJob", sch.Task]]], List[Any]]
    emit: Callable[[int, Any], None]
    on_done: Callable[[], None]
    on_error: Callable[[BaseException], None]
    fetch: Optional[Callable[[sch.Task], Any]] = None
    fuse_key: Optional[Callable[[sch.Task], Any]] = None
    cap: Any = 1                         # int or (task) -> int wave width
    priority: int = 0
    deadline: Optional[float] = None     # absolute time.monotonic() value
    weight: float = 1.0
    on_start: Optional[Callable[[float], None]] = None
    # predicted best-replica fetch seconds (balanced scheduling §9)
    locality_score: Optional[Callable[[sch.Task], float]] = None
    # True when a task's blocks are already resident in the worker-side
    # block cache (DESIGN.md §14): the pool skips prefetching it — its
    # claim-time fetch is served from the cache for free.  Per-job (not
    # on the shared prefetcher) because each job maps sample indices
    # through its own dataset handle.
    resident: Optional[Callable[[sch.Task], bool]] = None
    # error-bounded early termination (DESIGN.md §10): a
    # core.estimator.StoppingController checked at wave settlement; on
    # convergence the job's queued tasks are cancelled (DRAINING) and
    # on_cancelled reports how many were dropped
    stopper: Optional[Any] = None
    on_cancelled: Optional[Callable[[int], None]] = None


class ServicePool:
    """Resident worker threads draining a multi-job ready queue.

    Unlike :class:`ThreadedBackend` — which builds a thread pool, pays
    job startup, runs ONE job and tears everything down — the service
    pool starts once, sleeps ``plat.startup_time`` once, and then serves
    every job the service admits.  Scheduling policy lives in
    :class:`~repro_torch.core.scheduler.MultiJobScheduler` (deficit-round-robin
    fairness, deadline boost, cross-job wave fusion); this class owns the
    threads, the per-dispatch platform taxes (launch overhead, DFS,
    monitoring — identical to the single-job backend so service and
    standalone execution cost the same per dispatch), and job-completion
    fan-out."""

    name = "service-pool"

    def __init__(self, n_workers: int, plat,
                 cfg: Optional[sch.MultiJobConfig] = None,
                 prefetcher=None,
                 crash_hook: Optional[Callable[[int], None]] = None,
                 max_respawns: int = 2,
                 telemetry=None):
        self.n_workers = max(n_workers, 1)
        self.plat = plat
        self.sched = sch.MultiJobScheduler(self.n_workers,
                                           cfg or sch.MultiJobConfig(),
                                           telemetry=telemetry)
        self.telemetry = self.sched.telemetry
        # core.prefetch.TaskPrefetcher: next waves' data-node fetches go
        # in flight while the current wave executes
        self.prefetcher = prefetcher
        # fault-injection tick (DESIGN.md §12): called per claim with the
        # worker id; may raise recovery.WorkerCrash to kill that worker
        self.crash_hook = crash_hook
        self.max_respawns = max_respawns
        self.worker_respawns = 0
        self._jobs: Dict[int, PoolJob] = {}
        self._started_jobs: set = set()
        self._cond = threading.Condition()
        self._threads: Dict[int, threading.Thread] = {}
        self._respawns: Dict[int, int] = {}
        self._monitor: Optional[threading.Thread] = None
        self._stop = False
        self.started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Spin up the resident workers; job startup cost is paid here,
        ONCE, instead of per job (the between-jobs platform tax the
        service exists to remove)."""
        with self._cond:
            # atomic check-and-set: two concurrent first submits must not
            # both spawn worker threads; a closed pool stays down (a
            # submit racing close() must not pay the startup sleep and
            # spawn workers that would only see _stop and exit)
            if self.started or self._stop:
                return
            self.started = True
        if self.plat.startup_time:
            time.sleep(self.plat.startup_time)
        with self._cond:
            if self._stop:     # close() ran during the startup sleep
                return
            self._threads = {
                w: threading.Thread(target=self._worker_loop, args=(w,),
                                    name=f"service-worker-{w}",
                                    daemon=True)
                for w in range(self.n_workers)}
            self._respawns = {w: 0 for w in range(self.n_workers)}
            for th in self._threads.values():
                th.start()
            # supervisor: detects dead worker threads (injected crashes,
            # uncaught bugs), reclaims their claims, respawns bounded
            # replacements (DESIGN.md §12)
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="service-monitor",
                daemon=True)
            self._monitor.start()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for th in list(self._threads.values()):
            th.join(timeout=30.0)
        if self._monitor is not None:
            self._monitor.join(timeout=30.0)
            self._monitor = None
        self._threads = {}
        if self.prefetcher is not None:
            self.prefetcher.close()

    def _monitor_loop(self) -> None:
        """Worker supervision: a thread that died without the pool
        stopping had its claims orphaned — requeue them via the
        scheduler's crash path and respawn a replacement under the same
        worker id (per-task seeds make the re-execution bit-identical).
        Respawns are bounded by ``max_respawns`` per worker slot; an
        exhausted slot stays down and its share of the pool is served by
        the surviving workers."""
        while True:
            with self._cond:
                if self._stop:
                    return
                for w, th in list(self._threads.items()):
                    if th.is_alive():
                        continue
                    self.sched.on_worker_dead(w)
                    if self._respawns.get(w, 0) < self.max_respawns:
                        self._respawns[w] = self._respawns.get(w, 0) + 1
                        self.worker_respawns += 1
                        self.telemetry.emit("worker_respawn", worker=w,
                                            respawn_no=self._respawns[w])
                        nth = threading.Thread(
                            target=self._worker_loop, args=(w,),
                            name=f"service-worker-{w}", daemon=True)
                        self._threads[w] = nth
                        nth.start()
                    else:
                        self._threads.pop(w, None)
                self._cond.notify_all()
            time.sleep(0.02)

    # -- job intake ----------------------------------------------------------
    def submit(self, job: PoolJob) -> None:
        self.start()
        with self._cond:
            if self._stop:
                # close() won the race: no worker will ever drain this
                # job — refuse instead of parking it in a dead scheduler
                stopped = True
            else:
                self._jobs[job.job_id] = job
                self.sched.add_job(
                    job.job_id, job.tasks, fuse_key=job.fuse_key,
                    cap=job.cap, priority=job.priority,
                    deadline=job.deadline, weight=job.weight,
                    locality_score=job.locality_score)
                self._cond.notify_all()
                stopped = False
        if stopped:
            job.on_error(RuntimeError("pool is closed"))

    def cancel(self, job_id: int) -> int:
        """Drop a job's queued tasks; in-flight tasks finish and their
        emits land in a tree the service has already closed."""
        with self._cond:
            dropped = self.sched.cancel_job(job_id)
            if job_id not in self.sched.jobs:
                self._jobs.pop(job_id, None)
                self._started_jobs.discard(job_id)
        if self.prefetcher is not None:
            # evict the job's prefetched-but-never-claimed fetches
            self.prefetcher.discard(lambda k: k[0] == job_id)
        return len(dropped)

    def pending_tasks(self) -> int:
        with self._cond:
            return self.sched.pending_tasks()

    # -- workers -------------------------------------------------------------
    def _worker_loop(self, wid: int) -> None:
        plat = self.plat
        speculative = self.sched.cfg.speculative
        while True:
            claim_err: Optional[BaseException] = None
            failed_ids: List[int] = []
            upcoming: List[Tuple[PoolJob, sch.Task]] = []
            is_spec = False                 # batch came from speculation
            with self._cond:
                try:
                    batch = []
                    while not self._stop:
                        batch = self.sched.claim(time.monotonic(),
                                                 worker=wid)
                        if batch:
                            break
                        if speculative:
                            # idle + nothing ready: clone a straggler
                            # (first completion wins; same per-task seed)
                            batch = self.sched.claim_speculative(
                                time.monotonic(), worker=wid)
                            if batch:
                                is_spec = True
                                break
                        # idle worker = free capacity for lease recovery:
                        # requeue claims whose lease lapsed (§12)
                        self.sched.reclaim_expired(time.monotonic())
                        self._cond.wait(0.02)
                except Exception as e:      # noqa: BLE001
                    # a scheduler-policy bug must fail jobs, not kill the
                    # worker thread (a dead worker hangs every outstanding
                    # ticket until timeout); the policy state is no longer
                    # trustworthy, so fail everything it was managing
                    claim_err, batch = e, []
                    failed_ids = list(self._jobs)
                if self._stop and not batch:
                    return
                pool_batch = [(self._jobs[j.job_id], t) for j, t in batch
                              if j.job_id in self._jobs]
                now = time.monotonic()
                fresh = [pj for pj, _ in pool_batch
                         if pj.job_id not in self._started_jobs]
                self._started_jobs.update(pj.job_id for pj in fresh)
                if self.prefetcher is not None:
                    # snapshot the next waves' tasks under the lock; their
                    # fetches overlap this wave's execution (§3.5)
                    upcoming = [
                        (self._jobs[j.job_id], t)
                        for j, t in self.sched.peek(
                            self.prefetcher.lookahead(), now)
                        if j.job_id in self._jobs]
            if claim_err is not None:
                self._fail_jobs(failed_ids, claim_err)
                continue
            if not batch:
                continue
            if self.crash_hook is not None:
                # fault-injection tick: a planned crash kills this worker
                # holding its claims — exactly the window the monitor's
                # on_worker_dead reclamation covers
                try:
                    self.crash_hook(wid)
                except rec.WorkerCrash:
                    with self._cond:
                        self.sched.on_worker_dead(wid)
                        self._cond.notify_all()
                    return
            if not pool_batch:
                # defensive: should be unreachable while cancel() keeps
                # claimed jobs resident (sched.jobs ⊆ _jobs under _cond),
                # but if that invariant ever breaks, settle the in-flight
                # accounting and move on (no timing sample — nothing
                # executed, and a 0.0 would skew the EMA)
                with self._cond:
                    for job, _task in batch:
                        self.sched.on_task_complete(job.job_id, None,
                                                    _task.task_id,
                                                    speculative=is_spec,
                                                    worker=wid)
                    self._cond.notify_all()
                continue
            for pj in {pj.job_id: pj for pj in fresh}.values():
                if pj.on_start is not None:
                    pj.on_start(now)
            if plat.launch_overhead:
                time.sleep(plat.launch_overhead)
            try:
                if self.prefetcher is not None and upcoming:
                    # per-job resident predicates drop cache-resident
                    # tasks (their claim-time fetch is served worker-
                    # side — a background fetch would waste the slot)
                    entries = []
                    for pj, t in upcoming:
                        if pj.fetch is None:
                            continue
                        if pj.resident is not None and pj.resident(t):
                            self.prefetcher.note_resident_skip()
                            continue
                        entries.append(
                            ((pj.job_id, t.task_id),
                             lambda _pj=pj, _t=t: _pj.fetch(_t)))
                    if entries:
                        self.prefetcher.prefetch(entries)
                t_f = time.perf_counter()
                for pj, task in pool_batch:
                    if pj.fetch is not None:
                        if self.prefetcher is not None:
                            self.prefetcher.ensure(
                                (pj.job_id, task.task_id),
                                lambda _pj=pj, _t=task: _pj.fetch(_t))
                        else:
                            pj.fetch(task)
                t1 = time.perf_counter()
                fetch_each = (t1 - t_f) / max(len(pool_batch), 1)
                values = pool_batch[0][0].run_batch(pool_batch)
                took = time.perf_counter() - t1
            except BaseException as e:      # noqa: BLE001
                if is_spec:
                    # a clone is a redundant bet: losing it (e.g. its
                    # refetch hit a down replica) must not fail the job
                    # — settle the accounting; the original still runs
                    with self._cond:
                        for job, _task in batch:
                            self.sched.on_task_abandoned(job.job_id,
                                                         _task.task_id,
                                                         worker=wid)
                        self._cond.notify_all()
                elif rec.is_permanent(e):
                    # permanent data loss (every replica down): graceful
                    # degradation instead of a hard failure (§12) —
                    # epsilon jobs drain at the achieved CI, exact jobs
                    # fail with a structured partial-result report
                    self._degrade_batch(wid, batch, e)
                else:
                    self._fail_batch(batch, e)
                continue
            if plat.dfs_tax:
                time.sleep(plat.dfs_tax * took)
            if plat.monitoring:
                time.sleep(0.20 * took)
            emit_failed: Dict[int, BaseException] = {}
            for (pj, task), value in zip(pool_batch, values):
                if pj.job_id in emit_failed:
                    continue
                try:
                    pj.emit(task.task_id, value)
                except BaseException as e:  # noqa: BLE001
                    # an emit that throws (e.g. an injected
                    # checkpoint-write crash, §12) must fail ITS job —
                    # letting it unwind would kill this worker thread
                    # and, once respawns are exhausted, hang the job
                    emit_failed[pj.job_id] = e
            for jid, e in emit_failed.items():
                self._fail_jobs([jid], e)
            # average over the tasks that actually ran; a job missing from
            # pool_batch (defensive — see the not-pool_batch branch above)
            # settles without a sample (its tasks never executed, and
            # charging them would dilute the EMA toward zero)
            exec_each = took / max(len(pool_batch), 1)
            if self.prefetcher is not None:
                self.prefetcher.observe_exec(exec_each)
            executed = {pj.job_id for pj, _ in pool_batch}
            finished: List[PoolJob] = []
            drained: set = set()
            with self._cond:
                for job, _task in batch:
                    sample = (exec_each if job.job_id in executed else None)
                    if self.sched.on_task_complete(job.job_id, sample,
                                                   _task.task_id,
                                                   speculative=is_spec,
                                                   worker=wid,
                                                   fetch_seconds=(
                                                       fetch_each
                                                       if job.job_id
                                                       in executed
                                                       else None)):
                        pj = self._jobs.pop(job.job_id, None)
                        self._started_jobs.discard(job.job_id)
                        if pj is not None:
                            finished.append(pj)
                # wave-settlement stopping check (DESIGN.md §10): a job
                # whose estimate converged DRAINs — its queued tasks are
                # dropped through the multi-job cancel plumbing, and the
                # freed capacity goes to peer jobs on the very next
                # claim; its in-flight tasks (possibly fused into peers'
                # waves on other workers) settle normally
                for pj in {p.job_id: p for p, _ in pool_batch}.values():
                    jid = pj.job_id
                    if (pj.stopper is None or jid not in self.sched.jobs
                            or not pj.stopper.should_stop()):
                        continue
                    dropped = self.sched.cancel_job(jid)
                    if dropped:
                        drained.add(jid)
                        self.telemetry.emit("job_draining", job_id=jid,
                                            n_cancelled=len(dropped))
                        if pj.on_cancelled is not None:
                            pj.on_cancelled(len(dropped))
                    if jid not in self.sched.jobs and jid in self._jobs:
                        # nothing left in flight anywhere: the drain
                        # itself completed the job
                        self._jobs.pop(jid, None)
                        self._started_jobs.discard(jid)
                        finished.append(pj)
                self._cond.notify_all()
            if self.prefetcher is not None and drained:
                # evict the drained jobs' prefetched-but-never-claimed
                # fetches (their tasks will never execute)
                self.prefetcher.discard(lambda k: k[0] in drained)
            if self.prefetcher is not None and finished:
                # evict finished jobs' never-claimed prefetches (a peer
                # can ensure() a task inline before our peeked prefetch
                # lands — without this sweep those futures leak for the
                # life of the service)
                gone = {pj.job_id for pj in finished}
                self.prefetcher.discard(lambda k: k[0] in gone)
            for pj in finished:
                pj.on_done()

    def _degrade_batch(self, wid: int, batch,
                       error: BaseException) -> None:
        """Permanent data loss under a batch (DESIGN.md §12): every
        replica of some claimed task's data is gone, so retrying cannot
        help.  Each job with tasks in the failed batch settles those
        tasks as LOST (the job shrinks — the data is unrecoverable),
        then

        * epsilon jobs (those with a stopper) force-stop with
          ``stop_reason="degraded: ..."`` and DRAIN — the ticket reports
          the estimate achieved from the tasks that did execute;
        * exact jobs fail with a structured
          :class:`~repro_torch.core.recovery.DegradedJobError` carrying the
          partial-progress report.

        The batch failed as one device call, so per-task blame is
        unknowable here; fusion peers that shared the wave degrade too,
        losing at most one wave's worth of tasks — the report says
        exactly how many."""
        by_job: Dict[int, List[sch.Task]] = {}
        for j, t in batch:
            by_job.setdefault(j.job_id, []).append(t)
        finished: List[PoolJob] = []
        failed: List[Tuple[PoolJob, BaseException]] = []
        with self._cond:
            for jid, tasks in by_job.items():
                pj = self._jobs.get(jid)
                sjob = self.sched.jobs.get(jid)
                n_before = sjob.n_tasks if sjob is not None else 0
                completed = sjob.completed if sjob is not None else 0
                completed_ids = (set(sjob.completed_ids)
                                 if sjob is not None else set())
                n_lost = 0
                for t in tasks:
                    if t.task_id not in completed_ids:
                        n_lost += 1
                    self.sched.on_task_lost(jid, t.task_id, worker=wid)
                if pj is None:
                    continue
                if pj.stopper is not None:
                    pj.stopper.force_stop(f"degraded: {error}")
                    dropped = self.sched.cancel_job(jid)
                    n_gone = n_lost + len(dropped)
                    if pj.on_cancelled is not None and n_gone:
                        pj.on_cancelled(n_gone)
                    if jid not in self.sched.jobs:
                        # nothing left in flight anywhere: the degraded
                        # drain itself completed the job
                        self._jobs.pop(jid, None)
                        self._started_jobs.discard(jid)
                        finished.append(pj)
                else:
                    self.sched.fail_job(jid)
                    self._jobs.pop(jid, None)
                    self._started_jobs.discard(jid)
                    failed.append((pj, rec.DegradedJobError(
                        f"job {jid} lost {n_lost} task(s) to permanent "
                        f"data failure: {error}",
                        reason=str(error), n_tasks=n_before,
                        completed=completed,
                        completed_ids=completed_ids)))
            self._cond.notify_all()
        if self.prefetcher is not None and (finished or failed):
            gone = ({pj.job_id for pj in finished}
                    | {pj.job_id for pj, _ in failed})
            self.prefetcher.discard(lambda k: k[0] in gone)
        for pj in finished:
            pj.on_done()
        for pj, err in failed:
            pj.on_error(err)

    def _fail_batch(self, batch, error: BaseException) -> None:
        """A batch died: fail every job with a task in it (their values
        are lost); job-level recovery is per job — other jobs proceed."""
        self._fail_jobs(dict.fromkeys(j.job_id for j, _ in batch), error)

    def _fail_jobs(self, job_ids, error: BaseException) -> None:
        """Fail each given job: drop it from the scheduler and the job
        table under the lock, then fan the error out to each job's
        ``on_error`` outside it (callbacks may block).  Already-removed
        ids are skipped, so concurrent failers never double-report."""
        failed: List[PoolJob] = []
        with self._cond:
            for job_id in job_ids:
                self.sched.fail_job(job_id)
                pj = self._jobs.pop(job_id, None)
                self._started_jobs.discard(job_id)
                if pj is not None:
                    failed.append(pj)
            self._cond.notify_all()
        if self.prefetcher is not None and failed:
            gone = {pj.job_id for pj in failed}
            self.prefetcher.discard(lambda k: k[0] in gone)
        for pj in failed:
            pj.on_error(error)


# ---------------------------------------------------------------------------
# Virtual time over measured costs
# ---------------------------------------------------------------------------


class SimulatedBackend:
    """Scale-out in virtual time, calibrated from real execution.

    ``compute_values=True`` (default) executes *every* task's compute for
    real — once, single-threaded — measuring per-task exec/fetch seconds
    and emitting the true partials; the scheduler then replays those costs
    at ``workers`` scale.  ``compute_values=False`` measures one
    representative task per distinct block shape (fast; no statistics).
    ``exec_model`` bypasses measurement entirely (cost-model studies over
    datasets too large to materialize).
    """

    name = "simulated"

    def __init__(self, workers, *, compute_values: bool = True,
                 startup_scale: float = 1.0,
                 exec_model: Optional[Callable[[sch.Task], float]] = None,
                 fetch_model: Optional[Callable[[sch.Task], float]] = None,
                 max_restarts: int = 3):
        if isinstance(workers, int):
            workers = [sch.SimWorker(i) for i in range(workers)]
        self.workers = list(workers)
        self.compute_values = compute_values
        self.startup_scale = startup_scale
        self.exec_model = exec_model
        self.fetch_model = fetch_model
        self.max_restarts = max_restarts

    def _measure(self, tasks, compute, fetch, emit, shape_key):
        """Calibration pass: real compute → per-task costs (+ partials).
        ``shape_key`` buckets tasks by compiled block shape so heavy-tail
        outlier tasks (padded longer) get their own measurement."""
        if shape_key is None:
            shape_key = lambda t: len(t.sample_ids)      # noqa: E731
        exec_s: Dict[int, float] = {}
        fetch_s: Dict[int, float] = {}
        rep_exec: Dict[Any, float] = {}
        rep_fetch: Dict[Any, float] = {}
        t_cal = time.perf_counter()
        for task in tasks:
            key = shape_key(task)
            if not self.compute_values and key in rep_exec:
                exec_s[task.task_id] = rep_exec[key]
                fetch_s[task.task_id] = rep_fetch[key]
                continue
            tf = 0.0
            if fetch is not None:
                t0 = time.perf_counter()
                fetch(task)
                tf = time.perf_counter() - t0
            t0 = time.perf_counter()
            value = compute(task)
            te = time.perf_counter() - t0
            exec_s[task.task_id] = te
            fetch_s[task.task_id] = tf
            rep_exec[key] = te
            rep_fetch[key] = tf
            if self.compute_values:
                emit(task.task_id, value)
        return exec_s, fetch_s, time.perf_counter() - t_cal

    def run(self, tasks, *, compute, fetch, plat, cfg, emit,
            shape_key=None, compute_wave=None, max_wave=1, wave_cap=None,
            locality_score=None, prefetcher=None, on_scheduler=None,
            stopper=None, crash_hook=None, max_respawns=2,
            telemetry=None):
        # calibration measures per-task costs; waves don't apply, and the
        # §3.5 fetch/execute overlap is already modeled in virtual time
        # (queue-warm cost = max(exec, fetch)), so the real prefetcher is
        # unused; locality ranking applies — replica scores reorder the
        # virtual-time backlog exactly as they do the threaded one
        # crash injection is a real-thread concern (virtual-time failure
        # studies use SimWorker.fail_at instead)
        del compute_wave, max_wave, wave_cap, prefetcher, on_scheduler
        del crash_hook, max_respawns
        calibration = 0.0
        if self.exec_model is not None:
            exec_time = self.exec_model
            fetch_time = self.fetch_model or (
                lambda t: 1e-4 * len(t.sample_ids))
        else:
            assert compute is not None, "need compute or an exec_model"
            exec_s, fetch_s, calibration = self._measure(
                tasks, compute, fetch, emit, shape_key)
            exec_time = lambda t: exec_s[t.task_id]          # noqa: E731
            if self.fetch_model is not None:
                fetch_time = self.fetch_model
            elif fetch is not None:
                fetch_time = lambda t: fetch_s[t.task_id]    # noqa: E731
            else:
                fetch_time = lambda t: 1e-4 * len(t.sample_ids)  # noqa: E731

        # DFS interference is an execution-time factor in virtual time;
        # task-level monitoring is charged once, by the scheduler's
        # cost_tl multiplier when plat.recovery == "task" (Fig 6).
        dfs = 1.0 + plat.dfs_tax
        params = sch.SimParams(
            exec_time=lambda t: exec_time(t) * dfs,
            fetch_time=fetch_time,
            launch_overhead=plat.launch_overhead,
            startup_time=plat.startup_time * self.startup_scale)
        out = sch.simulate_job(tasks, self.workers, params, cfg,
                               max_restarts=self.max_restarts,
                               locality_score=locality_score,
                               bucket_key=shape_key, stopper=stopper,
                               telemetry=telemetry)
        return BackendOutcome(
            makespan=out.makespan, results=out.results,
            queue_depths=list(out.queue_depths),
            speculative_launches=out.speculative_launches,
            speculation_wins=out.speculation_wins,
            restarts=out.restarts, per_worker_busy=out.per_worker_busy,
            calibration_seconds=calibration)
