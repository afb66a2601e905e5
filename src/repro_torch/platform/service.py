"""Persistent multi-tenant job service over the tiny-task platform
(DESIGN.md §8), ported to PyTorch.

The thesis motivates subsampling as *interactive* analytics — "processed
in real time, in interactive fashion" — but :meth:`Platform.run` is
one-shot: every query re-measures the kneepoint, re-partitions, re-packs
and re-uploads the block arena, and spins up (then tears down) a worker
pool.  The wave engine amortized the platform tax *within* a job; this
module amortizes it *between* jobs:

* **Dataset registry** — :meth:`PlatformService.register_dataset` places
  a dataset on the data plane once and returns a :class:`DatasetHandle`.
  The kneepoint plan, task partition, and packed device-resident
  :class:`~repro_torch.platform.compute.BlockArena` are computed on the first
  query of each *query class* (workload × engine × sizing) and cached on
  the handle — repeat queries upload ~0 bytes (slot/seed vectors only).
* **Resident pool** — jobs execute on a shared
  :class:`~repro_torch.platform.backend.ServicePool` whose
  :class:`~repro_torch.core.scheduler.MultiJobScheduler` drains a multi-job
  ready queue with deficit-round-robin fairness, deadline-aware boosts,
  and **cross-job wave fusion**: same-shape ready tasks from different
  jobs on the same dataset execute in ONE device dispatch (per-job seeds
  and slot vectors make this bit-exact — the wave partition never
  affects per-task results).
* **Streaming results** — each job owns a deterministic
  :class:`~repro_torch.platform.reduce.StreamingReduceTree`;
  :meth:`JobTicket.partial` surfaces an early estimate while the job
  runs, :meth:`JobTicket.result` the exact, bit-reproducible statistic.
* **SLO-aware admission** — :class:`AdmissionPolicy` bounds in-flight
  load; over-limit submissions queue (default) or are shed, and a job
  whose deadline is provably unmeetable at the pool's measured task
  throughput is rejected up front instead of burning capacity it cannot
  use.

For a fixed seed, ``submit(...).result()`` is bit-identical to a
standalone ``Platform.run(...)`` with the same spec — the service reuses
the exact plan/compute/reduce substrate, only the scheduling around it
changes.  ``backend="simulated"`` specs run each submitted job inline
through the one-shot driver in virtual time (a resident pool has no
meaning there), still reusing the handle's cached kneepoint.

Every query class runs on ``PlatformSpec.device``: the arena lives there
and a fused wave is one launch of ``subsample_stats_seeded`` (``kernel``
engine) or ``subsample_grid_seeded`` (``torch`` engine) over tasks of
several jobs, each drawing from its own job's seed.  The service raises
without a card unless the spec says ``device="cpu"``, where the kernel
wrappers run their plain versions.  With ``mesh_devices`` a query
class's arena is partitioned over a wave mesh and its waves, fused ones
too, dispatch sharded (``compute.run_map_wave_sharded``), bit-identical
to the unsharded service.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import estimator as est_mod
from repro_torch.core import scheduler as sch
from repro_torch.core.blockcache import BlockCache
from repro_torch.platform import compute as pc
from repro_torch.platform import monitor as mon
from repro_torch.platform import telemetry as tel
from repro_torch.platform.backend import PoolJob, ServicePool
from repro_torch.platform.driver import (
    ApproxOptions,
    JobCheckpointer,
    JobPlan,
    Platform,
    PlatformSpec,
    WaveContext,
    balanced_enabled,
    build_prefetcher,
    build_wave_context,
    measure_kneepoint,
    plan_job,
    prefetch_enabled,
    resolve_platform_config,
    resolve_speculation,
    resolve_wave_mesh,
    slo_worker_decision,
    wave_enabled,
)
from repro_torch.platform.reduce import StreamingReduceTree, finalize_stats

# ticket lifecycle
QUEUED = "queued"          # admitted to the service, waiting for capacity
RUNNING = "running"        # in the pool's multi-job ready queue / executing
DONE = "done"
FAILED = "failed"
REJECTED = "rejected"      # shed by admission control
CANCELLED = "cancelled"


# "caller did not pass epsilon/confidence" marker — distinct from an
# explicit epsilon=None, which forces a full (exact) run
_UNSET = object()


class AdmissionError(RuntimeError):
    """Raised by :meth:`JobTicket.result` for shed/rejected jobs."""


class CancelledError(RuntimeError):
    """Raised by :meth:`JobTicket.result` for cancelled jobs."""


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Load-shedding policy for the resident pool (thesis SLO story,
    §4.2.3, applied to admission instead of scaling)."""

    max_active_jobs: int = 32          # running jobs before queueing/shedding
    max_pending_tasks: int = 4096      # ready-queue depth bound
    mode: str = "queue"                # "queue" | "shed" when over a bound
    slo_aware: bool = True             # reject provably unmeetable deadlines


def workload_key(workload) -> Tuple:
    """Hashable identity of a workload for the query-class cache."""
    if dataclasses.is_dataclass(workload):
        return (type(workload).__name__,) + tuple(
            sorted((k, v) for k, v in dataclasses.asdict(workload).items()
                   if not callable(v)))
    return (type(workload).__name__, repr(workload))


_CLASS_UID = itertools.count()


@dataclasses.dataclass
class QueryClass:
    """Everything cached per (dataset, workload, engine, sizing): the
    plan and either the device-resident wave context or the host block
    cache for the per-task fallback.  ``uid`` namespaces fuse keys so
    waves can only fuse tasks that share this exact arena + kernel."""

    uid: int
    plan: JobPlan
    workload: Any
    engine: str
    wave_ctx: Optional[WaveContext] = None
    blocks: Dict[int, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(
        default_factory=dict)
    arena_bytes: float = 0.0           # charged to the job that built it

    def fuse_key(self, task: sch.Task) -> Tuple:
        return (self.uid, self.plan.task_shape(task))

    def cap(self, task: sch.Task) -> int:
        return self.wave_ctx.cap(task) if self.wave_ctx is not None else 1

    def block(self, task: sch.Task) -> Tuple[np.ndarray, np.ndarray]:
        """Host-cached padded block (per-task path): built once per task
        across ALL jobs of the class, not once per job."""
        cached = self.blocks.get(task.task_id)
        if cached is None:
            cached = self.blocks[task.task_id] = self.plan.build_block(task)
        return cached


class DatasetHandle:
    """A registered dataset: distributed to the data plane once, planned
    and arena-packed per query class, shared by every subsequent job."""

    def __init__(self, dataset_id: int, name: str,
                 samples: Dict[int, np.ndarray],
                 months: Dict[int, np.ndarray],
                 knee_bytes: Optional[float] = None):
        self.dataset_id = dataset_id
        self.name = name
        self.samples = samples
        self.months = months
        self.ids = sorted(samples)
        self.total_bytes = float(sum(samples[i].nbytes for i in self.ids))
        self.knee_bytes = knee_bytes       # optional override for all classes
        self._classes: Dict[Tuple, QueryClass] = {}
        self._knee: Dict[Tuple, Tuple[Any, float]] = {}   # per-workload cache
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        return (f"DatasetHandle({self.name!r}, samples={len(self.ids)}, "
                f"bytes={self.total_bytes:.0f})")

    def cached_knee(self, workload, *, engine: str, sizing: str,
                    kneepoint_sizes, device="cuda"
                    ) -> Tuple[Optional[Any], Optional[float]]:
        """The kneepoint plan for a workload — measured once per dataset
        and reused by every query (and by simulated-backend submits)."""
        if self.knee_bytes is not None or sizing != "kneepoint":
            return None, self.knee_bytes
        key = workload_key(workload)
        with self._lock:
            if key not in self._knee:
                self._knee[key] = measure_kneepoint(
                    self.samples, self.months, workload,
                    sizes=kneepoint_sizes, engine=engine, device=device)
            return self._knee[key]

    def query_class(self, workload, *, spec: PlatformSpec, engine: str,
                    sizing: str, n_exec: int,
                    wave_on: bool) -> Tuple[QueryClass, bool]:
        """Plan + pack for one query class; ``(qc, built_now)`` where
        ``built_now`` marks the submit that paid the one-time cost."""
        # mesh_devices joins the key: a sharded and an unsharded arena
        # for the same workload are different device-resident state (and
        # ServicePool claims must route to the arena their jobs warmed)
        key = (workload_key(workload), engine, sizing, n_exec, wave_on,
               spec.max_wave, spec.mesh_devices)
        with self._lock:
            qc = self._classes.get(key)
            if qc is not None:
                return qc, False
        knee_res, knee = self.cached_knee(
            workload, engine=engine, sizing=sizing,
            kneepoint_sizes=spec.kneepoint_sizes, device=spec.device)
        with self._lock:
            qc = self._classes.get(key)
            if qc is not None:                     # raced: peer built it
                return qc, False
            plan = plan_job(self.samples, self.months, workload,
                            sizing=sizing, engine=engine, n_exec=n_exec,
                            knee_bytes=knee,
                            kneepoint_sizes=spec.kneepoint_sizes,
                            device=spec.device)
            plan.knee_res = plan.knee_res or knee_res
            qc = QueryClass(uid=next(_CLASS_UID), plan=plan,
                            workload=workload, engine=engine)
            if wave_on:
                qc.wave_ctx = build_wave_context(
                    plan, workload, n_exec=n_exec, max_wave=spec.max_wave,
                    warm_seed=spec.seed, device=spec.device,
                    mesh=resolve_wave_mesh(spec, wave_on))
                qc.arena_bytes = qc.wave_ctx.arena.nbytes
            elif engine in ("kernel", "torch"):
                # per-task warmup: compile one kernel per distinct shape
                seen = set()
                for task in plan.tasks:
                    shape = plan.task_shape(task)
                    if shape not in seen:
                        seen.add(shape)
                        block, mo = qc.block(task)
                        pc.run_map_task(block, mo, spec.seed + task.task_id,
                                        workload, engine, device=spec.device)
            self._classes[key] = qc
            return qc, True


class PartialEstimate(dict):
    """What :meth:`JobTicket.partial` returns: the online-aggregation
    snapshot — ``value``/``ci_low``/``ci_high``/``half_width`` (the CI
    fields are ``None`` for statistics without an estimator plug-in),
    ``tasks_in``/``n_tasks`` progress, ``confidence``, and ``estimate``,
    the running finalized statistic dict (the old bare-value shape).
    Statistic values live under ``p["estimate"]["mean"]`` — the legacy
    top-level spelling (``p["mean"]``) was removed after a deprecation
    cycle and now raises ``KeyError``."""

    @classmethod
    def build(cls, stat: Dict[str, Any], snap, *, n_tasks: int,
              confidence: float) -> "PartialEstimate":
        out = cls(estimate=stat, n_tasks=n_tasks, confidence=confidence,
                  value=None, ci_low=None, ci_high=None,
                  half_width=None, tasks_in=0)
        if snap is not None:
            out.update(value=snap.value, ci_low=snap.ci_low,
                       ci_high=snap.ci_high, half_width=snap.half_width,
                       tasks_in=snap.tasks_in,
                       confidence=snap.confidence)
        return out

class JobTicket:
    """Handle on one submitted job: poll (:meth:`status`/:meth:`progress`),
    stream (:meth:`partial`), or block (:meth:`result`)."""

    def __init__(self, job_id: int, handle: DatasetHandle, workload,
                 n_tasks: int, statistic: str, seed: int):
        self.job_id = job_id
        self.dataset = handle.name
        self.workload_name = getattr(workload, "name", str(workload))
        self.n_tasks = n_tasks
        self.statistic = statistic
        self.seed = seed
        self.status = QUEUED
        self.reason: Optional[str] = None       # rejection/failure detail
        self.error: Optional[BaseException] = None
        self.submitted_at = time.monotonic()
        self.admitted_at: Optional[float] = None
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.bytes_uploaded = 0.0
        self.device_dispatches = 0               # waves this job rode in
        self.tree: Optional[StreamingReduceTree] = None
        self.cancel_requested = False      # set before pool.cancel fires
        # error-bounded approximate execution (DESIGN.md §10)
        self.epsilon: Optional[float] = None
        self.confidence: float = 0.95
        self.min_tasks: int = 8
        self.estimator: Optional[est_mod.SubsampleEstimator] = None
        self.stopper: Optional[est_mod.StoppingController] = None
        self.tasks_executed: int = 0       # set at completion
        self.tasks_cancelled: int = 0      # dropped by the DRAINING flip
        self.tasks_restored: int = 0       # leaves restored from checkpoint
        self.checkpointer: Optional[JobCheckpointer] = None
        self.stop_reason: Optional[str] = None
        self.final_ci: Optional[Dict[str, Any]] = None
        self._result: Optional[dict] = None
        self._done = threading.Event()

    # -- poll ---------------------------------------------------------------
    def progress(self) -> Tuple[int, int]:
        tree = self.tree       # alias: _finish(DONE) nulls it concurrently
        done = tree.leaves_seen if tree is not None else 0
        return (self.n_tasks if self.status == DONE else done, self.n_tasks)

    @property
    def latency(self) -> Optional[float]:
        """Submit→finish seconds (None while in flight)."""
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def queue_wait(self) -> Optional[float]:
        if self.started_at is None:
            return None
        return self.started_at - self.submitted_at

    # -- stream -------------------------------------------------------------
    def partial(self) -> Optional[PartialEstimate]:
        """The online-aggregation snapshot so far: a
        :class:`PartialEstimate` carrying the estimate *value with its
        confidence interval* (``value``/``ci_low``/``ci_high``/
        ``half_width``/``tasks_in``) plus ``estimate`` — the running
        finalized statistic dict; ``None`` before the first leaf.  The
        final :meth:`result` remains bit-deterministic — the running
        ``estimate`` view is only as stable as arrival order, while the
        CI fields depend only on the *set* of tasks in."""
        # the DONE guard matters: a job failed by close() mid-run may
        # still have had _result assigned by the racing completion path —
        # a non-DONE ticket must keep reporting a snapshot, not a final
        if self.status == DONE and self._result is not None:
            snap = None
            if self.final_ci is not None:
                snap = est_mod.EstimateSnapshot(**self.final_ci)
            return PartialEstimate.build(self._result, snap,
                                         n_tasks=self.n_tasks,
                                         confidence=self.confidence)
        tree = self.tree       # alias: _finish(DONE) nulls it concurrently
        if tree is None:
            return None
        root = tree.snapshot()
        if root is None:
            return None
        return PartialEstimate.build(
            finalize_stats(root, self.statistic), tree.estimate(),
            n_tasks=self.n_tasks, confidence=self.confidence)

    def _close_tree(self) -> None:
        """Abort the reduce tree if still attached.  The aliased read is
        load-bearing: ``_finish(DONE)`` nulls ``self.tree`` concurrently,
        so a naive check-then-call races an AttributeError."""
        tree = self.tree
        if tree is not None:
            tree.close()

    # -- block --------------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} not finished after {timeout}s "
                f"(status={self.status}, progress={self.progress()})")
        if self.status == DONE:
            return self._result
        if self.status == REJECTED:
            raise AdmissionError(
                f"job {self.job_id} rejected: {self.reason}")
        if self.status == CANCELLED:
            raise CancelledError(f"job {self.job_id} was cancelled")
        raise self.error if self.error is not None else RuntimeError(
            f"job {self.job_id} failed: {self.reason}")

    def stats(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id, "dataset": self.dataset,
            "workload": self.workload_name, "status": self.status,
            "n_tasks": self.n_tasks, "latency_s": self.latency,
            "queue_wait_s": self.queue_wait,
            "bytes_uploaded": self.bytes_uploaded,
            "device_dispatches": self.device_dispatches,
            "epsilon": self.epsilon,
            "tasks_executed": self.tasks_executed,
            "tasks_cancelled": self.tasks_cancelled,
            "tasks_restored": self.tasks_restored,
            "stop_reason": self.stop_reason,
        }


class PlatformService:
    """The persistent, multi-tenant front door: register datasets once,
    submit many concurrent subsample queries against them.

    One :class:`~repro_torch.platform.driver.PlatformSpec` fixes the overhead
    profile, worker count, engine, and wave policy for every job the
    service runs (jobs choose workload/seed/priority/deadline per
    submit).  Use as a context manager or call :meth:`close`."""

    def __init__(self, spec: PlatformSpec = PlatformSpec(), *,
                 admission: AdmissionPolicy = AdmissionPolicy(),
                 datastore=None, fault_injector=None):
        if spec.backend not in ("threaded", "simulated"):
            raise ValueError(
                f"service backend must be threaded|simulated, "
                f"got {spec.backend!r}")
        if admission.mode not in ("queue", "shed"):
            raise ValueError(f"unknown admission mode {admission.mode!r}")
        self.device = pc.check_device(spec.device)
        self.spec = spec
        self.admission = admission
        self.datastore = datastore
        # deterministic fault injection (DESIGN.md §12): node events hit
        # the data plane, worker_tick rides into the pool as crash_hook
        self.fault_injector = fault_injector
        if fault_injector is not None and datastore is not None:
            fault_injector.attach_store(datastore)
        self.plat = resolve_platform_config(spec)
        # validated up front: balanced="on" without a datastore (and any
        # bad mode string) must error, never silently run FIFO
        self.balanced = balanced_enabled(spec, datastore is not None)
        # service-wide counters; a persistent service dispatches forever,
        # so only a bounded window of wave sizes is kept (one-shot
        # JobReports keep the full list)
        self.dispatch = pc.DispatchStats.bounded(4096)
        self.jobs_completed = 0
        self.jobs_rejected = 0
        self.scale_decision: Optional[str] = None   # slo.choose_workers hint
        # unified telemetry (DESIGN.md §13): one bus per service session;
        # the dispatch counters above are derived from its events through
        # the bus's single aggregation path
        self.telemetry = tel.TelemetryBus(
            tel.resolve_telemetry_config(spec.telemetry))
        self.telemetry.bind_dispatch(self.dispatch)
        self.sampler = tel.TelemetrySampler(self.telemetry)
        # SLO monitor (DESIGN.md §15): tap-driven, built only when
        # enabled — the default leaves the bus untapped
        self.monitor: Optional[mon.PlatformMonitor] = None
        if spec.monitor.enabled:
            self.monitor = mon.PlatformMonitor(
                self.telemetry, spec.monitor, wave_capacity=spec.max_wave)
        if datastore is not None:
            datastore.telemetry = self.telemetry
            # worker-side block cache (DESIGN.md §14): one pool-wide
            # cache for the whole service session — concurrent jobs over
            # shared datasets are exactly the repeat/overlap traffic the
            # cache exists for
            if spec.cache.enabled and datastore.cache is None:
                datastore.cache = BlockCache(spec.cache)
        if fault_injector is not None:
            fault_injector.telemetry = self.telemetry
        self._pool: Optional[ServicePool] = None
        self._lock = threading.Lock()
        # serializes admission decisions with slot reservation, so two
        # concurrent submits cannot both pass the same capacity check
        self._admission_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._tickets: Dict[int, JobTicket] = {}
        self._active: Dict[int, JobTicket] = {}
        self._waiting: deque = deque()         # (ticket, submit closure args)
        self._job_seq = itertools.count()
        self._ds_seq = itertools.count()
        self._closed = False
        self._register_sampler_providers()
        self.sampler.start()       # no-op unless telemetry is enabled

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "PlatformService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the pool.  Queued tickets are rejected and any still-
        running jobs are failed with a "service closed" error — their
        ``result()`` callers unblock immediately instead of hanging on a
        pool that no longer exists."""
        # serialized with submit()'s admission section: once the flag
        # flips, no racing submit can reserve a slot — so the orphan
        # snapshot below cannot miss a ticket that would then wait on a
        # pool that no longer drains it
        with self._admission_lock:
            with self._lock:
                self._closed = True
                waiting = list(self._waiting)
                self._waiting.clear()
                pool = self._pool
        self.sampler.stop()
        for ticket, _args in waiting:
            self._finish(ticket, REJECTED, reason="service closed")
        if self.monitor is not None:
            # detach AFTER the sampler's final flush and the queued-
            # ticket rejections so the monitor sees the session out
            self.monitor.close()
        if self.datastore is not None:
            self.datastore.on_state_change = None
            self.datastore.telemetry = None
            if self.datastore.cache is not None:
                # the rerank hook closes over this service's pool; the
                # cache itself (an injected store's warm blocks) stays
                self.datastore.cache.on_change = None
        if pool is not None:
            pool.close()
        with self._lock:
            orphans = list(self._active.values())
        for ticket in orphans:
            self._on_job_error(ticket,
                               RuntimeError("service closed mid-job"))

    # -- registry ------------------------------------------------------------
    def register_dataset(self, samples: Dict[int, np.ndarray],
                         months: Optional[Dict[int, np.ndarray]] = None,
                         *, name: Optional[str] = None,
                         knee_bytes: Optional[float] = None) -> DatasetHandle:
        """Place a dataset on the data plane ONCE; every subsequent query
        against the returned handle reuses the placement, the kneepoint
        plan, and (per query class) the device-resident arena."""
        if months is None:
            months = {i: np.zeros(a.shape[0], np.int32)
                      for i, a in samples.items()}
        handle = DatasetHandle(next(self._ds_seq),
                               name or f"dataset-{len(samples)}",
                               samples, months,
                               knee_bytes=(knee_bytes
                                           if knee_bytes is not None
                                           else self.spec.knee_bytes))
        if self.datastore is not None:
            self.datastore.put_all({i: samples[i] for i in handle.ids})
            if self.balanced:
                # phase-1 probe of the data plane: seed response EMAs
                self.datastore.probe()
        return handle

    # -- submission ----------------------------------------------------------
    def submit(self, handle: DatasetHandle, workload, *,
               seed: Optional[int] = None, priority: int = 0,
               deadline: Optional[float] = None,
               weight: float = 1.0,
               approx: Optional[ApproxOptions] = None,
               epsilon: Any = _UNSET,
               confidence: Optional[float] = None,
               min_tasks: Optional[int] = None,
               checkpoint_dir: Optional[str] = None,
               resume_from: Optional[str] = None) -> JobTicket:
        """Enqueue one subsample query; returns immediately with a
        :class:`JobTicket`.  ``deadline`` is seconds from now (drives the
        scheduler's deadline boost and SLO-aware admission);
        ``priority`` tiers are strict (higher first), fairness is
        deficit-round-robin within a tier, ``weight`` scales a job's DRR
        share.

        ``approx=ApproxOptions(epsilon=..., confidence=...,
        min_tasks=...)`` makes the query *error-bounded* (DESIGN.md
        §10): the job streams a running estimate with a confidence
        interval and is DRAINed early — queued tasks cancelled, the
        freed workers immediately serving peer jobs — once the CI
        half-width falls under ``epsilon``.  Omitting ``approx``
        inherits the service spec's ``approx`` group, so a spec with an
        epsilon gives every interactive tenant early-stop by default;
        pass ``approx=ApproxOptions()`` (epsilon ``None``) to force a
        full run.  The flat ``epsilon``/``confidence``/``min_tasks``
        kwargs are the deprecated legacy spelling.

        ``checkpoint_dir`` persists the job's completed reduce partials
        (DESIGN.md §12); ``resume_from`` restores a prior interrupted
        run's partials from such a directory — a restarted service
        executes only the missing tasks and the result is bit-identical
        to an uninterrupted run."""
        if self._closed:
            raise RuntimeError("service is closed")
        seed = self.spec.seed if seed is None else seed
        legacy = [name for name, passed in
                  (("epsilon", epsilon is not _UNSET),
                   ("confidence", confidence is not None),
                   ("min_tasks", min_tasks is not None)) if passed]
        if approx is not None:
            if legacy:
                warnings.warn(
                    f"submit() kwarg(s) {legacy} are superseded by the "
                    "approx= option group", DeprecationWarning,
                    stacklevel=2)
            eff_epsilon = approx.epsilon
            eff_conf = approx.confidence
            eff_min = approx.min_tasks
        else:
            if legacy:
                warnings.warn(
                    f"submit() kwarg(s) {legacy} are deprecated; pass "
                    "approx=ApproxOptions(...) instead",
                    DeprecationWarning, stacklevel=2)
            eff_epsilon = (self.spec.epsilon if epsilon is _UNSET
                           else epsilon)
            eff_conf = (self.spec.confidence if confidence is None
                        else confidence)
            eff_min = self.spec.min_tasks if min_tasks is None else min_tasks
        # fail fast: a ValueError later (inside _admit, after the
        # admission slot was reserved) would leak the slot and hang the
        # ticket — and kill a pool worker on the queued-drain path
        est_mod.validate_error_target(eff_epsilon, eff_conf)
        engine = pc.resolve_engine(workload.statistic, self.spec.engine)

        if self.spec.backend == "simulated":
            return self._submit_simulated(handle, workload, seed,
                                          epsilon=eff_epsilon,
                                          confidence=eff_conf,
                                          min_tasks=eff_min,
                                          checkpoint_dir=checkpoint_dir,
                                          resume_from=resume_from)

        wave_on = wave_enabled(self.spec, engine, workload)
        # validated on EVERY submit (not just the arena-building one):
        # mesh_devices without wave execution must error, never silently
        # run an unsharded per-task job
        resolve_wave_mesh(self.spec, wave_on)
        qc, built_now = handle.query_class(
            workload, spec=self.spec, engine=engine,
            sizing=self.plat.task_sizing, n_exec=self.spec.n_workers,
            wave_on=wave_on)
        # resume (DESIGN.md §12): restore committed leaf partials up
        # front — a stale checkpoint must fail the submit, not a pool
        # worker — and hand only the missing tasks to the pool
        restored: Dict[int, Dict[str, Any]] = {}
        if resume_from is not None:
            restored, ckpt_n = JobCheckpointer.load(resume_from)
            if ckpt_n is not None and ckpt_n != len(qc.plan.tasks):
                raise ValueError(
                    f"checkpoint at {resume_from!r} holds partials for "
                    f"{ckpt_n} tasks but this query class has "
                    f"{len(qc.plan.tasks)} — resume needs the same "
                    "dataset, workload, sizing and knee")
        ticket = JobTicket(next(self._job_seq), handle, workload,
                           len(qc.plan.tasks), workload.statistic, seed)
        ticket.epsilon, ticket.confidence = eff_epsilon, eff_conf
        ticket.min_tasks = eff_min
        if built_now:
            self.telemetry.emit("arena_upload", nbytes=qc.arena_bytes,
                                job_id=ticket.job_id)
            ticket.bytes_uploaded += qc.arena_bytes
        self._tickets[ticket.job_id] = ticket

        abs_deadline = (None if deadline is None
                        else time.monotonic() + deadline)
        with self._admission_lock:
            if self._closed:       # close() raced the entry check above
                self._tickets.pop(ticket.job_id, None)
                raise RuntimeError("service is closed")
            verdict = self._admission_verdict(ticket, deadline)
            # an slo verdict is final (waiting longer cannot meet the
            # deadline); capacity verdicts queue unless the mode sheds
            reject_now = (verdict is not None
                          and (self.admission.mode == "shed"
                               or verdict[0] == "slo"))
            if verdict is None:
                with self._lock:               # reserve the slot atomically
                    self._active[ticket.job_id] = ticket
            elif not reject_now:
                with self._lock:
                    self._waiting.append(
                        (ticket,
                         (handle, qc, priority, abs_deadline, weight,
                          checkpoint_dir, restored)))
        if verdict is None:
            self._admit(ticket, handle, qc, priority, abs_deadline, weight,
                        checkpoint_dir=checkpoint_dir,
                        restored=restored)
        elif reject_now:
            self._finish(ticket, REJECTED, reason=verdict[1])
        else:
            self.telemetry.emit("job_queued", job_id=ticket.job_id,
                                reason=verdict[1])
        return ticket

    def _admission_verdict(self, ticket: JobTicket,
                           deadline: Optional[float], *,
                           waiting_adjust: int = 0
                           ) -> Optional[Tuple[str, str]]:
        """None ⇒ admit now; else ``(kind, reason)`` where kind is
        ``"capacity"`` (queueable — load will drain) or ``"slo"``
        (final — the deadline is unmeetable regardless of queueing).
        ``waiting_adjust`` lets the drain path exclude the candidate
        itself from the waiting count."""
        pool = self._pool
        adm = self.admission
        with self._lock:
            active = len(self._active) + len(self._waiting) + waiting_adjust
        pending = pool.pending_tasks() if pool is not None else 0
        if active >= adm.max_active_jobs:
            return ("capacity", f"active jobs {active} ≥ max_active_jobs "
                    f"{adm.max_active_jobs}")
        if pending + ticket.n_tasks > adm.max_pending_tasks:
            return ("capacity", f"ready queue {pending}+{ticket.n_tasks} > "
                    f"max_pending_tasks {adm.max_pending_tasks}")
        if (adm.slo_aware and deadline is not None and pool is not None
                and pool.sched.avg_task_seconds is not None):
            est = ((pending + ticket.n_tasks)
                   * pool.sched.avg_task_seconds
                   / max(pool.n_workers, 1))
            if est > deadline:
                return ("slo", f"slo unmeetable: est completion {est:.3f}s "
                        f"> deadline {deadline:.3f}s at current load")
        return None

    def _admit(self, ticket: JobTicket, handle: DatasetHandle,
               qc: QueryClass, priority: int,
               abs_deadline: Optional[float], weight: float,
               checkpoint_dir: Optional[str] = None,
               restored: Optional[Dict[int, Dict[str, Any]]] = None
               ) -> None:
        """Hand an already-reserved ticket (present in ``_active``) to
        the pool."""
        with self._lock:
            # one atomic decision: never build/feed a pool once closed,
            # and never resurrect a ticket cancel()/close() already
            # finished; concurrent first admits share ONE pool
            if self._closed or ticket.status != QUEUED:
                self._active.pop(ticket.job_id, None)
                admit = False
            else:
                if self._pool is None:
                    self._pool = self._build_pool(qc)
                pool = self._pool
                ticket.status = RUNNING
                admit = True
        if not admit:
            if ticket.status == QUEUED:    # closed before any terminal
                self._finish(ticket, REJECTED, reason="service closed")
            return
        ticket.admitted_at = time.monotonic()
        self.telemetry.emit("job_admitted", job_id=ticket.job_id,
                            n_tasks=ticket.n_tasks)
        # every job carries an estimator (partial() streams value + CI
        # for free); only an epsilon target adds the stopping rule
        ticket.estimator = est_mod.SubsampleEstimator(ticket.statistic,
                                                      ticket.confidence)
        ticket.tree = StreamingReduceTree(len(qc.plan.tasks),
                                          estimator=ticket.estimator)
        if ticket.epsilon is not None:
            ticket.stopper = est_mod.StoppingController(
                ticket.estimator, ticket.epsilon,
                min_tasks=ticket.min_tasks)

        # restored leaves enter the tree (and estimator) first, exactly
        # as if those tasks had just completed; only the missing tasks
        # go to the pool — the tree's fixed shape keeps the combined
        # result bit-identical to an uninterrupted run (§12)
        restored = restored or {}
        for tid in sorted(restored):
            ticket.tree.offer(tid, restored[tid])
        ticket.tasks_restored = len(restored)
        if restored:
            self.telemetry.emit("checkpoint_restored", n=len(restored),
                                job_id=ticket.job_id)
        emit = ticket.tree.offer
        if checkpoint_dir is not None:
            ticket.checkpointer = JobCheckpointer(
                checkpoint_dir, len(qc.plan.tasks),
                every=self.spec.checkpoint_every, restored=restored,
                injector=self.fault_injector,
                telemetry=self.telemetry)
            tree_offer = emit

            def emit(tid, v, _prev=tree_offer, _c=ticket.checkpointer):
                _prev(tid, v)
                _c.offer(tid, v)

        if self.fault_injector is not None:
            # last wrap: the injector's completion clock must tick only
            # for leaves the pool actually executes this run (restored
            # offers above bypass it, same as the driver path)
            emit = self.fault_injector.wrap_emit(emit)

        run_tasks = ([t for t in qc.plan.tasks
                      if t.task_id not in restored]
                     if restored else qc.plan.tasks)
        if not run_tasks:
            # everything was restored from the checkpoint — there is no
            # task to schedule, so the pool would never observe a
            # completion and the job would hang; finish directly off the
            # fully-populated tree
            ticket.started_at = time.monotonic()
            self._on_job_done(ticket)
            return

        def on_cancelled(n: int) -> None:
            # the pool's DRAINING flip dropped n queued tasks (counted
            # under the pool lock, before the completion that finishes
            # the job can settle — _on_job_done reads a stable value)
            ticket.tasks_cancelled += n

        fetch = None
        locality_score = None
        resident = None
        if self.datastore is not None:
            store, ids = self.datastore, qc.plan.ids

            def fetch(task: sch.Task):
                store.fetch_many([ids[sid] for sid in task.sample_ids])

            if self.balanced:
                def locality_score(task: sch.Task) -> float:
                    return store.predicted_task_fetch(
                        [ids[sid] for sid in task.sample_ids])

            if store.cache is not None:
                # per-job residency predicate (each job maps sample
                # indices through its own dataset handle): lets the pool
                # skip prefetching tasks whose blocks are already in the
                # worker-side cache (DESIGN.md §14)
                def resident(task: sch.Task) -> bool:
                    return store.cache_covers(
                        [ids[sid] for sid in task.sample_ids])

        job = PoolJob(
            job_id=ticket.job_id, tasks=run_tasks, seed=ticket.seed,
            run_batch=self._class_run_batch(qc),
            emit=emit,
            on_done=lambda: self._on_job_done(ticket),
            on_error=lambda e: self._on_job_error(ticket, e),
            fetch=fetch, fuse_key=qc.fuse_key, cap=qc.cap,
            priority=priority, deadline=abs_deadline, weight=weight,
            on_start=lambda at: setattr(ticket, "started_at", at),
            locality_score=locality_score, resident=resident,
            stopper=ticket.stopper, on_cancelled=on_cancelled)
        pool.submit(job)
        if ticket.cancel_requested:
            # cancel() raced the hand-off: it saw RUNNING but the job was
            # not yet in the pool, so its pool.cancel was a no-op — drop
            # the tasks now and close the tree it may have missed (the
            # flag, not the status, is checked: cancel() raises it before
            # its pool.cancel, so one of the two cancels sees the job)
            pool.cancel(ticket.job_id)
            ticket._close_tree()

    def _build_pool(self, qc: QueryClass) -> ServicePool:
        """The resident pool, built on first admit: sized by
        slo.choose_workers when the spec carries an SLO (the first query
        class's knee curve calibrates the throughput model), with the
        balanced-scheduling pieces wired in — straggler speculation in
        the multi-job scheduler and the dynamic-k prefetcher over the
        data plane."""
        n_workers = self.spec.n_workers
        decision = slo_worker_decision(self.spec, self.plat, qc.plan)
        if decision is not None:
            n_workers = decision.cores
            self.scale_decision = (f"{decision.cores} cores: "
                                   f"{decision.reason}")
        prefetcher = (build_prefetcher(n_workers)
                      if prefetch_enabled(
                          self.spec, self.datastore is not None) else None)
        injector = self.fault_injector
        pool = ServicePool(
            n_workers, self.plat,
            cfg=sch.MultiJobConfig(
                speculative=resolve_speculation(self.spec),
                straggler_factor=self.spec.straggler_factor,
                lease_seconds=self.spec.lease_seconds),
            prefetcher=prefetcher,
            crash_hook=(injector.worker_tick
                        if injector is not None else None),
            max_respawns=self.spec.max_respawns,
            telemetry=self.telemetry)
        if self.datastore is not None and self.balanced:
            # a node turning degraded/down re-ranks every job's queue
            self.datastore.on_state_change = \
                lambda node: pool.sched.request_rerank()
            if self.datastore.cache is not None:
                # cache admissions/evictions shift locality scores the
                # same way (DESIGN.md §14)
                self.datastore.cache.on_change = \
                    lambda: pool.sched.request_rerank()
        return pool

    # -- execution closures (shared per query class) -------------------------
    def _class_run_batch(self, qc: QueryClass):
        if qc.wave_ctx is not None:
            def run_batch(items: List[Tuple[PoolJob, sch.Task]]):
                tasks = [t for _, t in items]
                seeds = np.asarray([pj.seed + t.task_id
                                    for pj, t in items], np.int32)
                t_wave = self.telemetry.now()
                values = qc.wave_ctx.run(tasks, seeds)
                nbytes = qc.wave_ctx.wave_bytes(len(items))
                self.telemetry.emit(
                    "wave_dispatched", ts=t_wave, wave_size=len(items),
                    nbytes=nbytes,
                    seconds=self.telemetry.now() - t_wave,
                    job_ids=tuple(pj.job_id for pj, _ in items),
                    task_ids=tuple(t.task_id for _, t in items))
                for jid in dict.fromkeys(pj.job_id for pj, _ in items):
                    t = self._tickets.get(jid)
                    if t is not None:
                        t.device_dispatches += 1
                        t.bytes_uploaded += nbytes
                return values
            return run_batch

        def run_batch(items: List[Tuple[PoolJob, sch.Task]]):
            out = []
            for pj, task in items:
                block, mo = qc.block(task)
                if qc.engine in ("kernel", "torch"):
                    nbytes = float(block.nbytes) + (
                        float(mo.nbytes) if qc.engine == "torch" else 0.0)
                    self.telemetry.emit("task_dispatched",
                                        job_id=pj.job_id,
                                        task_id=task.task_id,
                                        nbytes=nbytes)
                    t = self._tickets.get(pj.job_id)
                    if t is not None:
                        t.device_dispatches += 1
                        t.bytes_uploaded += nbytes
                out.append(pc.run_map_task(block, mo, pj.seed + task.task_id,
                                           qc.workload, qc.engine,
                                           device=self.device))
            return out
        return run_batch

    # -- completion fan-in ---------------------------------------------------
    def _on_job_done(self, ticket: JobTicket) -> None:
        if ticket.status != RUNNING:       # cancelled while in flight
            return
        try:
            if ticket.checkpointer is not None:
                # surface any parked async-save error: a job that "ran"
                # but failed to persist its restore point must not
                # report success (§12 durability contract)
                ticket.checkpointer.finish()
            tree = ticket.tree
            if ticket.tasks_cancelled:
                # DRAINed early: finalize over the executed subset in
                # fixed-tree order (deterministic for the set) — the
                # full-leaf result() would wait for leaves that were
                # cancelled and will never arrive
                executed = ticket.n_tasks - ticket.tasks_cancelled
                tree.wait_leaves(executed, timeout=600.0)
                root = tree.snapshot()
                tree.close()
            else:
                root = tree.result(timeout=600.0)
            ticket._result = finalize_stats(root, ticket.statistic)
        except BaseException as e:         # noqa: BLE001
            self._on_job_error(ticket, e)
            return
        ticket.tasks_executed = ticket.n_tasks - ticket.tasks_cancelled
        stopper, estimator = ticket.stopper, ticket.estimator
        if stopper is not None:
            ticket.stop_reason = stopper.stop_reason
            snap = stopper.snapshot()
        else:
            snap = estimator.estimate() if estimator is not None else None
        ticket.final_ci = snap.as_dict() if snap is not None else None
        self._finish(ticket, DONE)

    def _on_job_error(self, ticket: JobTicket, error: BaseException) -> None:
        if ticket.status not in (RUNNING, QUEUED):
            return
        ticket.error = error
        ticket._close_tree()
        if ticket.checkpointer is not None:
            # let the save in flight land before result() unblocks, so a
            # resume reads a directory no thread still writes (as
            # Platform.run does); the job's own error is the one kept
            try:
                ticket.checkpointer.finish()
            except Exception as save_err:  # noqa: BLE001
                warnings.warn(f"checkpoint save failed while the job "
                              f"failed: {save_err!r}", RuntimeWarning)
        self._finish(ticket, FAILED, reason=repr(error))

    def _finish(self, ticket: JobTicket, status: str,
                reason: Optional[str] = None) -> bool:
        # every path to a terminal status funnels through here; the
        # first terminal state wins (callers' check-then-act guards can
        # race — e.g. cancel() vs close()'s waiting-queue rejection —
        # so the arbitration lives here, under _lock).  Returns whether
        # THIS transition won, so e.g. cancel() can report truthfully.
        with self._lock:
            if ticket.status in (DONE, FAILED, REJECTED, CANCELLED):
                return False
            ticket.status = status
            ticket.reason = (reason if reason is not None
                             else ticket.reason)
            ticket.finished_at = time.monotonic()
            self._active.pop(ticket.job_id, None)
            # drop the service's reference: a long-lived service must not
            # retain every ticket (and its reduce tree) ever submitted —
            # the caller's JobTicket stays fully usable
            self._tickets.pop(ticket.job_id, None)
        # service-wide outcome counters (under _stats_lock — pool workers
        # and submitters finish tickets concurrently)
        if status in (DONE, REJECTED):
            with self._stats_lock:
                if status == DONE:
                    self.jobs_completed += 1
                else:
                    self.jobs_rejected += 1
        if status == DONE:
            # free the node arrays and the estimator's per-task theta
            # dict — partial()/final_ci never read them after DONE, and
            # a caller-held ticket would otherwise pin ~n_tasks×D floats
            # for its lifetime
            ticket.tree = None
            ticket.estimator = None
            ticket.stopper = None
        self.telemetry.emit(
            {DONE: "job_done", FAILED: "job_failed",
             REJECTED: "job_rejected", CANCELLED: "job_cancelled"}[status],
            job_id=ticket.job_id,
            tasks_executed=ticket.tasks_executed,
            **({} if ticket.latency is None
               else {"makespan": ticket.latency}),
            **({} if ticket.reason is None else {"reason": ticket.reason}))
        ticket._done.set()
        self._drain_waiting()
        return True

    def _drain_waiting(self) -> None:
        while True:
            with self._admission_lock:
                with self._lock:
                    if not self._waiting:
                        return
                    ticket, args = self._waiting[0]
                if self._admission_verdict(ticket, None,
                                           waiting_adjust=-1) is not None:
                    return
                with self._lock:
                    self._waiting.popleft()
                    self._active[ticket.job_id] = ticket   # reserve
            (handle, qc, priority, abs_deadline, weight,
             checkpoint_dir, restored) = args
            self._admit(ticket, handle, qc, priority, abs_deadline, weight,
                        checkpoint_dir=checkpoint_dir, restored=restored)

    # -- cancellation --------------------------------------------------------
    def cancel(self, ticket: JobTicket) -> bool:
        """Cancel a queued or running job: queued tasks are dropped,
        in-flight tasks finish but their partials are discarded."""
        # _admission_lock serializes this removal with _drain_waiting's
        # read-then-popleft (and with close()'s snapshot): mutating the
        # deque under _lock alone could make the drain pop a *different*
        # ticket than the one it verdict-checked, silently dropping it
        with self._admission_lock:
            with self._lock:
                for i, (t, _args) in enumerate(self._waiting):
                    if t is ticket:
                        del self._waiting[i]
                        break
        if ticket.status not in (QUEUED, RUNNING):
            return False
        # the flag is raised BEFORE pool.cancel so _admit's post-submit
        # re-check pairs with it: either this pool.cancel sees the
        # submitted job, or _admit's re-check sees the flag — the
        # store-load ordering leaves no window where both miss
        ticket.cancel_requested = True
        if self._pool is not None:
            self._pool.cancel(ticket.job_id)
        ticket._close_tree()
        # the arbitrated outcome: False when the job's own completion
        # (or a close()-rejection) beat this cancellation to _finish
        return self._finish(ticket, CANCELLED)

    # -- simulated-backend path ----------------------------------------------
    def _submit_simulated(self, handle: DatasetHandle, workload,
                          seed: int, *, epsilon: Optional[float] = None,
                          confidence: float = 0.95,
                          min_tasks: int = 8,
                          checkpoint_dir: Optional[str] = None,
                          resume_from: Optional[str] = None) -> JobTicket:
        """Virtual-time spec: run the job inline through the one-shot
        driver (a resident pool has no meaning in virtual time), reusing
        the handle's cached kneepoint so repeat queries still skip the
        offline phase."""
        engine = pc.resolve_engine(workload.statistic, self.spec.engine)
        _res, knee = handle.cached_knee(
            workload, engine=engine, sizing=self.plat.task_sizing,
            kneepoint_sizes=self.spec.kneepoint_sizes,
            device=self.spec.device)
        # grouped replace (the flat mirrors are passed too, matching the
        # groups, so the spec shim sees no conflict and stays silent)
        spec = dataclasses.replace(
            self.spec, seed=seed, knee_bytes=knee,
            approx=ApproxOptions(epsilon=epsilon, confidence=confidence,
                                 min_tasks=min_tasks),
            epsilon=epsilon, confidence=confidence, min_tasks=min_tasks,
            faults=dataclasses.replace(self.spec.faults,
                                       checkpoint_dir=checkpoint_dir),
            checkpoint_dir=checkpoint_dir)
        ticket = JobTicket(next(self._job_seq), handle, workload,
                           n_tasks=0, statistic=workload.statistic,
                           seed=seed)
        ticket.epsilon, ticket.confidence = epsilon, confidence
        ticket.min_tasks = min_tasks
        with self._admission_lock:
            # same closed re-check + slot reservation as the threaded
            # path: a submit racing close() raises instead of running
            # inline on a closed service, and close()'s orphan pass
            # covers a reserved ticket mid-run (_finish arbitrates the
            # terminal state either way)
            if self._closed:
                raise RuntimeError("service is closed")
            with self._lock:
                self._active[ticket.job_id] = ticket
                self._tickets[ticket.job_id] = ticket
                # transition inside the locked section: after release,
                # close()'s orphan pass may fail the ticket, and an
                # unguarded later write would resurrect a terminal state
                ticket.status = RUNNING
        ticket.admitted_at = ticket.started_at = time.monotonic()
        try:
            report = Platform(spec).run(handle.samples, handle.months,
                                        workload, resume_from=resume_from)
        except BaseException as e:         # noqa: BLE001
            ticket.error = e
            self._finish(ticket, FAILED, reason=repr(e))
            return ticket
        ticket.n_tasks = report.n_tasks
        ticket.tasks_restored = report.tasks_restored
        ticket._result = report.result
        ticket.device_dispatches = report.device_dispatches
        ticket.bytes_uploaded = report.bytes_uploaded
        ticket.tasks_executed = report.tasks_executed
        ticket.tasks_cancelled = report.tasks_cancelled
        ticket.stop_reason = report.stop_reason
        ticket.final_ci = report.final_ci
        self._finish(ticket, DONE)
        return ticket

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        pool = self._pool
        with self._lock:
            active, waiting = len(self._active), len(self._waiting)
        with self._stats_lock:
            waves = list(self.dispatch.wave_sizes)
            out = {
                "jobs_completed": self.jobs_completed,
                "jobs_rejected": self.jobs_rejected,
                "jobs_active": active,
                "jobs_waiting": waiting,
                "device_dispatches": self.dispatch.device_dispatches,
                "bytes_uploaded": self.dispatch.bytes_uploaded,
                "wave_sizes": waves,
            }
        if pool is not None:
            out["fused_dispatches"] = pool.sched.fused_dispatches
            out["pending_tasks"] = pool.pending_tasks()
            out["speculative_launches"] = pool.sched.speculative_launches
            out["speculation_wins"] = pool.sched.speculation_wins
            out["reranks"] = pool.sched.reranks
            if pool.prefetcher is not None:
                out.update(pool.prefetcher.stats())
        if self.datastore is not None and self.datastore.cache is not None:
            for k, v in self.datastore.cache.stats().items():
                out[f"cache_{k}"] = v
        if self.scale_decision is not None:
            out["scale_decision"] = self.scale_decision
        return out

    def telemetry_snapshot(self) -> Dict[str, Any]:
        """``status_monitor``-style view (DESIGN.md §13): the bus's
        counters/gauges/histograms and recent time-series samples, plus
        the service-level :meth:`stats`."""
        snap = self.telemetry.snapshot()
        snap["service"] = self.stats()
        return snap

    def write_trace(self, path: str) -> Dict[str, Any]:
        """Export the session's per-task spans + wave flows as Chrome
        trace-event JSON (open in Perfetto / ``chrome://tracing``)."""
        return tel.write_trace(self.telemetry, path)

    def write_report(self, path: str,
                     title: str = "platform service") -> None:
        """Write a dependency-free, self-contained HTML report for this
        service session."""
        tel.write_report(self.telemetry, path, title=title)

    def monitor_snapshot(self) -> Dict[str, Any]:
        """The monitor's full view (DESIGN.md §15): SLIs, alert state,
        per-job critical paths, and ranked root-cause findings —
        requires ``monitor=MonitorOptions(enabled=True)`` on the spec."""
        if self.monitor is None:
            raise RuntimeError(
                "monitor disabled; construct the service with "
                "PlatformSpec(monitor=MonitorOptions(enabled=True))")
        return self.monitor.snapshot()

    def write_monitor_report(self, path: str,
                             title: str = "platform monitor") -> None:
        """Self-contained HTML: alert timeline + per-job critical-path
        waterfall (requires the monitor to be enabled)."""
        if self.monitor is None:
            raise RuntimeError(
                "monitor disabled; construct the service with "
                "PlatformSpec(monitor=MonitorOptions(enabled=True))")
        mon.write_monitor_report(self.monitor, path, title)

    def _register_sampler_providers(self) -> None:
        """Periodic time-series rows (DESIGN.md §13): queue depth and
        worker liveness from the pool, per-node score/state from the
        data plane, CI half-width per error-bounded job.  Providers are
        best-effort — the sampler drops a provider's row for a tick if
        it raises — and the sampler thread itself only runs when the
        bus is enabled."""
        state_code = {"healthy": 0.0, "degraded": 1.0, "down": 2.0}

        def service_row() -> Dict[str, float]:
            with self._lock:
                row = {"jobs_active": float(len(self._active)),
                       "jobs_waiting": float(len(self._waiting))}
            pool = self._pool
            if pool is not None:
                row["pending_tasks"] = float(pool.pending_tasks())
                row["workers_alive"] = float(sum(
                    1 for th in list(pool._threads.values())
                    if th.is_alive()))
            return row

        def nodes_row() -> Dict[str, float]:
            if self.datastore is None:
                return {}
            row: Dict[str, float] = {}
            for nid, score in self.datastore.node_scores().items():
                row[f"node{nid}.score"] = (
                    score if score != float("inf") else -1.0)
            for nid, state in self.datastore.node_states().items():
                row[f"node{nid}.state"] = state_code.get(state, -1.0)
            return row

        def ci_row() -> Dict[str, float]:
            with self._lock:
                tickets = list(self._active.values())
            row: Dict[str, float] = {}
            for t in tickets:
                est = t.estimator
                if est is None or t.epsilon is None:
                    continue
                snap = est.estimate()
                if snap is not None:
                    row[f"job{t.job_id}.ci_half_width"] = snap.half_width
            return row

        self.sampler.add_provider("service", service_row)
        self.sampler.add_provider("data", nodes_row)
        self.sampler.add_provider("ci", ci_row)
