"""End-to-end tiny-task platform driver (thesis §3, Fig 1/4).

One object composes the pieces the thesis argues only win *together*:

  kneepoint task sizing (§3.2)  →  datastore distribution (§3.5)
      →  two-phase dynamic scheduling (§3.4)  →  streaming reduce (§3.1)

:class:`Platform` takes a dataset (sample dict) + a stats workload (or a
custom map callable), runs the offline kneepoint phase to size tasks,
partitions them through the replicated :class:`~repro_torch.core.datastore`
shards, executes them on a pluggable backend — real threads
(:class:`~repro_torch.platform.backend.ThreadedBackend`) or virtual-time
scale-out (:class:`~repro_torch.platform.backend.SimulatedBackend`) — streams
partials through the deterministic async reduce tree, and emits a
structured :class:`JobReport` (per-phase timings, queue-depth trace,
cache-proxy miss curve, straggler counts).

The platform *configurations* of the evaluation (§4.1.3) select overhead
profiles:

  BTS  BashReduce + Task Sizing (kneepoint)        — the contribution
  BLT  BashReduce + Large Tasks (all samples/node)
  BTT  BashReduce + Tiniest Tasks (1 sample/task)
  VH   Vanilla-Hadoop-like: task-level monitoring + heavy startup + per-task
       launch overhead (JVM) + distributed-FS tax
  JLH  Job-level-Hadoop-like: monitoring off, startup reduced
  LH   Lite-Hadoop-like: no DFS interference (results "incorrect" in the
       thesis; kept for overhead benchmarking only)

Overhead constants are calibrated to the thesis' measurements (Fig 5/6:
vanilla Hadoop ≈ 4× BashReduce startup, ≈ 21% startup tax from monitoring,
≈ 20% per-task runtime tax, BashReduce ≈ 12% scheduling overhead).

This is the PyTorch port of the reference driver.  Its map tasks run on
``PlatformSpec.device`` (the card unless the caller asks for the CPU).  It
takes everything the reference's driver takes — the replicated datastore
with balanced scheduling and prefetch, fault injection, checkpoint/resume,
the virtual-time scale-out and sharded waves over a wave mesh
(``mesh_devices``: the first cards on ``cuda``, repeated entries of the
CPU on ``cpu``; ``repro_torch.launch.mesh``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import estimator as est_mod
from repro_torch.core import kneepoint as kp
from repro_torch.core import scheduler as sch
from repro_torch.core import slo as slo_mod
from repro_torch.core.blockcache import BlockCache, CacheOptions
from repro_torch.core.prefetch import TaskPrefetcher
from repro_torch.launch.mesh import make_wave_mesh
from repro_torch.platform import compute as pc
from repro_torch.platform import telemetry as tel
from repro_torch.platform.monitor import (
    PlatformMonitor,
    resolve_monitor_options,
    write_monitor_report as _write_monitor_report,
)
from repro_torch.platform.backend import (
    BackendOutcome,
    PlatformBackend,
    SimulatedBackend,
    ThreadedBackend,
)
from repro_torch.platform.reduce import StreamingReduceTree, finalize_stats


@dataclasses.dataclass(frozen=True)
class PlatformConfig:
    name: str
    task_sizing: str           # "kneepoint" | "large" | "tiny"
    startup_time: float        # one-time job startup (seconds)
    launch_overhead: float     # per-task launch cost (seconds)
    monitoring: bool           # task-level monitoring tax
    recovery: str              # "job" | "task"
    dfs_tax: float = 0.0       # per-task distributed-FS overhead factor


# Calibrated against Fig 5/6 (normalized to BashReduce startup ≈ 1 unit,
# ≈ 13 s on the thesis cluster; vanilla Hadoop ≈ 4×, monitoring +21%).
BASH_STARTUP = 0.050           # scaled-down unit startup for this container
PLATFORMS: Dict[str, PlatformConfig] = {
    "BTS": PlatformConfig("BTS", "kneepoint", BASH_STARTUP, 0.0005,
                          monitoring=False, recovery="job"),
    "BLT": PlatformConfig("BLT", "large", BASH_STARTUP, 0.0005,
                          monitoring=False, recovery="job"),
    "BTT": PlatformConfig("BTT", "tiny", BASH_STARTUP, 0.0005,
                          monitoring=False, recovery="job"),
    "VH": PlatformConfig("VH", "large", 4.0 * BASH_STARTUP, 0.008,
                         monitoring=True, recovery="task", dfs_tax=0.25),
    "JLH": PlatformConfig("JLH", "large", 2.0 * BASH_STARTUP, 0.004,
                          monitoring=False, recovery="job", dfs_tax=0.25),
    "LH": PlatformConfig("LH", "large", 2.0 * BASH_STARTUP, 0.004,
                         monitoring=False, recovery="job", dfs_tax=0.0),
}


# ---------------------------------------------------------------------------
# grouped platform options (the stable public configuration surface)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WaveOptions:
    """Wave execution: batch same-shape ready tasks into one device
    dispatch (threaded backend, kernel or torch engine)."""

    wave: str = "auto"                     # "auto" | "on" | "off"
    max_wave: int = 32                     # wave size cap (task count)
    # sharded wave execution (DESIGN.md §11) over a wave mesh of this
    # many devices; None keeps the plain single-device arena
    mesh_devices: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ScheduleOptions:
    """Dynamic scheduling policy: balanced (response-time + cache
    locality) claim ranking, straggler speculation, data-plane
    prefetch, and SLO-aware pool sizing."""

    balanced: str = "auto"                 # "auto" | "on" | "off"
    speculation: str = "off"               # "off" | "on" | "auto"
    straggler_factor: float = 2.0
    prefetch: str = "auto"                 # "auto" | "on" | "off"
    slo_seconds: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ApproxOptions:
    """Error-bounded approximate queries (DESIGN.md §10): stop once the
    CI half-width at ``confidence`` falls under ``epsilon``."""

    epsilon: Optional[float] = None
    confidence: float = 0.95
    min_tasks: int = 8


@dataclasses.dataclass(frozen=True)
class FaultOptions:
    """Failure model (DESIGN.md §12): lease-based task reclamation,
    checkpoint/resume of reduce partials, bounded worker respawns."""

    lease_seconds: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 8
    max_respawns: int = 2


# (group field name, option class, member names shared with the legacy
# flat PlatformSpec fields) — the resolution shim in __post_init__
_SPEC_GROUPS: Tuple[Tuple[str, type, Tuple[str, ...]], ...] = (
    ("waves", WaveOptions, ("wave", "max_wave", "mesh_devices")),
    ("schedule", ScheduleOptions,
     ("balanced", "speculation", "straggler_factor", "prefetch",
      "slo_seconds")),
    ("approx", ApproxOptions, ("epsilon", "confidence", "min_tasks")),
    ("faults", FaultOptions,
     ("lease_seconds", "checkpoint_dir", "checkpoint_every",
      "max_respawns")),
)


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """Everything that selects a job's execution, in one value.

    Configuration is grouped into typed option values —
    ``PlatformSpec(schedule=ScheduleOptions(balanced="on"),
    cache=CacheOptions(capacity_bytes=1 << 20))`` — while the legacy
    flat kwargs (``PlatformSpec(balanced="on")``) keep working through
    a resolution shim that emits a :class:`DeprecationWarning`.  After
    construction both views are coherent: each flat field mirrors its
    group (``spec.balanced == spec.schedule.balanced``), and
    ``dataclasses.replace(spec, schedule=...)`` updates both.  When a
    group AND a conflicting non-default flat kwarg are passed, the
    group wins (with a warning) — flat kwargs are the migration path,
    not an override."""

    platform: str = "BTS"                  # PLATFORMS key
    n_workers: int = 2
    backend: str = "threaded"              # "threaded" | "simulated"
    engine: str = "auto"                   # compute.resolve_engine
    wave: str = "auto"                     # "auto" | "on" | "off": batch
    #   same-shape ready tasks into one kernel launch (threaded backend,
    #   kernel or torch engine; per-task fallback for numpy & custom map_fn)
    max_wave: int = 32                     # wave size cap (task count)
    # sharded wave execution (DESIGN.md §11): partition the block arena
    # and every wave over a wave mesh of this many devices
    # (launch.mesh.make_wave_mesh: the first cards on "cuda", which must
    # exist; repeated CPU entries on "cpu").  None keeps the plain
    # single-device arena; mesh_devices=1 routes through the sharded
    # path on a 1-device mesh.  Results are bit-identical at any mesh
    # size, and the scheduler's claim cap stays mesh-invariant so the
    # epsilon early-stop executes the same task set on every mesh.
    mesh_devices: Optional[int] = None
    # balanced dynamic scheduling (DESIGN.md §9): rank ready tasks by the
    # predicted fetch latency of their best available data-node replica
    # ("auto" engages whenever a datastore is attached; "on" requires one)
    balanced: str = "auto"                 # "auto" | "on" | "off"
    # straggler speculation: clone in-flight tasks older than
    # straggler_factor × the exec EMA onto an idle worker ("auto" gates
    # each clone through recovery.should_speculate's §3.3 cost model)
    speculation: str = "off"               # "off" | "on" | "auto"
    straggler_factor: float = 2.0
    # dynamic-k data-plane prefetch: upcoming tasks' fetches go in flight
    # while the current wave executes ("auto" engages with a datastore)
    prefetch: str = "auto"                 # "auto" | "on" | "off"
    # SLO-aware pool sizing: when set, worker count is chosen by
    # slo.choose_workers over a pow2 ladder up to n_workers (needs a
    # measured kneepoint for the throughput model; silently keeps
    # n_workers otherwise)
    slo_seconds: Optional[float] = None
    # error-bounded approximate queries (DESIGN.md §10): with an epsilon
    # target the job streams a running estimate + CI and DRAINs (cancels
    # its unexecuted tasks) once the CI half-width at `confidence` falls
    # under epsilon, after at least `min_tasks` tasks.  epsilon=None
    # keeps every path bit-identical to a full run.
    epsilon: Optional[float] = None
    confidence: float = 0.95
    min_tasks: int = 8
    # failure model (DESIGN.md §12).  ``lease_seconds`` arms lease-based
    # task reclamation: a claimed task whose lease lapses is requeued
    # (first completion wins; per-task seeds keep the race bit-exact).
    # ``checkpoint_dir`` persists completed reduce-tree partials every
    # ``checkpoint_every`` leaves so an interrupted job resumes via
    # ``Platform.run(resume_from=...)`` executing only missing tasks.
    # ``max_respawns`` bounds per-worker crash respawns.
    lease_seconds: Optional[float] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 8
    max_respawns: int = 2
    knee_bytes: Optional[float] = None     # skip the offline phase if set
    kneepoint_sizes: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
    seed: int = 0
    task_sizing: Optional[str] = None      # override the config's sizing
    startup_time: Optional[float] = None   # override the config's startup
    startup_scale: float = 1.0             # sim: thesis-scale startup
    compute_values: bool = True            # sim: real partials vs cost-only
    sim_workers: Optional[Tuple[sch.SimWorker, ...]] = None
    scheduler: Optional[sch.SchedulerConfig] = None
    # unified telemetry (DESIGN.md §13): None/False ⇒ disabled no-op
    # sink (results bit-identical either way), True/"on" ⇒ record into
    # bounded rings, or an explicit telemetry.TelemetryConfig
    telemetry: Any = None
    # grouped option values (the stable configuration surface).  None ⇒
    # synthesized from the legacy flat fields above by __post_init__;
    # when provided, the group is authoritative and the flat mirrors
    # are synced to it.
    waves: Optional[WaveOptions] = None
    schedule: Optional[ScheduleOptions] = None
    approx: Optional[ApproxOptions] = None
    faults: Optional[FaultOptions] = None
    # worker-side block cache (DESIGN.md §14); the default
    # CacheOptions() has capacity_bytes=0 ⇒ disabled, bit-identical to
    # the uncached platform
    cache: Optional[CacheOptions] = None
    # SLO monitor / critical-path / diagnosis layer (DESIGN.md §15);
    # None/False ⇒ disabled (no tap, zero new events, bit-identical),
    # True/"on" ⇒ enabled defaults, or an explicit MonitorOptions
    monitor: Any = None
    # where map tasks run: the card, unless the caller asks for "cpu"
    # (then each kernel wrapper runs its plain PyTorch version)
    device: str = "cuda"

    def __post_init__(self) -> None:
        for gname, gcls, members in _SPEC_GROUPS:
            defaults = {f.name: f.default for f in dataclasses.fields(gcls)}
            group = getattr(self, gname)
            if group is None:
                # legacy flat view: synthesize the group from the flat
                # fields; warn only when a flat kwarg was actually used
                flat = {m: getattr(self, m) for m in members}
                changed = [m for m in members if flat[m] != defaults[m]]
                if changed:
                    warnings.warn(
                        f"flat PlatformSpec field(s) {changed} are "
                        f"deprecated; pass {gname}="
                        f"{gcls.__name__}(...) instead",
                        DeprecationWarning, stacklevel=3)
                object.__setattr__(self, gname, gcls(**flat))
            else:
                # grouped view: the group wins; a conflicting
                # non-default flat kwarg is superseded (with a warning)
                clash = [m for m in members
                         if getattr(self, m) != defaults[m]
                         and getattr(self, m) != getattr(group, m)]
                if clash:
                    warnings.warn(
                        f"flat PlatformSpec field(s) {clash} are "
                        f"superseded by the {gname}= option group",
                        DeprecationWarning, stacklevel=3)
                for m in members:
                    object.__setattr__(self, m, getattr(group, m))
        if self.cache is None:
            object.__setattr__(self, "cache", CacheOptions())
        object.__setattr__(self, "monitor",
                           resolve_monitor_options(self.monitor))


@dataclasses.dataclass
class JobReport:
    """Structured job outcome — superset of the legacy tiny_task report."""

    platform: str
    n_tasks: int
    task_size_bytes: float
    makespan: float
    throughput_bps: float      # input bytes / second
    startup_time: float
    result: Optional[dict] = None
    kneepoint: Optional[kp.KneepointResult] = None
    # platform-driver extensions
    backend: str = "threaded"
    engine: str = "auto"
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    queue_depths: List[int] = dataclasses.field(default_factory=list)
    miss_curve: Tuple[kp.CurvePoint, ...] = ()
    max_task_bytes: float = 0.0
    stragglers: int = 0
    speculative_launches: int = 0
    restarts: int = 0
    calibration_seconds: float = 0.0
    datastore_stats: Optional[Dict[str, float]] = None
    reduce_info: Optional[Dict[str, float]] = None
    # wave-execution observability (execute-phase map dispatches only;
    # warmup/kneepoint compiles are startup cost and are not counted)
    device_dispatches: int = 0
    bytes_uploaded: float = 0.0
    wave_sizes: List[int] = dataclasses.field(default_factory=list)
    # balanced-scheduling observability (DESIGN.md §9)
    speculation_wins: int = 0
    scale_decision: Optional[str] = None    # slo.choose_workers reasoning
    n_workers_used: int = 0
    prefetch_stats: Optional[Dict[str, float]] = None
    # worker-side block cache observability (DESIGN.md §14)
    cache_stats: Optional[Dict[str, float]] = None
    # error-bounded approximate execution (DESIGN.md §10)
    tasks_executed: int = 0
    tasks_cancelled: int = 0
    stop_reason: Optional[str] = None       # None ⇒ ran to completion
    final_ci: Optional[Dict[str, Any]] = None   # EstimateSnapshot dict
    # failure model / recovery observability (DESIGN.md §12)
    tasks_restored: int = 0        # leaves restored from a checkpoint
    checkpoint_saves: int = 0      # committed checkpoint steps this run
    fault_events: int = 0          # injected faults that fired this run
    checkpoint_bytes: int = 0      # array bytes handed to those saves


def make_tasks(sample_sizes: Sequence[int], sizing: str,
               knee_bytes: Optional[float], n_workers: int) -> List[sch.Task]:
    """Partition samples into tasks per the config's sizing policy."""
    total = float(sum(sample_sizes))
    if sizing == "tiny":
        groups = [[i] for i in range(len(sample_sizes))]
    elif sizing == "large":
        # all samples partitioned to a node in one file (Sn samples/task)
        per_node = total / max(n_workers, 1)
        groups = kp.pack_tasks_by_count(sample_sizes, per_node)
    else:
        assert knee_bytes is not None, "kneepoint sizing needs a knee"
        groups = kp.pack_tasks_by_count(sample_sizes, knee_bytes)
    out = []
    for tid, g in enumerate(groups):
        out.append(sch.Task(
            task_id=tid, sample_ids=tuple(g),
            size_bytes=float(sum(sample_sizes[i] for i in g))))
    return out


def measure_kneepoint(samples: Dict[int, np.ndarray],
                      months: Dict[int, np.ndarray],
                      workload,
                      sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                      *,
                      engine: str = "auto",
                      map_fn: Optional["MapFn"] = None,
                      device="cuda",
                      ) -> Tuple[kp.KneepointResult, float]:
    """Offline phase (Fig 3): run isolated map tasks of increasing block
    size, record per-sample wall time (the cost-per-byte miss proxy of
    DESIGN.md §2), find the knee.  With ``map_fn`` the curve is measured
    on the custom compute that will actually execute."""
    ids = sorted(samples)
    sample_bytes = np.mean([samples[i].nbytes for i in ids])
    eng = (None if map_fn is not None
           else pc.resolve_engine(workload.statistic, engine))

    def exec_task(n: int) -> float:
        n = min(n, len(ids))
        block = np.stack(pc.pad_to_common([samples[i] for i in ids[:n]]))
        mo = np.stack(pc.pad_to_common([months[i] for i in ids[:n]]))
        t0 = time.perf_counter()
        if map_fn is not None:
            probe = sch.Task(task_id=-1, sample_ids=tuple(range(n)),
                             size_bytes=float(n * sample_bytes))
            map_fn(probe, block, mo, 0)
        else:
            pc.run_map_task(block, mo, 0, workload, eng, device=device)
        return (time.perf_counter() - t0) / n

    curve = kp.measure_curve(exec_task, [s for s in sizes
                                         if s <= len(ids)], repeats=3)
    curve = [kp.CurvePoint(p.task_size * sample_bytes, p.cost)
             for p in curve]
    res = kp.find_kneepoint(curve)
    return res, res.task_size


MapFn = Callable[[sch.Task, np.ndarray, np.ndarray, int], Dict[str, Any]]


# ---------------------------------------------------------------------------
# Reusable job phases (plan → wave/task contexts) — the substrate shared
# by one-shot Platform.run and the persistent PlatformService
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JobPlan:
    """Output of the plan phase: kneepoint + task partition + block-shape
    policy.  Everything execution needs, decoupled from the driver so the
    service can compute it once per (dataset, query class) and serve many
    jobs from it."""

    engine: str
    tasks: List[sch.Task]
    ids: List[int]                      # sorted sample keys
    total_bytes: float
    knee_bytes: Optional[float]
    knee_res: Optional[kp.KneepointResult]
    pad_len: int
    max_count: int
    task_shape: Callable[[sch.Task], Tuple[int, int]]
    build_block: Callable[[sch.Task], Tuple[np.ndarray, np.ndarray]]
    plan_seconds: float = 0.0           # offline kneepoint time
    partition_seconds: float = 0.0      # task partition time


def plan_job(samples: Dict[int, np.ndarray],
             months: Dict[int, np.ndarray],
             workload, *,
             sizing: str,
             engine: str,
             n_exec: int,
             knee_bytes: Optional[float] = None,
             kneepoint_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
             map_fn: Optional[MapFn] = None,
             device="cuda") -> JobPlan:
    """Phases 1-2 of the data path minus datastore placement: measure the
    kneepoint if the sizing policy needs one, partition samples into
    tasks, and derive the padded-shape / block-building closures."""
    ids = sorted(samples)
    sizes = [samples[i].nbytes for i in ids]
    knee_res = None
    t0 = time.perf_counter()
    if sizing == "kneepoint" and knee_bytes is None:
        knee_res, knee_bytes = measure_kneepoint(
            samples, months, workload, sizes=kneepoint_sizes,
            engine="auto" if engine == "custom" else engine, map_fn=map_fn,
            device=device)
    plan_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    tasks = make_tasks(sizes, sizing, knee_bytes, n_exec)
    max_count = max(len(t.sample_ids) for t in tasks)
    pad_len = (0 if map_fn is not None else
               pc.partial_pad_len(workload.statistic, samples))

    def task_shape(task: sch.Task) -> Tuple[int, int]:
        """Padded block shape, derived from row lengths without
        materializing the block (same policy as pad_to_common)."""
        longest = max(samples[ids[i]].shape[0] for i in task.sample_ids)
        return (max_count, pc.padded_len(longest, pad_len))

    def build_block(task: sch.Task) -> Tuple[np.ndarray, np.ndarray]:
        return pc.build_block(samples, months, ids, task.sample_ids,
                              max_count, pad_len)

    return JobPlan(
        engine=engine, tasks=tasks, ids=ids,
        total_bytes=float(sum(sizes)), knee_bytes=knee_bytes,
        knee_res=knee_res, pad_len=pad_len, max_count=max_count,
        task_shape=task_shape, build_block=build_block,
        plan_seconds=plan_seconds,
        partition_seconds=time.perf_counter() - t0)


class WaveContext:
    """Device-resident execution state for one query class: the packed
    :class:`~repro_torch.platform.compute.BlockArena`, one fixed wave width per
    shape bucket, and the warmed kernels.  Built once (upload + compile
    are startup cost), then every wave — from this job or, in the
    service, from ANY job on the same dataset/workload/engine — ships
    only its slot and seed vectors."""

    def __init__(self, arena: pc.BlockArena, wave_pad: Dict[Any, int],
                 workload, engine: str,
                 task_shape: Callable[[sch.Task], Any]):
        self.arena = arena
        self.wave_pad = wave_pad
        self.workload = workload
        self.engine = engine
        self.task_shape = task_shape

    def cap(self, task: sch.Task) -> int:
        """The fixed wave width of this task's shape bucket: the most tasks
        the scheduler puts in one of its waves."""
        return self.wave_pad[self.task_shape(task)]

    def run(self, tasks: List[sch.Task],
            seeds: np.ndarray) -> List[Dict[str, np.ndarray]]:
        return pc.run_map_wave(self.arena, tasks, seeds, self.workload,
                               self.engine)

    def wave_bytes(self, n: int) -> float:
        """Host→device traffic of an n-task wave: slot + seed vectors
        only (the arena is resident)."""
        return 2.0 * n * np.dtype(np.int32).itemsize


def build_wave_context(plan: JobPlan, workload, *, n_exec: int,
                       max_wave: int, warm_seed: int = 0,
                       device="cuda", mesh=None) -> WaveContext:
    """Pack the plan's blocks into the device arena, pin one wave width
    per shape bucket, and warm one full-size wave per bucket (the kernel's
    build and first launch are set-up, not a wave's time); buckets split
    across workers so one worker cannot swallow a bucket in a single wave
    while its peers idle.  The moments kernel
    never reads the months plane, so its arena leaves it out; the torch
    engine's carries it.

    With ``mesh`` (a ``launch.mesh.make_wave_mesh`` wave mesh) the arena
    is partitioned over its entries and waves dispatch sharded, the
    warm-up's too.  The
    ``wave_pad`` claim caps are computed identically either way — they
    drive the *scheduler's* wave partition, which must stay
    mesh-invariant for the epsilon early-stop path to settle at the
    same task counts on every mesh size."""
    with_months = plan.engine == "torch"
    if mesh is not None:
        arena: pc.BlockArena = pc.ShardedBlockArena.pack(
            plan.tasks, plan.task_shape, plan.build_block, mesh,
            with_months=with_months)
    else:
        arena = pc.BlockArena.pack(plan.tasks, plan.task_shape,
                                   plan.build_block,
                                   with_months=with_months, device=device)
    by_key: Dict[Any, List[sch.Task]] = {}
    for task in plan.tasks:
        by_key.setdefault(plan.task_shape(task), []).append(task)
    n_exec = max(n_exec, 1)
    wave_pad = {
        key: pc.pow2_ceil(min(max_wave, -(-len(group) // n_exec)))
        for key, group in by_key.items()}
    for key, group in by_key.items():
        warm = group[:min(wave_pad[key], len(group))]
        pc.run_map_wave(arena, warm,
                        np.full(len(warm), warm_seed, np.int32),
                        workload, plan.engine)
    return WaveContext(arena, wave_pad, workload, plan.engine,
                       plan.task_shape)


def resolve_platform_config(spec: PlatformSpec) -> PlatformConfig:
    """The overhead profile a spec selects, with per-spec overrides."""
    if spec.platform not in PLATFORMS:
        raise ValueError(
            f"unknown platform config {spec.platform!r}; "
            f"choose one of {sorted(PLATFORMS)}")
    plat = PLATFORMS[spec.platform]
    overrides = {}
    if spec.task_sizing is not None:
        overrides["task_sizing"] = spec.task_sizing
    if spec.startup_time is not None:
        overrides["startup_time"] = spec.startup_time
    return dataclasses.replace(plat, **overrides) if overrides else plat


def wave_enabled(spec: PlatformSpec, engine: str, workload,
                 has_map_fn: bool = False) -> bool:
    """Wave execution needs the threaded backend (the simulator
    calibrates per-task costs) and a device engine; ``wave="on"``
    makes an unsupported combination an error instead of a silent
    per-task fallback.  ``"auto"`` additionally requires the workload
    to be dispatch-overhead-bound (small per-task draw volume) —
    batching heavy tasks pays pad compute for nothing."""
    if spec.wave not in ("auto", "on", "off"):
        raise ValueError(f"unknown wave mode {spec.wave!r}; "
                         "choose 'auto', 'on' or 'off'")
    if spec.wave == "off" or spec.max_wave <= 1:
        return False
    supported = (spec.backend == "threaded" and not has_map_fn
                 and pc.wave_supported(engine))
    if spec.wave == "on" and not supported:
        raise ValueError(
            "wave='on' needs the threaded backend and a device engine "
            f"(kernel or torch) with no custom map_fn; got backend="
            f"{spec.backend!r}, engine={engine!r}, map_fn="
            f"{'set' if has_map_fn else 'None'}")
    if spec.wave == "auto":
        return supported and pc.wave_profitable(workload)
    return supported


def resolve_wave_mesh(spec: PlatformSpec, wave_on: bool):
    """Build the wave mesh a spec asks for, or ``None``.

    Like the other mode resolvers, an impossible request is an error,
    never a silent fallback: ``mesh_devices`` without wave execution
    would shard nothing, and asking for more cards than exist fails in
    ``make_wave_mesh``."""
    if spec.mesh_devices is None:
        return None
    if spec.mesh_devices < 1:
        raise ValueError(
            f"mesh_devices must be >= 1, got {spec.mesh_devices}")
    if not wave_on:
        raise ValueError(
            "mesh_devices shards wave execution, which this spec "
            "disables — it needs the threaded backend, a device engine "
            "(kernel|torch) and wave != 'off'")
    return make_wave_mesh(spec.mesh_devices, spec.device)


def balanced_enabled(spec: PlatformSpec, has_datastore: bool) -> bool:
    """Response-time-aware claim ordering needs a data plane to score;
    ``balanced="on"`` makes its absence an error instead of a silent
    FIFO fallback."""
    if spec.balanced not in ("auto", "on", "off"):
        raise ValueError(f"unknown balanced mode {spec.balanced!r}; "
                         "choose 'auto', 'on' or 'off'")
    if spec.balanced == "off":
        return False
    if spec.balanced == "on" and not has_datastore:
        raise ValueError("balanced='on' needs a datastore to score "
                         "replicas against")
    return has_datastore


def prefetch_enabled(spec: PlatformSpec, has_fetch: bool) -> bool:
    """Like :func:`balanced_enabled`: ``"on"`` makes a configuration
    that cannot prefetch an error instead of a silent inline-fetch
    fallback (no datastore to fetch from, or a virtual-time backend
    that models the overlap itself)."""
    if spec.prefetch not in ("auto", "on", "off"):
        raise ValueError(f"unknown prefetch mode {spec.prefetch!r}; "
                         "choose 'auto', 'on' or 'off'")
    if spec.prefetch == "on":
        if not has_fetch:
            raise ValueError("prefetch='on' needs a datastore whose "
                             "fetches can be pipelined")
        if spec.backend == "simulated":
            raise ValueError("prefetch='on' needs the threaded backend "
                             "(the simulator models the §3.5 overlap "
                             "in virtual time)")
    return (spec.prefetch != "off" and has_fetch
            and spec.backend == "threaded")


def resolve_speculation(spec: PlatformSpec):
    """Map the spec's speculation mode onto SchedulerConfig.speculative."""
    if spec.speculation not in ("off", "on", "auto"):
        raise ValueError(f"unknown speculation mode {spec.speculation!r}; "
                         "choose 'off', 'on' or 'auto'")
    return {"off": False, "on": True, "auto": "auto"}[spec.speculation]


def build_prefetcher(n_workers: int) -> TaskPrefetcher:
    """The platform's prefetch pipe: ~2 waves/worker of look-ahead and
    one background fetch stream per worker.  Deeper pipes cannot raise
    data-plane throughput past nodes × parallelism / latency — they
    only add queueing (the contention term of §3.5)."""
    return TaskPrefetcher(min_depth=max(2, n_workers),
                          max_depth=max(4, 2 * n_workers),
                          workers=max(2, min(2 * n_workers, 8)))


def slo_worker_decision(spec: PlatformSpec, plat: PlatformConfig,
                        plan: JobPlan) -> Optional[slo_mod.ScaleDecision]:
    """SLO-aware pool sizing (thesis §4.2.3 / Fig 12-13): with a target
    ``slo_seconds`` and a measured kneepoint, choose the worker count
    that maximizes data within the SLO window — small jobs under tight
    SLOs get *fewer* workers because startup dominates.  ``None`` when
    no SLO is set or the knee was not measured (no throughput model)."""
    if spec.slo_seconds is None or plan.knee_res is None:
        return None
    cost = plan.knee_res.curve[plan.knee_res.index].cost  # s per sample
    if cost <= 0 or not plan.ids:
        return None
    sample_bytes = plan.total_bytes / len(plan.ids)
    return slo_mod.choose_workers(
        max(spec.n_workers, 1),
        bytes_per_second_per_worker=sample_bytes / cost,
        startup_seconds=plat.startup_time,
        slo_seconds=spec.slo_seconds)


class JobCheckpointer:
    """Persist completed reduce-tree leaf partials during execution
    (DESIGN.md §12).  Every ``every`` newly completed leaves the full
    set of accumulated partials is saved through
    :class:`~repro_torch.checkpoint.manager.CheckpointManager` (atomic
    tmp+rename, async, fsynced), so a crash at ANY point leaves the
    newest committed step restorable.  :meth:`load` gives the partials
    back as ``{task_id: {name: array}}``; the resumed job offers them
    into a full-size reduce tree and executes only the missing tasks —
    the tree's fixed shape makes the combined result bit-identical to
    an uninterrupted run.  The files are the reference's, so a job
    checkpointed by either package resumes in the other.

    ``injector`` is an optional
    :class:`~repro_torch.platform.faults.FaultInjector` whose
    :meth:`~repro_torch.platform.faults.FaultInjector.checkpoint_tick`
    fires planned mid-save crashes."""

    def __init__(self, directory: str, n_tasks: int, *, every: int = 8,
                 restored: Optional[Dict[int, Dict[str, Any]]] = None,
                 injector=None, keep: int = 2, telemetry=None):
        self.mgr = CheckpointManager(directory, keep=keep)
        self.n_tasks = n_tasks
        self.every = max(int(every), 1)
        self.injector = injector
        self.telemetry = telemetry
        self.saves = 0
        self.bytes_written = 0
        self._lock = threading.Lock()
        self._partials: Dict[int, Dict[str, Any]] = dict(restored or {})
        self._since = 0
        self._step = self.mgr.all_steps()[-1] if self.mgr.all_steps() \
            else 0

    def offer(self, task_id: int, value: Any) -> None:
        """Record one completed leaf; saves when a full interval of new
        leaves has accumulated.  The save snapshot is taken under the
        lock; serialization runs on the manager's background thread."""
        due = False
        with self._lock:
            if task_id not in self._partials:
                self._partials[task_id] = value
                self._since += 1
                if self._since >= self.every:
                    self._since = 0
                    self._step += 1
                    step = self._step
                    snap = dict(self._partials)
                    due = True
        if not due:
            return
        if self.injector is not None:
            self.injector.checkpoint_tick()
        state: Dict[str, np.ndarray] = {}
        for tid, partial in snap.items():
            for name, arr in partial.items():
                state[f"{tid}/{name}"] = np.asarray(arr)
        state["__meta__/completed"] = np.asarray(sorted(snap),
                                                 dtype=np.int64)
        state["__meta__/n_tasks"] = np.asarray(self.n_tasks,
                                               dtype=np.int64)
        self.mgr.save(step, state)
        self.saves += 1
        self.bytes_written += sum(a.nbytes for a in state.values())
        if self.telemetry is not None:
            self.telemetry.emit("checkpoint_saved", step=step,
                                n_leaves=len(snap))

    def finish(self) -> None:
        """Join the in-flight save and surface any parked background
        error (a failed async save must fail the job, never vanish)."""
        self.mgr.wait()

    @staticmethod
    def load(directory: str) -> Tuple[Dict[int, Dict[str, Any]],
                                      Optional[int]]:
        """Restore ``({task_id: partial}, n_tasks)`` from the newest
        committed checkpoint; ``({}, None)`` when none exists."""
        mgr = CheckpointManager(directory)
        flat = mgr.restore_latest()
        if flat is None:
            return {}, None
        partials: Dict[int, Dict[str, Any]] = {}
        n_tasks: Optional[int] = None
        for key, arr in flat.items():
            # names are JAX key paths of flat-dict keys: "['12/sum']"
            if key.startswith("['") and key.endswith("']"):
                key = key[2:-2]
            if key.startswith("__meta__/"):
                if key == "__meta__/n_tasks":
                    n_tasks = int(arr)
                continue
            tid, name = key.split("/", 1)
            partials.setdefault(int(tid), {})[name] = np.asarray(arr)
        return partials, n_tasks


class Platform:
    """The end-to-end driver.  ``datastore`` is an optional
    :class:`~repro_torch.core.datastore.ReplicatedDataStore`; ``map_fn``
    replaces the workload engine with a custom per-task callable
    ``(task, block, months, seed) -> partial`` (overhead benchmarks);
    ``fault_injector`` is an optional
    :class:`~repro_torch.platform.faults.FaultInjector` driving a seeded
    :class:`~repro_torch.platform.faults.FaultPlan` through the run
    (DESIGN.md §12).  ``spec.mesh_devices`` shards every wave over a
    wave mesh (DESIGN.md §11), bit-identical to the unsharded run."""

    def __init__(self, spec: PlatformSpec = PlatformSpec(), *,
                 datastore=None, map_fn: Optional[MapFn] = None,
                 fault_injector=None):
        self.device = pc.check_device(spec.device)
        self.spec = spec
        self.datastore = datastore
        self.map_fn = map_fn
        self.fault_injector = fault_injector
        # one bus per driver; the simulated backend emits virtual
        # timestamps, so its bus must not fall back to wall time
        self.telemetry = tel.TelemetryBus(
            tel.resolve_telemetry_config(spec.telemetry),
            virtual=(spec.backend == "simulated"))
        # SLO monitor (DESIGN.md §15): a tap-driven bus consumer, built
        # only when enabled — the default leaves the bus untapped (zero
        # new events, zero threads, bit-identical results)
        self.monitor: Optional[PlatformMonitor] = None
        if spec.monitor.enabled:
            self.monitor = PlatformMonitor(self.telemetry, spec.monitor,
                                           wave_capacity=spec.max_wave)

    # -- config plumbing -----------------------------------------------------
    def _platform_config(self) -> PlatformConfig:
        return resolve_platform_config(self.spec)

    def _n_exec_workers(self) -> int:
        if self.spec.backend == "simulated" and self.spec.sim_workers:
            return len(self.spec.sim_workers)
        return self.spec.n_workers

    def _scheduler_cfg(self, plat: PlatformConfig) -> sch.SchedulerConfig:
        if self.spec.scheduler is not None:
            return self.spec.scheduler
        return sch.SchedulerConfig(
            recovery=plat.recovery, seed=self.spec.seed,
            speculative=resolve_speculation(self.spec),
            straggler_factor=self.spec.straggler_factor,
            lease_seconds=self.spec.lease_seconds)

    def _backend(self, n_workers: Optional[int] = None) -> PlatformBackend:
        n = n_workers if n_workers is not None else self.spec.n_workers
        if self.spec.backend == "threaded":
            return ThreadedBackend(n)
        if self.spec.backend == "simulated":
            workers = (list(self.spec.sim_workers) if self.spec.sim_workers
                       else n)
            return SimulatedBackend(workers,
                                    compute_values=self.spec.compute_values,
                                    startup_scale=self.spec.startup_scale)
        raise ValueError(f"unknown backend {self.spec.backend!r}")

    def _wave_enabled(self, engine: str, workload) -> bool:
        return wave_enabled(self.spec, engine, workload,
                            has_map_fn=self.map_fn is not None)

    # -- the full data path --------------------------------------------------
    def run(self, samples: Dict[int, np.ndarray],
            months: Dict[int, np.ndarray], workload, *,
            resume_from: Optional[str] = None) -> JobReport:
        """Kneepoint → distribute → schedule/execute → streaming reduce.

        ``resume_from`` names a checkpoint directory written by a prior
        (interrupted) run of the same job: its committed leaf partials
        are restored into the reduce tree and only the missing tasks
        execute — bit-identical to an uninterrupted run (§12)."""
        spec = self.spec
        plat = self._platform_config()
        engine = ("custom" if self.map_fn is not None
                  else pc.resolve_engine(workload.statistic, spec.engine))
        phases: Dict[str, float] = {}
        # validated up front: balanced="on" without a datastore (and any
        # bad mode string) must error, never silently run FIFO
        balanced_on = balanced_enabled(spec, self.datastore is not None)

        # phases 1-2 — offline kneepoint (thesis §3.2: ≈3% of online
        # time; a custom map_fn is calibrated on itself, not the workload
        # engine), then partition + distribute onto the data plane
        plan = plan_job(samples, months, workload,
                        sizing=plat.task_sizing, engine=engine,
                        n_exec=self._n_exec_workers(),
                        knee_bytes=spec.knee_bytes,
                        kneepoint_sizes=spec.kneepoint_sizes,
                        map_fn=self.map_fn, device=self.device)
        phases["plan"] = plan.plan_seconds
        bus = self.telemetry
        bus.emit("job_planned", n_tasks=len(plan.tasks),
                 knee_bytes=plan.knee_bytes, engine=engine)
        if self.datastore is not None:
            self.datastore.telemetry = bus
            # worker-side block cache (DESIGN.md §14): attached once and
            # kept on the store across runs so repeat queries over the
            # same dataset hit warm blocks
            if spec.cache.enabled and self.datastore.cache is None:
                self.datastore.cache = BlockCache(spec.cache)
        if self.fault_injector is not None:
            self.fault_injector.telemetry = bus
        t0 = time.perf_counter()
        if self.datastore is not None:
            self.datastore.put_all({i: samples[i] for i in plan.ids})
            if balanced_on:
                # seed the per-node response-time EMAs (phase-1 probe of
                # the data plane) so the first claims are not blind
                self.datastore.probe()
        phases["distribute"] = (plan.partition_seconds
                                + time.perf_counter() - t0)
        tasks, ids, task_shape = plan.tasks, plan.ids, plan.task_shape

        # resume (DESIGN.md §12): restore committed leaf partials and
        # execute only the missing tasks; the tree keeps its full shape
        # so the combined result is bit-identical to an unbroken run
        restored: Dict[int, Dict[str, Any]] = {}
        if resume_from is not None:
            restored, ckpt_n = JobCheckpointer.load(resume_from)
            if ckpt_n is not None and ckpt_n != len(tasks):
                raise ValueError(
                    f"checkpoint at {resume_from!r} holds partials for "
                    f"{ckpt_n} tasks but this plan produced {len(tasks)}"
                    " — resume needs the same dataset, sizing and knee")
        run_tasks = ([t for t in tasks if t.task_id not in restored]
                     if restored else tasks)

        # SLO-aware pool sizing (slo.choose_workers over the knee-derived
        # throughput model); explicit sim worker lists are respected
        decision = (None if spec.sim_workers
                    else slo_worker_decision(spec, plat, plan))
        n_eff = decision.cores if decision is not None \
            else self._n_exec_workers()

        wave_on = self._wave_enabled(engine, workload)
        mesh = resolve_wave_mesh(spec, wave_on)
        # all dispatch accounting flows through the bus's aggregation
        # path into this one sink (DESIGN.md §13)
        dispatch = pc.DispatchStats()
        bus.bind_dispatch(dispatch)
        block_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        def compute_task(task: sch.Task):
            # warmup already built this task's block: reuse, don't rebuild
            cached = block_cache.pop(task.task_id, None)
            block, mo = cached if cached is not None else \
                plan.build_block(task)
            task_seed = spec.seed + task.task_id
            if self.map_fn is not None:
                return self.map_fn(task, block, mo, task_seed)
            if engine in ("kernel", "torch"):
                bus.emit("task_dispatched", task_id=task.task_id,
                         nbytes=float(block.nbytes) + (
                             float(mo.nbytes) if engine == "torch" else 0.0))
            return pc.run_map_task(block, mo, task_seed, workload, engine,
                                   device=self.device)

        fetch = None
        locality_score = None
        on_scheduler = None
        if self.datastore is not None:
            store = self.datastore

            # the fetch models the data plane only: blocks still come
            # from plan.build_block, and wave mode's arena stays resident
            def fetch(task: sch.Task):
                store.fetch_many([ids[sid] for sid in task.sample_ids])

            if balanced_on:
                def locality_score(task: sch.Task) -> float:
                    return store.predicted_task_fetch(
                        [ids[sid] for sid in task.sample_ids])

                def on_scheduler(live) -> None:
                    # a node turning degraded/down re-ranks ready tasks
                    store.on_state_change = \
                        lambda node: live.request_rerank()
                    # cache admissions/evictions shift locality scores
                    # the same way (DESIGN.md §14)
                    if store.cache is not None:
                        store.cache.on_change = \
                            lambda: live.request_rerank()
        prefetcher = (build_prefetcher(n_eff)
                      if prefetch_enabled(spec, fetch is not None)
                      else None)
        if prefetcher is not None and self.datastore is not None \
                and self.datastore.cache is not None:
            # cache-resident tasks need no background fetch: their
            # claim-time ensure() is served worker-side for free
            prefetcher.resident = (
                lambda task, _s=self.datastore, _ids=ids:
                _s.cache_covers([_ids[sid] for sid in task.sample_ids]))

        # phase 3 — warmup: one task per distinct block shape (the kernel
        # library builds at its first launch, which is startup cost, Fig
        # 5).  Wave mode packs the whole job into the device-resident block
        # arena here — one upload for the job — and warms one full-size
        # wave per shape; per-task mode builds one block per distinct shape
        # and caches it so phase 4 does not rebuild it (the numpy engine
        # skips warmup entirely: there is nothing to build).
        t0 = time.perf_counter()
        ctx: Optional[WaveContext] = None
        compute_wave = None
        if wave_on:
            ctx = build_wave_context(plan, workload,
                                     n_exec=n_eff,
                                     max_wave=spec.max_wave,
                                     warm_seed=spec.seed,
                                     device=self.device, mesh=mesh)
            bus.emit("arena_upload", nbytes=float(ctx.arena.nbytes))

            def compute_wave(batch: List[sch.Task]):
                seeds = np.asarray([spec.seed + t.task_id for t in batch],
                                   np.int32)
                t_wave = bus.now()
                values = ctx.run(batch, seeds)
                # the arena is resident; a wave uploads only its slot
                # and seed vectors
                bus.emit("wave_dispatched", ts=t_wave,
                         wave_size=len(batch),
                         nbytes=ctx.wave_bytes(len(batch)),
                         task_ids=tuple(t.task_id for t in batch),
                         seconds=bus.now() - t_wave)
                return values
        elif engine in ("kernel", "torch"):
            seen = set()
            for task in tasks:
                key = task_shape(task)
                if key not in seen:
                    seen.add(key)
                    block, mo = plan.build_block(task)
                    block_cache[task.task_id] = (block, mo)
                    pc.run_map_task(block, mo, spec.seed + task.task_id,
                                    workload, engine, device=self.device)
        phases["compile"] = time.perf_counter() - t0

        # phase 4 — execute; partials stream into the reduce tree.  With
        # an epsilon target (DESIGN.md §10) an estimator rides along: the
        # threaded combiner feeds it leaf by leaf, the simulator replays
        # the calibration partials in virtual completion order; either
        # way the backend's scheduler DRAINs once the CI converges.
        want_values = (spec.backend == "threaded" or spec.compute_values)
        statistic = getattr(workload, "statistic", "custom")
        approx = spec.epsilon is not None
        # validated before the tree exists: a constructor ValueError
        # below would leak the tree's combiner thread
        est_mod.validate_error_target(spec.epsilon, spec.confidence)
        if approx and not want_values:
            raise ValueError(
                "epsilon needs computed partials to estimate from; "
                "simulated specs must keep compute_values=True")
        tree, stopper, sim_partials = None, None, None
        emit: Callable[[int, Any], None] = lambda tid, v: None
        if want_values:
            if approx:
                estimator = est_mod.SubsampleEstimator(
                    statistic, spec.confidence)
                if spec.backend == "threaded":
                    tree = StreamingReduceTree(len(tasks),
                                               estimator=estimator)
                    emit = tree.offer
                    stopper = est_mod.StoppingController(
                        estimator, spec.epsilon, min_tasks=spec.min_tasks)
                else:
                    # calibration computes EVERY partial (that is how the
                    # simulator measures costs); capture them so the
                    # replay stopper observes only virtually-completed
                    # tasks and the final reduce covers only those
                    sim_partials = {}
                    tree = StreamingReduceTree(len(tasks))

                    def emit(tid, v, _offer=tree.offer,
                             _cap=sim_partials):
                        _cap[tid] = v
                        _offer(tid, v)

                    stopper = est_mod.ReplayStopper(
                        estimator, spec.epsilon, partials=sim_partials,
                        min_tasks=spec.min_tasks)
            else:
                tree = StreamingReduceTree(len(tasks))
                emit = tree.offer
        # restored leaves enter the tree (and any estimator) first,
        # exactly as if those tasks had just completed — BEFORE the
        # checkpoint/injector wraps so they neither re-save nor tick the
        # injector's completion clock
        for tid in sorted(restored):
            emit(tid, restored[tid])
        if restored:
            bus.emit("checkpoint_restored", n=len(restored),
                     task_ids=tuple(sorted(restored)))
        ckpt: Optional[JobCheckpointer] = None
        if spec.checkpoint_dir is not None and tree is not None:
            ckpt = JobCheckpointer(
                spec.checkpoint_dir, len(tasks),
                every=spec.checkpoint_every, restored=restored,
                injector=self.fault_injector, telemetry=bus)
            prev_emit = emit

            def emit(tid, v, _prev=prev_emit, _c=ckpt):
                _prev(tid, v)
                _c.offer(tid, v)

        injector = self.fault_injector
        if injector is not None:
            if self.datastore is not None:
                injector.attach_store(self.datastore)
            emit = injector.wrap_emit(emit)
        # execute-window anchor for the critical-path analyzer: bus time
        # just before the backend starts (0.0 on a virtual bus — the sim
        # clock opens at startup_time, so the window equals the virtual
        # makespan)
        t_execute = bus.now()
        t0 = time.perf_counter()
        try:
            outcome = self._backend(n_eff).run(
                run_tasks, compute=compute_task, fetch=fetch, plat=plat,
                cfg=self._scheduler_cfg(plat), emit=emit,
                shape_key=task_shape, compute_wave=compute_wave,
                max_wave=spec.max_wave if wave_on else 1,
                wave_cap=(ctx.cap if wave_on else None),
                locality_score=locality_score,
                prefetcher=prefetcher,
                on_scheduler=on_scheduler,
                stopper=stopper,
                crash_hook=(injector.worker_tick
                            if injector is not None else None),
                max_respawns=spec.max_respawns,
                telemetry=bus)
            phases["execute"] = time.perf_counter() - t0
            if ckpt is not None:
                # surface any parked async-save error: a job that "ran"
                # but silently failed to persist its restore point must
                # not report success (§12 durability contract)
                ckpt.finish()

            # phase 5 — drain the reduce tree, finalize the statistic.
            # An early-stopped job finalizes over its executed subset in
            # the same fixed tree order (deterministic for the set).
            t0 = time.perf_counter()
            result, reduce_info = None, None
            if tree is not None:
                if stopper is not None and stopper.stopped:
                    executed = ({r.task_id for r in outcome.results}
                                | set(restored))
                    if sim_partials is not None:
                        root = StreamingReduceTree.combine_subset(
                            len(tasks),
                            {tid: sim_partials[tid]
                             for tid in sorted(executed)})
                        tree.close()       # full-leaf stream, unused now
                    else:
                        tree.wait_leaves(len(executed), timeout=600.0)
                        root = tree.snapshot()
                        tree.close()
                    result = finalize_stats(root, statistic)
                else:
                    root = tree.result(timeout=600.0)
                    result = finalize_stats(root, statistic)
                reduce_info = tree.stats()
            phases["reduce"] = time.perf_counter() - t0
        except BaseException:
            if tree is not None:
                tree.close()           # unblock the combiner thread
            if ckpt is not None:
                # let the save in flight land before the error leaves
                # run(), so a resume reads a directory no thread still
                # writes; the job's own error is the one raised
                try:
                    ckpt.finish()
                except Exception as save_err:  # noqa: BLE001
                    warnings.warn(f"checkpoint save failed while the job "
                                  f"failed: {save_err!r}", RuntimeWarning)
            raise
        finally:
            if prefetcher is not None:
                stats = prefetcher.stats()
                bus.emit("prefetch_stats",
                         hits=int(stats["prefetch_hits"]),
                         misses=int(stats["prefetch_misses"]))
                prefetcher.close()
            if self.datastore is not None:
                self.datastore.on_state_change = None
                self.datastore.telemetry = None
                if self.datastore.cache is not None:
                    # the cache (and its contents) outlives the run; the
                    # rerank hook must not — it closes over this run's
                    # scheduler
                    self.datastore.cache.on_change = None

        if self.datastore is not None:
            for r in outcome.results:
                self.datastore.report_exec_time(r.exec_time)

        if stopper is not None:
            ci = stopper.snapshot()
            if ci is not None:
                bus.emit("ci_snapshot", **ci.as_dict())
        bus.emit("job_done", makespan=outcome.makespan,
                 tasks_executed=len({r.task_id for r in outcome.results}),
                 t_execute=t_execute,
                 startup_seconds=(plat.startup_time * spec.startup_scale
                                  if spec.backend == "simulated"
                                  else plat.startup_time),
                 reduce_seconds=phases.get("reduce", 0.0))
        return self._report(plat, outcome, tasks, plan.total_bytes,
                            plan.knee_bytes, plan.knee_res, engine, phases,
                            result, reduce_info, dispatch=dispatch,
                            scale_decision=decision, n_workers_used=n_eff,
                            prefetch_stats=(stats if prefetcher is not None
                                            else None),
                            stopper=stopper,
                            tasks_restored=len(restored),
                            checkpoint_saves=(ckpt.saves
                                              if ckpt is not None else 0),
                            checkpoint_bytes=(ckpt.bytes_written
                                              if ckpt is not None else 0),
                            fault_events=(len(injector.fired)
                                          if injector is not None else 0))

    # -- virtual-time scale-out over a cost model ----------------------------
    def run_scaleout(self, sample_sizes: Sequence[int], *,
                     per_sample_exec: Optional[float] = None,
                     exec_model: Optional[Callable[[sch.Task], float]] = None,
                     fetch_model: Optional[Callable[[sch.Task], float]] = None,
                     ) -> JobReport:
        """Run the scheduling/distribution layers in virtual time over a
        calibrated cost model (datasets too large to materialize: Fig
        10-13 sweeps).  No statistics are computed (``result=None``) and
        nothing runs on the device."""
        assert (per_sample_exec is None) != (exec_model is None), \
            "pass exactly one of per_sample_exec / exec_model"
        spec = self.spec
        plat = self._platform_config()
        decision = None
        if (spec.slo_seconds is not None and per_sample_exec is not None
                and not spec.sim_workers and len(sample_sizes)):
            # SLO-aware sizing from the calibrated cost model (Fig 12/13)
            mean_bytes = float(np.mean(np.asarray(sample_sizes)))
            decision = slo_mod.choose_workers(
                max(spec.n_workers, 1),
                bytes_per_second_per_worker=(mean_bytes
                                             / float(per_sample_exec)),
                startup_seconds=plat.startup_time * spec.startup_scale,
                slo_seconds=spec.slo_seconds)
        if exec_model is None:
            rate = float(per_sample_exec)
            exec_model = lambda t: rate * len(t.sample_ids)   # noqa: E731
        n_eff = decision.cores if decision is not None \
            else self._n_exec_workers()
        t0 = time.perf_counter()
        tasks = make_tasks(list(sample_sizes), plat.task_sizing,
                           spec.knee_bytes, n_eff)
        phases = {"plan": 0.0, "distribute": time.perf_counter() - t0,
                  "compile": 0.0}
        workers = (list(spec.sim_workers) if spec.sim_workers else n_eff)
        backend = SimulatedBackend(workers, exec_model=exec_model,
                                   fetch_model=fetch_model,
                                   startup_scale=spec.startup_scale)
        t0 = time.perf_counter()
        outcome = backend.run(tasks, compute=None, fetch=None, plat=plat,
                              cfg=self._scheduler_cfg(plat),
                              emit=lambda tid, v: None)
        phases["execute"] = time.perf_counter() - t0
        phases["reduce"] = 0.0
        return self._report(plat, outcome, tasks, float(sum(sample_sizes)),
                            spec.knee_bytes, None, "cost-model", phases,
                            None, None, backend_name="simulated",
                            scale_decision=decision, n_workers_used=n_eff)

    # -- monitor surface (DESIGN.md §15) -------------------------------------
    def monitor_snapshot(self) -> Dict[str, Any]:
        """SLIs, alerts, per-job critical paths, and ranked findings —
        requires ``monitor=MonitorOptions(enabled=True)`` on the spec."""
        if self.monitor is None:
            raise RuntimeError(
                "monitor disabled; construct the Platform with "
                "PlatformSpec(monitor=MonitorOptions(enabled=True))")
        return self.monitor.snapshot()

    def write_monitor_report(self, path: str,
                             title: str = "platform monitor") -> None:
        """Self-contained HTML: alert timeline + per-job critical-path
        waterfall (requires the monitor to be enabled)."""
        if self.monitor is None:
            raise RuntimeError(
                "monitor disabled; construct the Platform with "
                "PlatformSpec(monitor=MonitorOptions(enabled=True))")
        _write_monitor_report(self.monitor, path, title)

    # -- report assembly -----------------------------------------------------
    def _report(self, plat: PlatformConfig, outcome: BackendOutcome,
                tasks: List[sch.Task], total_bytes: float,
                knee_bytes: Optional[float],
                knee_res: Optional[kp.KneepointResult], engine: str,
                phases: Dict[str, float], result, reduce_info, *,
                backend_name: Optional[str] = None,
                dispatch: Optional[pc.DispatchStats] = None,
                scale_decision: Optional[slo_mod.ScaleDecision] = None,
                n_workers_used: Optional[int] = None,
                prefetch_stats: Optional[Dict[str, float]] = None,
                stopper=None,
                tasks_restored: int = 0,
                checkpoint_saves: int = 0,
                checkpoint_bytes: int = 0,
                fault_events: int = 0,
                ) -> JobReport:
        backend_name = backend_name or self.spec.backend
        dispatch = dispatch or pc.DispatchStats()
        execs = sorted(r.exec_time for r in outcome.results)
        median = execs[len(execs) // 2] if execs else 0.0
        stragglers = sum(1 for e in execs if median and e > 2.0 * median)
        executed = len({r.task_id for r in outcome.results})
        snap = stopper.snapshot() if stopper is not None else None
        return JobReport(
            platform=plat.name,
            n_tasks=len(tasks),
            task_size_bytes=(knee_bytes if knee_bytes is not None
                             else total_bytes / max(len(tasks), 1)),
            makespan=outcome.makespan,
            throughput_bps=total_bytes / max(outcome.makespan, 1e-12),
            startup_time=plat.startup_time * (
                self.spec.startup_scale
                if backend_name == "simulated" else 1.0),
            result=result,
            kneepoint=knee_res,
            backend=backend_name,
            engine=engine,
            phases=phases,
            queue_depths=outcome.queue_depths,
            miss_curve=knee_res.curve if knee_res is not None else (),
            max_task_bytes=max((t.size_bytes for t in tasks), default=0.0),
            stragglers=stragglers,
            speculative_launches=outcome.speculative_launches,
            restarts=outcome.restarts,
            calibration_seconds=outcome.calibration_seconds,
            datastore_stats=(self.datastore.stats()
                             if self.datastore is not None else None),
            reduce_info=reduce_info,
            device_dispatches=dispatch.device_dispatches,
            bytes_uploaded=dispatch.bytes_uploaded,
            wave_sizes=list(dispatch.wave_sizes),
            speculation_wins=outcome.speculation_wins,
            scale_decision=(f"{scale_decision.cores} cores: "
                            f"{scale_decision.reason}"
                            if scale_decision is not None else None),
            n_workers_used=(n_workers_used if n_workers_used is not None
                            else self._n_exec_workers()),
            prefetch_stats=prefetch_stats,
            cache_stats=(self.datastore.cache.stats()
                         if self.datastore is not None
                         and self.datastore.cache is not None else None),
            tasks_executed=executed + tasks_restored,
            tasks_cancelled=max(len(tasks) - executed - tasks_restored, 0),
            stop_reason=(stopper.stop_reason if stopper is not None
                         else None),
            final_ci=(snap.as_dict() if snap is not None else None),
            tasks_restored=tasks_restored,
            checkpoint_saves=checkpoint_saves,
            checkpoint_bytes=checkpoint_bytes,
            fault_events=fault_events)
