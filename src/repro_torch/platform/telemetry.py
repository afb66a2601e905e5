"""Unified platform telemetry (DESIGN.md §13): one event bus, one
aggregation path, trace spans, metrics snapshots, and reports.

The platform's runtime signals — node EMAs, queue depths, wave sizes,
CI half-widths, lease reclaims — used to live in ad-hoc carriers
(:class:`~repro_torch.platform.compute.DispatchStats` increments scattered
across driver/service closures, the scheduler's inline ``depth_trace``
appends, assorted ``JobReport`` fields) with no common timeline.  This
module replaces that with a **TelemetryBus**:

* every instrumented site calls :meth:`TelemetryBus.emit` with a typed
  event kind (see :data:`EVENT_KINDS`) and structured fields;
* the bus's **aggregation path** (:meth:`TelemetryBus._aggregate`) is
  ALWAYS on: it derives the deterministic counters the reports and the
  ``--compare`` gate depend on (device dispatches, bytes uploaded, wave
  sizes, prefetch hits, queue-depth traces) from the event stream — the
  single place those numbers are computed, whether telemetry recording
  is enabled or not;
* **recording** is opt-in (``TelemetryConfig(enabled=True)``): enabled,
  events land in a bounded ring buffer (``deque(maxlen=capacity)``) —
  disabled, the ring stays empty and emit() is a couple of dict updates,
  so results are bit-identical on/off (gated in
  ``benchmarks/bench_telemetry.py``).

On top of the recorded stream:

* :func:`build_trace` — per-task trace spans (queue→fetch→exec→reduce)
  as Chrome trace-event JSON loadable in Perfetto
  (https://ui.perfetto.dev), with wave dispatches linked to their member
  tasks as flow events;
* :class:`MetricsRegistry` — counters / gauges / fixed-bucket
  histograms, maintained by the aggregation path and snapshot via
  :meth:`MetricsRegistry.snapshot` (surface on
  ``PlatformService.telemetry_snapshot()``);
* :class:`TelemetrySampler` — a periodic time-series sampler (queue
  depth, per-node scores/states, worker utilization, inflight, CI
  half-width per epsilon job): the feed a future autoscaler consumes
  (ROADMAP item 5);
* :func:`render_report` — a dependency-free, self-contained HTML report
  per job / service session.

Clocks: the default timestamp is wall time relative to bus creation
(``time.perf_counter``).  The simulated backend runs in *virtual* time,
so its emit sites pass ``ts=`` explicitly and the bus is built with
``virtual=True`` — events emitted between virtual steps (e.g. the
calibration pass) inherit the last virtual timestamp instead of leaking
wall time, keeping per-seed event streams deterministic.
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
import threading
import time
from collections import Counter, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# event taxonomy (DESIGN.md §13.1)
# ---------------------------------------------------------------------------

EVENT_KINDS = frozenset((
    # task lifecycle (both schedulers)
    "task_claimed", "task_started", "task_settled",
    # device dispatches (driver + service compute closures)
    "task_dispatched", "wave_dispatched", "wave_settled", "arena_upload",
    "prefetch_stats",
    # data plane, per replica
    "fetch_start", "fetch_done", "fetch_failed", "node_state_change",
    # worker-side block cache (DESIGN.md §14)
    "cache_hit", "cache_miss", "cache_evict",
    # recovery layers
    "worker_crash", "worker_respawn", "lease_reclaimed",
    "checkpoint_saved", "checkpoint_restored", "fault_fired",
    # job / service lifecycle
    "job_planned", "job_admitted", "job_queued", "job_rejected",
    "job_draining", "job_degraded", "job_done", "job_failed",
    "job_cancelled",
    # error-bounded execution (§10)
    "ci_snapshot",
    # SLO monitor (DESIGN.md §15): burn-rate alert transitions
    "alert_raised", "alert_cleared",
    # sampler rows
    "sample",
))

# fixed histogram buckets (seconds) — powers of ~4 from 100 µs to 25 s;
# fixed so snapshots from different runs are mergeable/comparable
SECONDS_BUCKETS: Tuple[float, ...] = (
    1e-4, 4e-4, 1.6e-3, 6.4e-3, 2.56e-2, 1.024e-1, 4.096e-1, 1.638, 6.554,
    26.21)
# wave-size buckets: pow2 up to the widest supported wave
WAVE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Recording policy for one bus.  Frozen (and so hashable) because it
    rides inside the frozen ``PlatformSpec``.  ``enabled=False`` keeps
    the ring empty — the aggregation path still runs either way."""

    enabled: bool = False
    capacity: int = 65536          # ring-buffer bound (events AND samples)
    sample_every: float = 0.05     # sampler cadence, seconds

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.sample_every <= 0:
            raise ValueError(
                f"sample_every must be > 0, got {self.sample_every}")


def resolve_telemetry_config(value) -> TelemetryConfig:
    """Normalize a spec's ``telemetry`` field: ``None``/``False`` ⇒
    disabled, ``True``/``"on"`` ⇒ enabled defaults, or an explicit
    :class:`TelemetryConfig`."""
    if value is None or value is False:
        return TelemetryConfig(enabled=False)
    if value is True or value == "on":
        return TelemetryConfig(enabled=True)
    if isinstance(value, TelemetryConfig):
        return value
    raise ValueError(
        f"telemetry must be None, bool, 'on' or TelemetryConfig, "
        f"got {value!r}")


@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded event: a monotone sequence number, a timestamp in
    bus time (wall-relative or virtual), a kind from
    :data:`EVENT_KINDS`, and the emit site's structured fields."""

    seq: int
    ts: float
    kind: str
    fields: Dict[str, Any]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class MetricsRegistry:
    """Counters, gauges, and fixed-bucket histograms.  Thread-safe;
    maintained by the bus's aggregation path and usable directly."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # name -> (bucket uppers, per-bucket counts + overflow, sum, n)
        self._hists: Dict[str, Tuple[Tuple[float, ...], List[int],
                                     List[float]]] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float,
                buckets: Tuple[float, ...] = SECONDS_BUCKETS) -> None:
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = (
                    buckets, [0] * (len(buckets) + 1), [0.0, 0.0])
            uppers, counts, acc = hist
            i = 0
            while i < len(uppers) and value > uppers[i]:
                i += 1
            counts[i] += 1
            acc[0] += value
            acc[1] += 1

    def quantile(self, name: str, q: float) -> Optional[float]:
        """Estimate the ``q``-quantile (0..1) of histogram ``name`` by
        linear interpolation inside its fixed buckets (the
        ``histogram_quantile`` estimator): walk the cumulative counts to
        the bucket where rank ``q·n`` lands, then interpolate between
        that bucket's bounds.  Values in the overflow bucket clamp to
        the last finite upper bound.  ``None`` when the histogram is
        missing or empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                return None
            uppers, counts, acc = hist
            n = acc[1]
            if n <= 0:
                return None
            rank = q * n
            cum = 0.0
            for i, c in enumerate(counts):
                if c == 0:
                    continue
                if cum + c >= rank:
                    if i >= len(uppers):
                        return float(uppers[-1])
                    lo = uppers[i - 1] if i > 0 else 0.0
                    return float(lo + (uppers[i] - lo)
                                 * ((rank - cum) / c))
                cum += c
            return float(uppers[-1])

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    name: {"buckets": list(uppers),
                           "counts": list(counts),
                           "sum": acc[0], "count": int(acc[1])}
                    for name, (uppers, counts, acc) in self._hists.items()},
            }


# ---------------------------------------------------------------------------
# the bus
# ---------------------------------------------------------------------------


class TelemetryBus:
    """Thread-safe, bounded event bus with an always-on aggregation
    path.  One bus per run (driver) or per service session; schedulers,
    backends, the data plane, and the fault injector all emit into it.

    ``virtual=True`` marks a bus fed by the simulated backend: emit
    sites there pass explicit virtual timestamps, and events without one
    (e.g. the calibration pass) inherit the latest virtual ``ts`` so the
    recorded stream never mixes in wall time."""

    def __init__(self, config: Optional[TelemetryConfig] = None, *,
                 virtual: bool = False,
                 clock: Optional[Callable[[], float]] = None):
        self.config = resolve_telemetry_config(config)
        self.enabled = self.config.enabled
        self.virtual = virtual
        self._clock = clock
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._seq = 0
        self._last_ts = 0.0
        self._events: deque = deque(maxlen=self.config.capacity)
        self._samples: deque = deque(maxlen=self.config.capacity)
        self.metrics = MetricsRegistry()
        # bound deterministic-aggregate sinks (satellite: ONE aggregation
        # path).  ``dispatch`` is a DispatchStats-shaped object; ``depths``
        # the owning scheduler's queue-depth trace list.
        self._dispatch: Optional[Any] = None
        self._depths: Optional[List[int]] = None
        # live-stream subscribers (the SLO monitor): an immutable tuple
        # swapped under the lock, iterated without it — empty on the
        # default path so emit() stays a couple of dict updates
        self._taps: Tuple[Callable[[str, float, Dict[str, Any]], None],
                          ...] = ()

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        if self._clock is not None:
            return self._clock()
        if self.virtual:
            return self._last_ts
        return time.perf_counter() - self._t0

    # -- sinks ---------------------------------------------------------------
    def bind_dispatch(self, stats: Any) -> None:
        """Route dispatch-shaped aggregates (device_dispatches,
        bytes_uploaded, wave_sizes, prefetch hits/misses) into
        ``stats``."""
        with self._lock:
            self._dispatch = stats

    def bind_depths(self, depths: List[int]) -> None:
        """Route ``task_settled`` queue depths into the scheduler's
        trace list (the old inline ``depth_trace.append`` site)."""
        with self._lock:
            self._depths = depths

    # -- live-stream taps ----------------------------------------------------
    def add_tap(self, fn: Callable[[str, float, Dict[str, Any]], None]
                ) -> None:
        """Subscribe ``fn(kind, ts, fields)`` to every emitted event
        (recorded or not — the tap sees the stream even when the ring is
        disabled).  Taps run OUTSIDE the bus lock, so a tap may itself
        emit (the monitor's alert path) without deadlocking — but must
        then tolerate re-entrancy into its own callback."""
        with self._lock:
            self._taps = self._taps + (fn,)

    def remove_tap(self, fn: Callable[[str, float, Dict[str, Any]], None]
                   ) -> None:
        with self._lock:
            # equality, not identity: a bound method (the monitor's
            # ``self._on_event``) is a fresh object per attribute access
            self._taps = tuple(t for t in self._taps if t != fn)

    # -- emit ----------------------------------------------------------------
    def emit(self, kind: str, ts: Optional[float] = None,
             **fields: Any) -> None:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown telemetry event kind {kind!r}")
        with self._lock:
            if ts is not None:
                self._last_ts = ts
            self._aggregate(kind, fields)
            if self.enabled:
                self._seq += 1
                self._events.append(
                    Event(self._seq, self.now() if ts is None else ts,
                          kind, fields))
            taps = self._taps
            tap_ts = (ts if ts is not None
                      else (self.now() if taps else 0.0))
        for tap in taps:
            tap(kind, tap_ts, fields)

    # -- the ONE aggregation path -------------------------------------------
    def _aggregate(self, kind: str, f: Dict[str, Any]) -> None:
        """Deterministic counters derived from the event stream — always
        on, so reports and ``--compare`` metrics are identical whether
        recording is enabled or not.  Caller holds ``_lock``."""
        m = self.metrics
        d = self._dispatch
        if kind == "task_settled":
            m.inc("tasks_settled")
            depth = f.get("depth")
            if depth is not None and self._depths is not None:
                self._depths.append(depth)
            exec_s = f.get("exec_seconds")
            if exec_s is not None:
                m.observe("task_exec_seconds", exec_s)
            fetch_s = f.get("fetch_seconds")
            if fetch_s:
                m.observe("task_fetch_seconds", fetch_s)
        elif kind == "task_claimed":
            m.inc("tasks_claimed", float(len(f.get("task_ids", ())) or 1))
        elif kind == "task_dispatched":
            m.inc("device_dispatches")
            if d is not None:
                d.device_dispatches += 1
                d.bytes_uploaded += f.get("nbytes", 0.0)
        elif kind == "wave_dispatched":
            m.inc("device_dispatches")
            m.observe("wave_size", float(f.get("wave_size", 1)),
                      buckets=WAVE_BUCKETS)
            if d is not None:
                d.device_dispatches += 1
                d.wave_sizes.append(f["wave_size"])
                d.bytes_uploaded += f.get("nbytes", 0.0)
        elif kind == "arena_upload":
            m.inc("bytes_uploaded", f.get("nbytes", 0.0))
            if d is not None:
                d.bytes_uploaded += f.get("nbytes", 0.0)
        elif kind == "prefetch_stats":
            if d is not None:
                d.prefetch_hits += int(f.get("hits", 0))
                d.prefetch_misses += int(f.get("misses", 0))
        elif kind == "fetch_done":
            m.inc("fetches")
            took = f.get("took")
            if took is not None:
                m.observe("fetch_seconds", took)
        elif kind == "fetch_failed":
            m.inc("fetch_failures")
        elif kind == "cache_hit":
            m.inc("cache_hits")
        elif kind == "cache_miss":
            m.inc("cache_misses")
        elif kind == "cache_evict":
            m.inc("cache_evictions")
        elif kind == "node_state_change":
            m.inc("node_state_changes")
        elif kind == "worker_crash":
            m.inc("worker_crashes")
        elif kind == "worker_respawn":
            m.inc("worker_respawns")
        elif kind == "lease_reclaimed":
            m.inc("leases_reclaimed", float(f.get("n", 1)))
        elif kind == "checkpoint_saved":
            m.inc("checkpoint_saves")
        elif kind == "checkpoint_restored":
            m.inc("tasks_restored", float(f.get("n", 0)))
        elif kind == "fault_fired":
            m.inc("faults_fired")
        elif kind.startswith("job_"):
            m.inc(kind.replace("job_", "jobs_"))
        elif kind == "ci_snapshot":
            hw = f.get("half_width")
            if hw is not None:
                m.set_gauge("ci_half_width", hw)
        elif kind == "alert_raised":
            m.inc("alerts_raised")
        elif kind == "alert_cleared":
            m.inc("alerts_cleared")

    # -- record a sampler row ------------------------------------------------
    def record_sample(self, row: Dict[str, Any],
                      ts: Optional[float] = None) -> None:
        ts = self.now() if ts is None else ts
        for key, value in row.items():
            if isinstance(value, (int, float)):
                self.metrics.set_gauge(key, float(value))
        if not self.enabled:
            return
        with self._lock:
            self._samples.append(dict(row, ts=ts))
        self.emit("sample", ts=ts, **row)

    # -- read side -----------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Event]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def samples(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._samples)

    def counts_by_kind(self) -> Dict[str, int]:
        return dict(Counter(e.kind for e in self.events()))

    def snapshot(self) -> Dict[str, Any]:
        """The ``status_monitor``-style view: aggregate metrics plus
        ring occupancy and the tail of the sampler's time series."""
        samples = self.samples()
        return {
            "enabled": self.enabled,
            "events_recorded": len(self.events()),
            "events_by_kind": self.counts_by_kind(),
            "capacity": self.config.capacity,
            "metrics": self.metrics.snapshot(),
            "samples": samples[-256:],
        }


def null_bus() -> TelemetryBus:
    """A fresh disabled bus: the default no-op sink.  Fresh (not a
    shared singleton) because callers bind per-run aggregate sinks onto
    their bus."""
    return TelemetryBus(TelemetryConfig(enabled=False))


# ---------------------------------------------------------------------------
# periodic time-series sampler
# ---------------------------------------------------------------------------


class TelemetrySampler:
    """Samples registered providers every ``bus.config.sample_every``
    seconds onto the bus — queue depth, node scores/states, worker
    utilization, inflight, per-job CI half-width: the time-series feed
    an autoscaler consumes.  Providers are callables returning a flat
    dict; a raising provider is skipped for that tick."""

    def __init__(self, bus: TelemetryBus):
        self.bus = bus
        self._providers: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_provider(self, name: str,
                     fn: Callable[[], Dict[str, Any]]) -> None:
        self._providers[name] = fn

    def sample_once(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {}
        for name, fn in list(self._providers.items()):
            try:
                for key, value in fn().items():
                    row[f"{name}.{key}"] = value
            except Exception:       # noqa: BLE001 — observability only
                continue
        if row:
            self.bus.record_sample(row)
        return row

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self._thread is not None or not self.bus.enabled:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.bus.config.sample_every):
                self.sample_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="telemetry-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)
            if self.bus.enabled:
                # final flush: a job shorter than one sample_every tick
                # still contributes at least one time-series row
                self.sample_once()


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto)
# ---------------------------------------------------------------------------

_US = 1e6          # trace-event timestamps are microseconds


def _span(name: str, ts: float, dur: float, tid: Any, *,
          pid: int = 1, cat: str = "task",
          args: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    ev = {"name": name, "ph": "X", "cat": cat, "pid": pid, "tid": tid,
          "ts": round(ts * _US, 3), "dur": round(max(dur, 0.0) * _US, 3)}
    if args:
        ev["args"] = args
    return ev


def build_trace(events: Sequence[Event]) -> Dict[str, Any]:
    """Per-task trace spans from a recorded event stream, as a Chrome
    trace-event JSON object (load the dumped file in Perfetto or
    ``chrome://tracing``).

    Span model (DESIGN.md §13.2): each settled task becomes a stack of
    complete ("X") slices on its worker's track — ``queue`` (claim →
    compute start), ``fetch`` and ``exec`` back-derived from the settle
    event's measured phase seconds — plus an instant on the reduce track
    when its partial enters the tree.  Wave dispatches get their own
    track and a flow ("s"/"f") edge to every member task's slice, so
    Perfetto draws the dispatch fan-out."""
    trace: List[Dict[str, Any]] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "repro_torch.platform"}},
    ]
    # claim ts per task: (job_id, task_id) -> (ts, worker)
    claims: Dict[Tuple[Any, Any], Tuple[float, Any]] = {}
    wave_of: Dict[Tuple[Any, Any], int] = {}
    for e in events:
        key_ids = e.fields.get("task_ids")
        job = e.fields.get("job_id")
        if e.kind == "task_claimed" and key_ids is not None:
            for tid in key_ids:
                claims[(job, tid)] = (e.ts, e.fields.get("worker"))
        elif e.kind == "wave_dispatched" and key_ids is not None:
            # fused multi-job waves carry a job_ids tuple aligned with
            # task_ids; single-job waves carry one job_id (or none)
            jobs = e.fields.get("job_ids")
            for i, tid in enumerate(key_ids):
                j = (jobs[i] if jobs is not None and i < len(jobs)
                     else job)
                wave_of[(j, tid)] = e.seq
            trace.append(_span(
                f"wave×{e.fields.get('wave_size', len(key_ids))}",
                e.ts, e.fields.get("seconds", 0.0), "waves", cat="wave",
                args={k: v for k, v in e.fields.items()
                      if k != "task_ids"}))
            trace.append({"name": "wave", "ph": "s", "cat": "wave",
                          "id": e.seq, "pid": 1, "tid": "waves",
                          "ts": round(e.ts * _US, 3)})
    for e in events:
        if e.kind != "task_settled":
            continue
        job = e.fields.get("job_id")
        tid = e.fields.get("task_id")
        worker = e.fields.get("worker")
        exec_s = float(e.fields.get("exec_seconds") or 0.0)
        fetch_s = float(e.fields.get("fetch_seconds") or 0.0)
        claim_ts, claim_worker = claims.get((job, tid), (None, None))
        worker = worker if worker is not None else claim_worker
        track = f"worker {worker}" if worker is not None else "tasks"
        name = (f"j{job}/t{tid}" if job is not None else f"task {tid}")
        settle_ts = e.ts
        exec_start = settle_ts - exec_s
        fetch_start = exec_start - fetch_s
        if claim_ts is not None:
            fetch_start = max(fetch_start, claim_ts)
            exec_start = max(exec_start, fetch_start)
            trace.append(_span(f"{name}:queue", claim_ts,
                               fetch_start - claim_ts, track, cat="queue"))
        args = {k: v for k, v in e.fields.items() if k != "task_ids"}
        trace.append(_span(name, min(fetch_start, settle_ts),
                           settle_ts - min(fetch_start, settle_ts), track,
                           args=args))
        if fetch_s:
            trace.append(_span(f"{name}:fetch", fetch_start, fetch_s,
                               track, cat="fetch"))
        trace.append(_span(f"{name}:exec", exec_start,
                           settle_ts - exec_start, track, cat="exec"))
        wave_seq = wave_of.get((job, tid))
        if wave_seq is not None:
            trace.append({"name": "wave", "ph": "f", "bp": "e",
                          "cat": "wave", "id": wave_seq, "pid": 1,
                          "tid": track, "ts": round(settle_ts * _US, 3)})
    for e in events:
        if e.kind in ("checkpoint_saved", "checkpoint_restored",
                      "worker_crash", "worker_respawn", "lease_reclaimed",
                      "node_state_change", "fault_fired", "job_draining"):
            trace.append({"name": e.kind, "ph": "i", "s": "g",
                          "cat": "platform", "pid": 1, "tid": "events",
                          "ts": round(e.ts * _US, 3),
                          "args": dict(e.fields)})
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def write_trace(bus: TelemetryBus, path: str) -> Dict[str, Any]:
    """Dump the bus's recorded stream as a Perfetto-loadable trace."""
    trace = build_trace(bus.events())
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace


# ---------------------------------------------------------------------------
# self-contained HTML report
# ---------------------------------------------------------------------------

_REPORT_CSS = """
body{font-family:system-ui,sans-serif;margin:2em;color:#222}
h1{font-size:1.4em}h2{font-size:1.1em;margin-top:1.6em}
table{border-collapse:collapse;margin:0.5em 0}
td,th{border:1px solid #ccc;padding:0.25em 0.6em;text-align:right}
th{background:#f3f3f3}td:first-child,th:first-child{text-align:left}
.spark{stroke:#36c;fill:none;stroke-width:1.5}
small{color:#777}
"""


def _table(rows: Sequence[Tuple[Any, ...]], headers: Tuple[str, ...]) -> str:
    def cell(v: Any) -> str:
        if isinstance(v, float):
            v = f"{v:.6g}"
        return _html.escape(str(v))

    out = ["<table><tr>"]
    out += [f"<th>{_html.escape(h)}</th>" for h in headers]
    out.append("</tr>")
    for row in rows:
        out.append("<tr>" + "".join(f"<td>{cell(v)}</td>" for v in row)
                   + "</tr>")
    out.append("</table>")
    return "".join(out)


def _sparkline(values: Sequence[float], width: int = 480,
               height: int = 60) -> str:
    if not values:
        return "<small>no samples</small>"
    top = max(max(values), 1e-12)
    n = max(len(values) - 1, 1)
    pts = " ".join(
        f"{i * width / n:.1f},{height - (v / top) * (height - 4):.1f}"
        for i, v in enumerate(values))
    return (f'<svg width="{width}" height="{height}">'
            f'<polyline class="spark" points="{pts}"/></svg>'
            f"<small> max={top:.4g}</small>")


def render_report(bus: TelemetryBus, title: str = "platform telemetry"
                  ) -> str:
    """A dependency-free, self-contained HTML report: metrics, event
    taxonomy counts, and the sampler's time series."""
    snap = bus.snapshot()
    metrics = snap["metrics"]
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(title)}</title>",
        f"<style>{_REPORT_CSS}</style></head><body>",
        f"<h1>{_html.escape(title)}</h1>",
        f"<small>events recorded: {snap['events_recorded']} "
        f"(ring capacity {snap['capacity']}, "
        f"telemetry {'on' if snap['enabled'] else 'off'})</small>",
        "<h2>Counters</h2>",
        _table(sorted(metrics["counters"].items()), ("counter", "value")),
        "<h2>Gauges</h2>",
        _table(sorted(metrics["gauges"].items()), ("gauge", "value")),
    ]
    if metrics["histograms"]:
        # quantiles interpolated from the fixed buckets, not raw bucket
        # dumps: the p50/p95/p99 view SLO policies are written against
        parts.append("<h2>Histogram quantiles</h2>")
        hist_rows = []
        for name, h in sorted(metrics["histograms"].items()):
            mean = h["sum"] / h["count"] if h["count"] else 0.0
            qs = (bus.metrics.quantile(name, q)
                  for q in (0.5, 0.9, 0.95, 0.99))
            hist_rows.append(
                (name, h["count"], f"{mean:.4g}",
                 *(f"{v:.4g}" if v is not None else "—" for v in qs)))
        parts.append(_table(
            hist_rows,
            ("histogram", "n", "mean", "p50", "p90", "p95", "p99")))
    if snap["events_by_kind"]:
        parts.append("<h2>Events by kind</h2>")
        parts.append(_table(sorted(snap["events_by_kind"].items()),
                            ("kind", "count")))
    samples = snap["samples"]
    if samples:
        parts.append("<h2>Time series</h2>")
        keys = sorted({k for row in samples for k in row
                       if k != "ts" and isinstance(row.get(k),
                                                   (int, float))})
        for key in keys:
            series = [float(row[key]) for row in samples if key in row]
            parts.append(f"<h3>{_html.escape(key)}</h3>")
            parts.append(_sparkline(series))
    parts.append("</body></html>")
    return "".join(parts)


def write_report(bus: TelemetryBus, path: str,
                 title: str = "platform telemetry") -> None:
    with open(path, "w") as fh:
        fh.write(render_report(bus, title))
