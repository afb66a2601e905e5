"""SLO monitor, critical-path analyzer, and root-cause diagnosis on the
telemetry bus (DESIGN.md §15).

The telemetry *producer* is :class:`~repro_torch.platform.telemetry.
TelemetryBus` (trace spans, the sampler, the HTML report).  This module
is its consumer: a stdlib-only
diagnosis layer that taps the bus live (``bus.add_tap``) and derives

* **SLIs** — a windowed :class:`TimeSeriesStore` fed from the event
  stream (queue depth, wave occupancy, cache hit ratio, per-node
  state, epsilon-job CI half-width) plus job-latency p50/p95/p99 via
  :meth:`~repro_torch.platform.telemetry.MetricsRegistry.quantile`;
* **SLO burn-rate alerts** — :class:`SLOPolicy` evaluates each
  :class:`SLO` over a fast (5 s) and a slow (60 s) window and emits
  structured ``alert_raised`` / ``alert_cleared`` events back through
  the bus taxonomy.  On the simulated backend the bus is virtual, so
  the windows are in *virtual* time for free (event ``ts`` is the
  clock — the policy never reads wall time);
* **critical-path attribution** — :meth:`PlatformMonitor.critical_path`
  folds the telemetry span chain (claim → fetch → exec → settle) into
  per-job phase seconds: walk backward from the last settle, charge
  each chain link's measured ``exec``/``fetch`` seconds (with the same
  monotone clamping ``build_trace`` uses), charge inter-link gaps to
  ``queue`` and the pre-first-claim head to ``startup``.  The phases
  partition the execute window, so ``startup+queue+fetch+exec+reduce``
  reconstructs the job makespan (gated within 5% in
  ``benchmarks/bench_monitor.py`` on both backends);
* **root-cause findings** — :meth:`PlatformMonitor.diagnose` runs
  symptom-based rules (never the ``fault_fired`` oracle) and returns
  ranked structured findings: degraded/down node, slow node, worker
  crash/respawn churn, lease-reclaim storm, cache thrash, admission
  shedding.  Accuracy is validated against the reference's seeded
  :class:`~repro_torch.platform.faults.FaultPlan` s: every injected
  node-kill / worker-crash / latency-spike must be named, and clean
  runs must produce zero findings.

The monitor owns **no threads**: it is entirely tap-driven, and with
``MonitorOptions(enabled=False)`` (the default) no tap is registered —
the bus fast path is untouched and results stay bit-identical.
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
import statistics
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.platform.telemetry import (
    _REPORT_CSS,
    _table,
    MetricsRegistry,
    TelemetryBus,
)

# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLO:
    """One service-level objective over an SLI time series: a violation
    is a sample ``above`` (or ``below``) ``threshold``; the alert fires
    when the violating *fraction* of both burn windows reaches
    ``burn_threshold`` (multi-window burn-rate alerting — a lone
    transient in the fast window cannot page)."""

    sli: str
    threshold: float
    mode: str = "above"
    burn_threshold: float = 0.5
    description: str = ""

    def __post_init__(self):
        if self.mode not in ("above", "below"):
            raise ValueError(
                f"SLO mode must be 'above' or 'below', got {self.mode!r}")
        if not 0.0 < self.burn_threshold <= 1.0:
            raise ValueError(f"burn_threshold must be in (0, 1], got "
                             f"{self.burn_threshold}")

    @property
    def key(self) -> str:
        op = ">" if self.mode == "above" else "<"
        return f"{self.sli}{op}{self.threshold:g}"

    def violates(self, value: float) -> bool:
        if self.mode == "above":
            return value > self.threshold
        return value < self.threshold


# any DOWN data node, or a ready-queue backlog beyond what the widest
# supported wave can drain in a few dispatches
DEFAULT_SLOS: Tuple[SLO, ...] = (
    SLO("nodes_down", 0.0, "above", description="a data node is DOWN"),
    SLO("queue_depth", 512.0, "above",
        description="ready-queue backlog is not draining"),
)


@dataclasses.dataclass(frozen=True)
class MonitorOptions:
    """The ``monitor`` option group on ``PlatformSpec`` (grouped-options
    pattern, DESIGN.md §11).  Disabled by default: no tap, no threads,
    zero new events, bit-identical results."""

    enabled: bool = False
    # burn-rate windows (seconds of bus time — virtual on the simulated
    # backend, wall otherwise)
    fast_window: float = 5.0
    slow_window: float = 60.0
    # alert when job-latency p95 exceeds this (seconds); None ⇒ no
    # latency SLO
    latency_slo_seconds: Optional[float] = None
    # extra SLOs layered on top of DEFAULT_SLOS
    slos: Tuple[SLO, ...] = ()
    top_k_stragglers: int = 3
    history: int = 4096            # per-series time-series bound
    # diagnosis rule thresholds
    slow_node_factor: float = 3.0  # node median fetch ≥ factor × peers
    slow_node_min_samples: int = 2
    slow_node_min_excess: float = 1e-3   # …and ≥ this absolute excess (s)
    lease_storm_threshold: int = 5
    worker_churn_threshold: int = 1
    cache_thrash_ratio: float = 0.5      # evictions / lookups
    cache_thrash_min_lookups: int = 32

    def __post_init__(self):
        object.__setattr__(self, "slos", tuple(self.slos))
        if self.fast_window <= 0 or self.slow_window <= 0:
            raise ValueError("burn windows must be > 0")
        if self.history < 16:
            raise ValueError(f"history must be >= 16, got {self.history}")


def resolve_monitor_options(value) -> MonitorOptions:
    """Normalize a spec's ``monitor`` field: ``None``/``False`` ⇒
    disabled, ``True``/``"on"`` ⇒ enabled defaults, or an explicit
    :class:`MonitorOptions`."""
    if value is None or value is False:
        return MonitorOptions()
    if value is True or value == "on":
        return MonitorOptions(enabled=True)
    if isinstance(value, MonitorOptions):
        return value
    raise ValueError(f"monitor must be None, bool, 'on' or MonitorOptions, "
                     f"got {value!r}")


# ---------------------------------------------------------------------------
# windowed time-series store
# ---------------------------------------------------------------------------


class TimeSeriesStore:
    """Bounded per-series ``(ts, value)`` windows.  Thread-safe; the
    SLI substrate the burn-rate policy and the report read."""

    def __init__(self, maxlen: int = 4096):
        self.maxlen = maxlen
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}

    def add(self, name: str, ts: float, value: float) -> None:
        with self._lock:
            series = self._series.get(name)
            if series is None:
                series = self._series[name] = deque(maxlen=self.maxlen)
            series.append((float(ts), float(value)))

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def latest(self, name: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            series = self._series.get(name)
            return series[-1] if series else None

    def window(self, name: str, start: float,
               end: Optional[float] = None) -> List[Tuple[float, float]]:
        """Points with ``start <= ts <= end`` (newest-bounded scan: the
        deque is appended in arrival order, so walk from the right)."""
        with self._lock:
            series = self._series.get(name)
            if not series:
                return []
            out = []
            for ts, v in reversed(series):
                if end is not None and ts > end:
                    continue
                if ts < start:
                    break
                out.append((ts, v))
        out.reverse()
        return out

    def burn_fraction(self, slo: SLO, start: float,
                      end: float) -> Optional[float]:
        """Fraction of the window's samples violating ``slo`` — the
        burn rate over that window.  ``None`` when the window holds no
        data (no evidence either way: the policy holds state)."""
        pts = self.window(slo.sli, start, end)
        if not pts:
            return None
        bad = sum(1 for _, v in pts if slo.violates(v))
        return bad / len(pts)


# ---------------------------------------------------------------------------
# multi-window burn-rate alerting
# ---------------------------------------------------------------------------


class SLOPolicy:
    """Evaluates every :class:`SLO` against the store on a fast and a
    slow window; a raise needs BOTH windows burning (classic
    multi-window burn-rate alerting), a clear needs only the fast
    window to recover.  Transitions emit ``alert_raised`` /
    ``alert_cleared`` through the owning bus."""

    def __init__(self, slos: Tuple[SLO, ...], store: TimeSeriesStore, *,
                 fast_window: float = 5.0, slow_window: float = 60.0,
                 bus: Optional[TelemetryBus] = None):
        self.slos = tuple(slos)
        self.store = store
        self.fast_window = fast_window
        self.slow_window = slow_window
        self.bus = bus
        self._lock = threading.Lock()
        self._active: Dict[str, Dict[str, Any]] = {}
        self._history: List[Dict[str, Any]] = []

    def active(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._active.values()]

    def history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._history]

    def evaluate(self, ts: float) -> None:
        """Re-judge every SLO at bus time ``ts`` (called from the
        monitor's tap — ``ts`` is virtual on the simulated backend, so
        the burn windows are too)."""
        transitions = []
        with self._lock:
            for slo in self.slos:
                fast = self.store.burn_fraction(
                    slo, ts - self.fast_window, ts)
                if fast is None:
                    continue                 # no data: hold state
                slow = self.store.burn_fraction(
                    slo, ts - self.slow_window, ts)
                firing = (fast >= slo.burn_threshold
                          and (slow or 0.0) >= slo.burn_threshold)
                rec = self._active.get(slo.key)
                if firing and rec is None:
                    rec = {"alert": slo.key, "sli": slo.sli,
                           "threshold": slo.threshold, "mode": slo.mode,
                           "description": slo.description,
                           "raised_ts": ts, "cleared_ts": None,
                           "fast_burn": fast, "slow_burn": slow or 0.0}
                    self._active[slo.key] = rec
                    self._history.append(rec)
                    transitions.append(("alert_raised", dict(rec)))
                elif rec is not None:
                    rec["fast_burn"] = fast
                    rec["slow_burn"] = slow or 0.0
                    if fast < slo.burn_threshold:
                        rec["cleared_ts"] = ts
                        del self._active[slo.key]
                        transitions.append(("alert_cleared", dict(rec)))
        bus = self.bus
        if bus is None:
            return
        for kind, rec in transitions:
            bus.emit(kind, ts=ts, alert=rec["alert"], sli=rec["sli"],
                     threshold=rec["threshold"],
                     fast_burn=rec["fast_burn"],
                     slow_burn=rec["slow_burn"])


# ---------------------------------------------------------------------------
# the monitor
# ---------------------------------------------------------------------------

_STATE_CODE = {"healthy": 0.0, "degraded": 1.0, "down": 2.0}
_SEVERITY_RANK = {"critical": 0, "high": 1, "warning": 2}


class PlatformMonitor:
    """Tap-driven consumer of one :class:`TelemetryBus`: SLIs, SLO
    alerts, critical-path attribution, and root-cause diagnosis.  One
    monitor per driver run or service session; detach with
    :meth:`close` (idempotent)."""

    def __init__(self, bus: TelemetryBus,
                 options: Optional[MonitorOptions] = None, *,
                 wave_capacity: Optional[int] = None):
        self.bus = bus
        self.options = options or MonitorOptions(enabled=True)
        self.wave_capacity = wave_capacity
        self.store = TimeSeriesStore(maxlen=self.options.history)
        # the monitor's own registry: job-latency quantiles must not
        # pollute the bus's deterministic --compare metrics
        self.metrics = MetricsRegistry()
        slos = list(DEFAULT_SLOS) + list(self.options.slos)
        if self.options.latency_slo_seconds is not None:
            slos.append(SLO("job_latency_p95",
                            self.options.latency_slo_seconds, "above",
                            description="job latency p95 over SLO"))
        self.policy = SLOPolicy(
            tuple(slos), self.store,
            fast_window=self.options.fast_window,
            slow_window=self.options.slow_window, bus=bus)
        self._lock = threading.Lock()
        # span substrate for the critical-path analyzer
        self._claims: Dict[Tuple[Any, Any], Tuple[float, Any]] = {}
        self._settles: Dict[Any, List[Tuple[float, Any, Any, float,
                                            float]]] = {}
        self._job_meta: Dict[Any, Dict[str, Any]] = {}
        # diagnosis substrate
        self._node_state: Dict[Any, str] = {}
        self._node_tooks: Dict[Any, deque] = {}
        self._worker_crashes: Dict[Any, int] = {}
        self._worker_respawns: Dict[Any, int] = {}
        self._leases_reclaimed = 0
        self._lease_events = 0
        self._cache = {"hits": 0, "misses": 0, "evictions": 0}
        self._rejected: List[Dict[str, Any]] = []
        self._queued: List[Dict[str, Any]] = []
        self._faults_seen: List[Dict[str, Any]] = []   # report context only
        self._events_seen = 0
        self._closed = False
        bus.add_tap(self._on_event)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.bus.remove_tap(self._on_event)

    # -- tap -----------------------------------------------------------------
    def _on_event(self, kind: str, ts: float,
                  f: Dict[str, Any]) -> None:
        # the policy emits alerts from inside this tap; ignoring them
        # here (before taking the lock) breaks the re-entrancy cycle
        if kind in ("alert_raised", "alert_cleared"):
            return
        store = self.store
        with self._lock:
            self._events_seen += 1
            if kind == "task_claimed":
                worker = f.get("worker")
                job = f.get("job_id")
                for tid in (f.get("task_ids") or ()):
                    self._claims[(job, tid)] = (ts, worker)
            elif kind == "task_settled":
                job = f.get("job_id")
                self._settles.setdefault(job, []).append(
                    (ts, f.get("task_id"), f.get("worker"),
                     float(f.get("fetch_seconds") or 0.0),
                     float(f.get("exec_seconds") or 0.0)))
                depth = f.get("depth")
                if depth is not None:
                    store.add("queue_depth", ts, float(depth))
            elif kind == "wave_dispatched":
                size = float(f.get("wave_size", 1))
                if self.wave_capacity:
                    store.add("wave_occupancy", ts,
                              size / float(self.wave_capacity))
                store.add("wave_size", ts, size)
            elif kind in ("cache_hit", "cache_miss", "cache_evict"):
                key = {"cache_hit": "hits", "cache_miss": "misses",
                       "cache_evict": "evictions"}[kind]
                self._cache[key] += 1
                lookups = self._cache["hits"] + self._cache["misses"]
                if lookups:
                    store.add("cache_hit_ratio", ts,
                              self._cache["hits"] / lookups)
            elif kind == "node_state_change":
                node = f.get("node")
                state = f.get("state", "healthy")
                self._node_state[node] = state
                store.add(f"node{node}.state_code", ts,
                          _STATE_CODE.get(state, 0.0))
                store.add("nodes_down", ts, float(sum(
                    1 for s in self._node_state.values() if s == "down")))
            elif kind == "fetch_done":
                node = f.get("node")
                took = f.get("took")
                if took is not None:
                    tooks = self._node_tooks.get(node)
                    if tooks is None:
                        tooks = self._node_tooks[node] = deque(maxlen=512)
                    tooks.append(float(took))
            elif kind == "worker_crash":
                w = f.get("worker")
                self._worker_crashes[w] = self._worker_crashes.get(w, 0) + 1
            elif kind == "worker_respawn":
                w = f.get("worker")
                self._worker_respawns[w] = (
                    self._worker_respawns.get(w, 0) + 1)
            elif kind == "lease_reclaimed":
                self._leases_reclaimed += int(f.get("n", 1))
                self._lease_events += 1
            elif kind == "job_rejected":
                self._rejected.append(dict(f, ts=ts))
            elif kind == "job_queued":
                self._queued.append(dict(f, ts=ts))
            elif kind in ("job_done", "job_failed"):
                job = f.get("job_id")
                meta = self._job_meta.setdefault(job, {})
                meta["status"] = kind
                for key in ("makespan", "t_execute", "startup_seconds",
                            "reduce_seconds", "tasks_executed"):
                    if f.get(key) is not None:
                        meta[key] = f[key]
                makespan = f.get("makespan")
                if makespan is not None:
                    self.metrics.observe("job_latency_seconds",
                                         float(makespan))
                    for q, name in ((0.5, "job_latency_p50"),
                                    (0.95, "job_latency_p95"),
                                    (0.99, "job_latency_p99")):
                        val = self.metrics.quantile(
                            "job_latency_seconds", q)
                        if val is not None:
                            store.add(name, ts, val)
            elif kind == "ci_snapshot":
                hw = f.get("half_width")
                if hw is not None:
                    store.add("ci_half_width", ts, float(hw))
            elif kind == "fault_fired":
                # context for the report timeline ONLY — diagnose() is
                # symptom-based and never reads the injection oracle
                self._faults_seen.append(dict(f, ts=ts))
            elif kind == "sample":
                for key, value in f.items():
                    if isinstance(value, (int, float)):
                        store.add(key, ts, float(value))
        self.policy.evaluate(ts)

    # -- SLIs ----------------------------------------------------------------
    def slis(self) -> Dict[str, float]:
        """Latest value per SLI series, plus the job-latency quantiles."""
        out: Dict[str, float] = {}
        for name in self.store.names():
            latest = self.store.latest(name)
            if latest is not None:
                out[name] = latest[1]
        for q, name in ((0.5, "job_latency_p50"), (0.95, "job_latency_p95"),
                        (0.99, "job_latency_p99")):
            val = self.metrics.quantile("job_latency_seconds", q)
            if val is not None:
                out[name] = val
        return out

    # -- critical path -------------------------------------------------------
    def critical_path(self, job_id: Any = ...) -> Dict[Any, Dict[str, Any]]:
        """Per-job phase attribution by backward chaining from the last
        settle: each chain link charges its measured exec/fetch seconds
        (monotone-clamped against its claim, like ``build_trace``), the
        claim→fetch head charges ``queue``, the gap to the predecessor
        settle charges ``queue``, and the pre-first-claim head splits
        into ``startup`` (up to the backend's startup seconds) then
        ``queue``.  The phases partition ``[t_execute, last_settle]``,
        so their sum (+ the reduce drain) reconstructs the makespan."""
        with self._lock:
            jobs = ([job_id] if job_id is not ... else
                    sorted(self._settles, key=lambda j: (j is None, j)))
            out: Dict[Any, Dict[str, Any]] = {}
            for job in jobs:
                settles = sorted(self._settles.get(job, ()),
                                 key=lambda s: s[0])
                if not settles:
                    continue
                out[job] = self._critical_path_locked(job, settles)
        return out

    def _critical_path_locked(self, job: Any,
                              settles: List[Tuple[float, Any, Any, float,
                                                  float]]
                              ) -> Dict[str, Any]:
        meta = self._job_meta.get(job, {})
        t_exec = meta.get("t_execute")
        if t_exec is None:
            claim_ts = [self._claims[k][0] for k in self._claims
                        if k[0] == job]
            t_exec = min(claim_ts) if claim_ts else settles[0][0]
        startup_budget = float(meta.get("startup_seconds") or 0.0)
        phases = {"startup": 0.0, "queue": 0.0, "fetch": 0.0, "exec": 0.0,
                  "reduce": float(meta.get("reduce_seconds") or 0.0)}
        path: List[Dict[str, Any]] = []
        visited = set()
        cur = settles[-1]
        while cur is not None and cur[1] not in visited:
            visited.add(cur[1])
            settle_ts, tid, worker, fetch_s, exec_s = cur
            claim_ts, claim_worker = self._claims.get(
                (job, tid), (t_exec, worker))
            claim_ts = min(max(claim_ts, t_exec), settle_ts)
            exec_start = max(settle_ts - exec_s, claim_ts)
            fetch_start = max(exec_start - fetch_s, claim_ts)
            phases["exec"] += settle_ts - exec_start
            phases["fetch"] += exec_start - fetch_start
            phases["queue"] += fetch_start - claim_ts
            path.append({"task_id": tid,
                         "worker": (worker if worker is not None
                                    else claim_worker),
                         "claim_ts": claim_ts, "settle_ts": settle_ts,
                         "fetch_seconds": exec_start - fetch_start,
                         "exec_seconds": settle_ts - exec_start})
            pred = None
            for s in settles:
                if s[1] in visited or s[0] > claim_ts:
                    continue
                if pred is None or s[0] > pred[0]:
                    pred = s
            if pred is None:
                head = max(claim_ts - t_exec, 0.0)
                startup = min(startup_budget, head)
                phases["startup"] += startup
                phases["queue"] += head - startup
            else:
                phases["queue"] += max(claim_ts - pred[0], 0.0)
            cur = pred
        path.reverse()
        k = self.options.top_k_stragglers
        stragglers = [
            {"task_id": tid, "worker": worker, "settle_ts": ts,
             "fetch_seconds": fetch_s, "exec_seconds": exec_s}
            for ts, tid, worker, fetch_s, exec_s in sorted(
                settles, key=lambda s: s[3] + s[4], reverse=True)[:k]]
        window = settles[-1][0] - t_exec
        return {"phases": phases,
                "phase_sum": sum(phases.values()),
                "window_seconds": window,
                "makespan": meta.get("makespan"),
                "t_execute": t_exec,
                "tasks_settled": len(settles),
                "path": path,
                "stragglers": stragglers}

    # -- diagnosis -----------------------------------------------------------
    def diagnose(self) -> List[Dict[str, Any]]:
        """Ranked root-cause findings from symptoms alone (injected
        ``fault_fired`` events are deliberately ignored).  A clean run
        yields an empty list — gated in ``bench_monitor``."""
        opt = self.options
        findings: List[Dict[str, Any]] = []
        with self._lock:
            node_state = dict(self._node_state)
            node_tooks = {n: list(t) for n, t in self._node_tooks.items()}
            crashes = dict(self._worker_crashes)
            respawns = dict(self._worker_respawns)
            leases = self._leases_reclaimed
            cache = dict(self._cache)
            rejected = list(self._rejected)
        # 1. unhealthy nodes: the store's own detector (DOWN is a dead
        # replica, DEGRADED an EMA latency outlier)
        flagged_nodes = set()
        for node, state in sorted(node_state.items(), key=str):
            if state == "down":
                flagged_nodes.add(node)
                findings.append({
                    "kind": "degraded_node", "severity": "critical",
                    "node": node, "state": "down",
                    "summary": f"data node {node} is DOWN",
                    "evidence": {"state": state}})
            elif state == "degraded":
                flagged_nodes.add(node)
                findings.append({
                    "kind": "degraded_node", "severity": "high",
                    "node": node, "state": "degraded",
                    "summary": f"data node {node} is DEGRADED "
                               f"(response-time outlier)",
                    "evidence": {"state": state}})
        # 2. slow nodes the EMA detector missed: median fetch seconds
        # vs the median of every other node's fetches
        for node, tooks in sorted(node_tooks.items(), key=str):
            if node in flagged_nodes:
                continue
            peers = [t for n, ts_ in node_tooks.items() if n != node
                     for t in ts_]
            if len(tooks) < opt.slow_node_min_samples or not peers:
                continue
            med = statistics.median(tooks)
            peer_med = statistics.median(peers)
            if (med >= opt.slow_node_factor * peer_med
                    and med - peer_med >= opt.slow_node_min_excess):
                findings.append({
                    "kind": "degraded_node", "severity": "high",
                    "node": node, "state": "slow",
                    "summary": f"data node {node} serves fetches "
                               f"{med / max(peer_med, 1e-12):.1f}× slower "
                               f"than its peers",
                    "evidence": {"median_fetch_s": med,
                                 "peer_median_fetch_s": peer_med,
                                 "samples": len(tooks)}})
        # 3. worker crash / respawn churn
        for worker, n in sorted(crashes.items(), key=str):
            if n >= opt.worker_churn_threshold:
                findings.append({
                    "kind": "worker_churn", "severity": "high",
                    "worker": worker,
                    "summary": f"worker {worker} crashed {n}× "
                               f"(respawned {respawns.get(worker, 0)}×)",
                    "evidence": {"crashes": n,
                                 "respawns": respawns.get(worker, 0)}})
        # 4. lease-reclaim storm
        if leases >= opt.lease_storm_threshold:
            findings.append({
                "kind": "lease_reclaim_storm", "severity": "warning",
                "summary": f"{leases} task leases reclaimed "
                           f"(threshold {opt.lease_storm_threshold})",
                "evidence": {"leases_reclaimed": leases}})
        # 5. cache thrash: evictions churning a mostly-missing cache
        lookups = cache["hits"] + cache["misses"]
        if (lookups >= opt.cache_thrash_min_lookups
                and cache["evictions"] >= opt.cache_thrash_ratio * lookups
                and cache["hits"] < 0.5 * lookups):
            findings.append({
                "kind": "cache_thrash", "severity": "warning",
                "summary": f"block cache thrashing: "
                           f"{cache['evictions']} evictions over "
                           f"{lookups} lookups "
                           f"(hit ratio {cache['hits'] / lookups:.2f})",
                "evidence": dict(cache, lookups=lookups)})
        # 6. admission shedding
        if rejected:
            reasons = sorted({str(r.get("reason")) for r in rejected})
            findings.append({
                "kind": "admission_shedding", "severity": "warning",
                "summary": f"{len(rejected)} job(s) rejected at admission "
                           f"({', '.join(reasons)})",
                "evidence": {"rejected": len(rejected),
                             "reasons": reasons}})
        findings.sort(key=lambda f: (_SEVERITY_RANK[f["severity"]],
                                     f["kind"], str(f.get("node", "")),
                                     str(f.get("worker", ""))))
        return findings

    # -- snapshot ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The full monitor view: SLIs, alerts, per-job critical paths,
        ranked findings, and the raw substrate counters."""
        with self._lock:
            counters = {
                "events_seen": self._events_seen,
                "worker_crashes": sum(self._worker_crashes.values()),
                "worker_respawns": sum(self._worker_respawns.values()),
                "leases_reclaimed": self._leases_reclaimed,
                "jobs_rejected": len(self._rejected),
                "jobs_queued": len(self._queued),
                "faults_seen": len(self._faults_seen),
                **{f"cache_{k}": v for k, v in self._cache.items()},
            }
            node_state = dict(self._node_state)
            faults = list(self._faults_seen)
        return {
            "slis": self.slis(),
            "alerts": {"active": self.policy.active(),
                       "history": self.policy.history()},
            "critical_path": self.critical_path(),
            "findings": self.diagnose(),
            "nodes": node_state,
            "faults_fired": faults,
            "counters": counters,
        }


# ---------------------------------------------------------------------------
# self-contained HTML report: alert timeline + critical-path waterfall
# ---------------------------------------------------------------------------

_MONITOR_CSS = _REPORT_CSS + """
.bar{display:inline-block;height:14px;vertical-align:middle}
.lane{white-space:nowrap;font-size:0.8em;margin:2px 0}
.startup{background:#bbb}.queue{background:#fc6}.fetch{background:#6ac}
.exec{background:#6c6}.reduce{background:#c9c}.alert{background:#e66}
.legend span{padding:0 0.5em;margin-right:0.6em}
"""

_PHASE_ORDER = ("startup", "queue", "fetch", "exec", "reduce")


def _waterfall(phases: Dict[str, float], total: float,
               width: int = 520) -> str:
    if total <= 0:
        return "<small>empty window</small>"
    spans = []
    for name in _PHASE_ORDER:
        w = phases.get(name, 0.0) / total * width
        if w >= 0.5:
            spans.append(f'<span class="bar {name}" '
                         f'style="width:{w:.1f}px" '
                         f'title="{name}: {phases.get(name, 0.0):.4g}s">'
                         f"</span>")
    return f'<div class="lane">{"".join(spans)}</div>'


def render_monitor_report(monitor: PlatformMonitor,
                          title: str = "platform monitor") -> str:
    """Dependency-free HTML: SLIs, the alert timeline, per-job
    critical-path waterfalls, and the ranked findings."""
    snap = monitor.snapshot()
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(title)}</title>",
        f"<style>{_MONITOR_CSS}</style></head><body>",
        f"<h1>{_html.escape(title)}</h1>",
        f"<small>events seen: {snap['counters']['events_seen']}; "
        f"active alerts: {len(snap['alerts']['active'])}; "
        f"findings: {len(snap['findings'])}</small>",
    ]
    if snap["findings"]:
        parts.append("<h2>Findings (ranked)</h2>")
        parts.append(_table(
            [(f["severity"], f["kind"], f["summary"])
             for f in snap["findings"]],
            ("severity", "kind", "summary")))
    else:
        parts.append("<h2>Findings</h2><p><small>none — clean run"
                     "</small></p>")
    history = snap["alerts"]["history"]
    parts.append("<h2>Alert timeline</h2>")
    if history:
        t0 = min(a["raised_ts"] for a in history)
        t1 = max((a["cleared_ts"] if a["cleared_ts"] is not None
                  else a["raised_ts"]) for a in history)
        span = max(t1 - t0, 1e-9)
        rows = []
        for a in history:
            end = (a["cleared_ts"] if a["cleared_ts"] is not None
                   else t1)
            left = (a["raised_ts"] - t0) / span * 400
            width = max((end - a["raised_ts"]) / span * 400, 2.0)
            bar = (f'<span class="bar alert" style="margin-left:'
                   f'{left:.1f}px;width:{width:.1f}px"></span>')
            rows.append((a["alert"], f"{a['raised_ts']:.4g}",
                         ("open" if a["cleared_ts"] is None
                          else f"{a['cleared_ts']:.4g}"), bar))
        parts.append(_table(rows, ("alert", "raised", "cleared",
                                   "timeline")))
    else:
        parts.append("<p><small>no alerts</small></p>")
    cp = snap["critical_path"]
    if cp:
        parts.append("<h2>Per-job critical path</h2>")
        parts.append('<p class="legend">' + "".join(
            f'<span class="{n}">{n}</span>' for n in _PHASE_ORDER)
            + "</p>")
        for job, rec in cp.items():
            label = "job" if job is None else f"job {job}"
            parts.append(
                f"<h3>{_html.escape(str(label))} "
                f"<small>phase sum {rec['phase_sum']:.4g}s, "
                f"window {rec['window_seconds']:.4g}s, "
                f"{rec['tasks_settled']} tasks</small></h3>")
            parts.append(_waterfall(rec["phases"], rec["phase_sum"]))
            parts.append(_table(
                [(n, f"{rec['phases'].get(n, 0.0):.4g}")
                 for n in _PHASE_ORDER],
                ("phase", "seconds")))
            if rec["stragglers"]:
                parts.append(_table(
                    [(s["task_id"], s["worker"],
                      f"{s['fetch_seconds']:.4g}",
                      f"{s['exec_seconds']:.4g}")
                     for s in rec["stragglers"]],
                    ("straggler task", "worker", "fetch s", "exec s")))
    if snap["slis"]:
        parts.append("<h2>SLIs (latest)</h2>")
        parts.append(_table(sorted(snap["slis"].items()),
                            ("sli", "value")))
    parts.append("</body></html>")
    return "".join(parts)


def write_monitor_report(monitor: PlatformMonitor, path: str,
                         title: str = "platform monitor") -> None:
    with open(path, "w") as fh:
        fh.write(render_monitor_report(monitor, title))


def write_alerts_jsonl(monitor: PlatformMonitor, path: str) -> int:
    """Dump the alert history as JSONL (the CI artifact); returns the
    number of lines written."""
    history = monitor.policy.history()
    with open(path, "w") as fh:
        for rec in history:
            fh.write(json.dumps(rec) + "\n")
    return len(history)
