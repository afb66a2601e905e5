"""Replicated in-memory data plane with adaptive replication and
response-time-aware node selection (thesis §3.5, §3.4).

The thesis builds its scalable file system on Cassandra: a few *data nodes*
hold replicas; worker nodes fetch sample blocks from them.  A data
modelling engine collects per-node fetch times plus task execution times
from the scheduler's feedback loop, estimates the *cache interference*
between task execution and data fetch cycles, and varies the replication
factor to meet the tiny-task SLO.  The dynamic scheduler then "schedules
the tasks to worker nodes based on the availability and response times of
the data nodes" — this module is the availability/response-time side of
that loop:

* every node carries a **response-time EMA** and an availability state
  (``healthy`` / ``degraded`` / ``down``), maintained from fetch outcomes:
  consecutive failures take a node down, a latency-outlier EMA (vs the
  replica-set median) marks it degraded;
* :meth:`ReplicatedDataStore.node_scores` exposes the predicted
  next-fetch seconds per node (EMA × queueing term, ∞ when down) — the
  signal the scheduler ranks ready tasks by;
* replica **selection** is score-based (``select="response_time"``): the
  cheapest available holder serves each fetch, so a degraded node sheds
  traffic automatically; ``select="least_inflight"`` restores the old
  FIFO-ish policy (the benchmark's unbalanced baseline);
* a raising :meth:`DataNode.fetch` triggers **bounded retries with
  replica failover** — the failed node's state is updated and the fetch
  moves to the next-best holder instead of hammering one replica;
* an optional worker-side **block cache**
  (:class:`~repro_torch.core.blockcache.BlockCache`, DESIGN.md §14) sits in
  front of the replica claim path: ``fetch``/``fetch_many`` consult it
  before claiming a replica, successful fetches (including prefetcher
  fills) populate it, ``put_all`` re-placement bumps per-sample
  versions so stale entries can never serve, and
  :meth:`predicted_task_fetch` scores cache-resident samples as zero
  fetch cost — cache locality becomes a scheduling signal alongside
  response times.

Hardware adaptation (DESIGN.md §2): data nodes here are in-process shard
holders behind an abstract transport, so per-node latency and failures can
be injected (benchmarks/chaos) or real (examples).  The adaptive
replication control law is the paper's: response-time feedback against
the SLO.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import recovery as rec

HEALTHY = "healthy"
DEGRADED = "degraded"
DOWN = "down"


class DataNodeError(RuntimeError):
    """A data-node fetch failed (after replica failover, if any)."""


@dataclasses.dataclass
class DataNode:
    node_id: int
    store: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    # injected latency model: seconds per fetch of n bytes
    latency: Callable[[int], float] = lambda nbytes: 0.0
    inflight: int = 0
    # queueing model: up to this many concurrent fetches are served at
    # full speed; beyond it, service time scales linearly with the queue
    # (bounded-capacity node, not per-request interference — keeps the
    # contention feedback stable under prefetch/wave bursts)
    parallelism: int = 4
    # fault injection (benchmarks/chaos/tests): every fetch raises
    failing: bool = False
    # availability bookkeeping, maintained by the owning store
    state: str = HEALTHY
    resp_ema: Optional[float] = None
    fetches: int = 0                    # successful fetches served
    failures: int = 0                   # total failed fetches
    consecutive_failures: int = 0
    # probe-driven auto-revival (failure-detected DOWN only): when the
    # next health probe is due, and the current (backed-off) interval.
    # Administrative mark_down() leaves auto_probe False — that path
    # stays sticky until an explicit revive(), as documented.
    auto_probe: bool = False
    next_probe_at: Optional[float] = None
    probe_interval: float = 0.0

    def fetch(self, sample_id: int,
              inflight: Optional[int] = None) -> Tuple[np.ndarray, float]:
        """``inflight`` is the contention level the latency model charges
        — the store snapshots it under its lock at claim time so the
        model is race-free under concurrent fetches (reading
        ``self.inflight`` here could see a peer's increment that landed
        after this fetch was already claimed)."""
        if self.failing:
            raise DataNodeError(f"data node {self.node_id} is failing")
        t0 = time.perf_counter()
        data = self.store[sample_id]
        lat = self.latency(data.nbytes)
        n_inflight = self.inflight if inflight is None else inflight
        # queueing interference: beyond the node's service parallelism,
        # concurrent fetches queue (linear slowdown)
        lat *= max(1.0, n_inflight / max(self.parallelism, 1))
        if lat:
            time.sleep(min(lat, 0.05))       # bounded real sleep
        return data, (time.perf_counter() - t0) + lat


@dataclasses.dataclass
class ReplicationPolicy:
    fetch_slo: float = 5e-3            # target p95 fetch seconds
    min_replicas: int = 1
    max_replicas: int = 8
    window: int = 64                   # observations per control decision
    shrink_margin: float = 0.4         # shrink if p95 < margin·SLO
    # availability detection (balanced scheduling, DESIGN.md §9)
    max_consecutive_failures: int = 3  # failures before a node goes DOWN
    degraded_factor: float = 3.0       # EMA > factor·median(peers) ⇒ DEGRADED
    max_fetch_attempts: int = 3        # bounded retries across replicas
    resp_alpha: float = 0.3            # response-time EMA smoothing
    # unified retry policy (repro_torch.core.recovery.RetryPolicy): 0 base
    # delay keeps the legacy immediate-failover behavior; callers that
    # want real backoff between replica attempts raise it
    retry_base_delay: float = 0.0
    retry_backoff_factor: float = 2.0
    retry_max_delay: float = 0.25
    retry_jitter: float = 0.0
    # probe-driven auto-revival of failure-detected DOWN nodes: re-probe
    # after probe_interval, backing off multiplicatively on failed
    # probes up to probe_max_interval
    auto_revive: bool = True
    probe_interval: float = 0.05
    probe_backoff_factor: float = 2.0
    probe_max_interval: float = 2.0

    def retry_policy(self) -> "rec.RetryPolicy":
        return rec.RetryPolicy(
            max_attempts=self.max_fetch_attempts,
            base_delay=self.retry_base_delay,
            backoff_factor=self.retry_backoff_factor,
            max_delay=self.retry_max_delay,
            jitter=self.retry_jitter)


class ReplicatedDataStore:
    """Replication across a *small, adaptive* set of data nodes.

    ``put_all`` replicates samples onto the replica set — fully (every
    node holds everything, the default) or sharded (``replication=k``
    places each sample on k nodes, the paper's Cassandra-style partial
    placement that makes per-task locality scores meaningful).  ``fetch``
    picks the cheapest available holder by predicted response time;
    response times feed both the availability detector and the adaptive
    replication controller, which grows the replica set when p95 fetch
    time violates the SLO (interference detected) and shrinks it when
    comfortably under.
    """

    def __init__(self, n_initial: int = 2,
                 policy: ReplicationPolicy = ReplicationPolicy(),
                 latency: Optional[Callable[[int], float]] = None,
                 select: str = "response_time", seed: int = 0):
        # "response_time": predicted-latency scores (the balanced
        # subsystem); "least_inflight": queue counts only, blind to
        # latency magnitude; "static": always the sample's primary
        # holder — classic static placement with no feedback, the
        # paper's FIFO baseline
        if select not in ("response_time", "least_inflight", "static"):
            raise ValueError(f"unknown select policy {select!r}; choose "
                             "'response_time', 'least_inflight' or "
                             "'static'")
        self.policy = policy
        self.select = select
        self._retry = policy.retry_policy()
        self._rng = random.Random(seed)     # retry jitter (deterministic)
        self._latency = latency or (lambda nbytes: 0.0)
        self.nodes: List[DataNode] = [
            DataNode(i, latency=self._latency)
            for i in range(max(n_initial, policy.min_replicas))]
        self._samples: Dict[int, np.ndarray] = {}
        # sample -> node ids holding it; None ⇒ full replication (every
        # node, including ones the controller adds later, holds all)
        self._placement: Optional[Dict[int, List[int]]] = None
        self._obs: List[float] = []
        self._lock = threading.Lock()
        self._executor = None            # lazy shared pool for fetch_many
        self.resize_events: List[Tuple[int, int]] = []   # (n_obs, replicas)
        self._exec_ema: Optional[float] = None
        # fired (outside the lock) on HEALTHY/DEGRADED/DOWN transitions so
        # the scheduler can re-rank ready tasks the moment a node turns
        self.on_state_change: Optional[Callable[[DataNode], None]] = None
        # optional repro_torch.platform.telemetry.TelemetryBus the driver or
        # service attaches (data-plane events: fetch_start/done/failed,
        # node_state_change with the EMA/score behind each transition)
        self.telemetry = None
        # optional repro_torch.core.blockcache.BlockCache the driver or
        # service attaches (DESIGN.md §14): consulted before the replica
        # claim path, filled on successful fetches, invalidated on
        # put_all re-placement via the per-sample version counters
        self.cache = None
        self._versions: Dict[int, int] = {}

    # -- data placement ------------------------------------------------------
    def put_all(self, samples: Dict[int, np.ndarray],
                replication: Optional[int] = None) -> None:
        """Place ``samples`` on the data plane.  ``replication=None``
        replicates fully (every node holds every sample);
        ``replication=k`` shards round-robin so each sample lives on k of
        the current nodes — adaptive *shrinking* is disabled in that mode
        (removing a node could orphan its shards).

        Re-putting an already-placed sample without an explicit
        ``replication`` refreshes its bytes on its EXISTING holders and
        never widens the placement — the platform driver re-puts the
        dataset on every run, and that must not silently turn a
        caller's replication-k sharding into full replication.  An
        explicit ``replication`` re-places (old holders are dropped).

        Block-cache coherence (DESIGN.md §14): re-placing a sample with
        new bytes, or any explicit-``replication`` re-placement, bumps
        its version and invalidates its cached entry.  A same-object
        re-put (the driver re-putting the dataset it already placed)
        keeps the version — the cached block aliases the same array, so
        repeat runs against one store keep their cache hits."""
        stale = (set(samples) if replication is not None
                 else {sid for sid, arr in samples.items()
                       if sid in self._samples
                       and self._samples[sid] is not arr})
        if stale:
            with self._lock:
                for sid in stale:
                    self._versions[sid] = self._versions.get(sid, 0) + 1
            if self.cache is not None:
                self.cache.invalidate(stale)
        self._samples.update(samples)
        if replication is None and self._placement is None:
            for node in self.nodes:
                node.store.update(samples)
            return
        with self._lock:
            if self._placement is None:
                self._placement = {
                    sid: [n.node_id for n in self.nodes]
                    for sid in self._samples if sid not in samples}
            k = (len(self.nodes) if replication is None
                 else max(1, min(replication, len(self.nodes))))
            by_id = {n.node_id: n for n in self.nodes}
            for j, (sid, arr) in enumerate(sorted(samples.items())):
                if replication is None and sid in self._placement:
                    for nid in self._placement[sid]:
                        if nid in by_id:
                            by_id[nid].store[sid] = arr
                    continue
                holders = [self.nodes[(j + r) % len(self.nodes)].node_id
                           for r in range(k)]
                for nid in set(self._placement.get(sid, ())) - set(holders):
                    if nid in by_id:           # dropped holder: free it
                        by_id[nid].store.pop(sid, None)
                self._placement[sid] = holders
                for nid in holders:
                    by_id[nid].store[sid] = arr

    @property
    def replication_factor(self) -> int:
        return len(self.nodes)

    def replicas_of(self, sample_id: int) -> List[int]:
        """Node ids holding ``sample_id`` (all nodes under full
        replication)."""
        if self._placement is None:
            return [n.node_id for n in self.nodes]
        return list(self._placement.get(sample_id, ()))

    # -- response-time / availability model ----------------------------------
    def _score_locked(self, node: DataNode, extra_inflight: int = 0) -> float:
        """Predicted next-fetch seconds on ``node``: response-time EMA
        (SLO prior before any observation) scaled by the same queueing
        term the latency model charges; ∞ when the node is down."""
        if node.state == DOWN:
            return float("inf")
        inflight = node.inflight + extra_inflight
        if self.select == "least_inflight":
            # legacy policy: contention only, blind to response times
            return float(inflight)
        if node.resp_ema is not None:
            base = node.resp_ema
        else:
            # optimistic prior for an unmeasured node: the best peer EMA
            # (or the SLO).  Pessimism would starve it of the probe
            # traffic that either measures it or takes it DOWN — a
            # failing node would dodge the consecutive-failure detector
            # forever.
            peers = [n.resp_ema for n in self.nodes
                     if n.resp_ema is not None and n.state != DOWN]
            base = min(peers + [self.policy.fetch_slo])
        # predicted service time if one more fetch is claimed now
        return base * max(1.0, (inflight + 1) / max(node.parallelism, 1))

    def node_scores(self) -> Dict[int, float]:
        """Predicted next-fetch seconds per node id — the availability ×
        response-time signal the dynamic scheduler ranks tasks by."""
        with self._lock:
            return {n.node_id: self._score_locked(n) for n in self.nodes}

    def node_states(self) -> Dict[int, str]:
        with self._lock:
            return {n.node_id: n.state for n in self.nodes}

    def predicted_task_fetch(self, sample_ids: Sequence[int]) -> float:
        """Predicted fetch seconds for a task over ``sample_ids``:
        ``fetch_many`` parallelizes the batch, so the task is bound by
        its slowest sample's *best available* replica.  Samples whose
        every holder is down score ∞ (the scheduler drains them last,
        giving failover/recovery time to act).  Cache-resident samples
        cost nothing — ``fetch_many`` will serve them without touching
        a data node — so a fully-cached task scores 0.0 and the
        bucket-ranked claim paths drain it first (cache locality as a
        scheduling signal, DESIGN.md §14)."""
        cache = self.cache
        with self._lock:
            by_id = {n.node_id: n for n in self.nodes}
            worst = 0.0
            for sid in sample_ids:
                if (cache is not None
                        and cache.contains(sid, self._versions.get(sid, 0))):
                    continue               # served worker-side: zero cost
                holders = ([n.node_id for n in self.nodes]
                           if self._placement is None
                           else self._placement.get(sid, ()))
                best = min((self._score_locked(by_id[h]) for h in holders
                            if h in by_id), default=float("inf"))
                worst = max(worst, best)
            return worst

    def version_of(self, sample_id: int) -> int:
        """The sample's placement version (bumped on re-placement) —
        the coherence token cached blocks are validated against."""
        return self._versions.get(sample_id, 0)

    def cache_covers(self, sample_ids: Sequence[int]) -> bool:
        """Whether EVERY sample of a task is cache-resident at its
        current version — the prefetcher skips such tasks (their claim
        is served worker-side; a background fetch would waste a pipe
        slot on data the pool already holds)."""
        cache = self.cache
        if cache is None or not cache.options.enabled:
            return False
        return all(cache.contains(sid, self._versions.get(sid, 0))
                   for sid in sample_ids)

    def probe(self) -> Dict[int, float]:
        """Seed every node's response-time EMA with one direct fetch
        (the data modelling engine's initial measurement — the data-plane
        analogue of the scheduler's phase-1 probe tasks): without it the
        first wave of claims is blind and pays the degraded node's
        latency before the feedback loop can steer around it."""
        out: Dict[int, float] = {}
        for node in list(self.nodes):
            if node.state == DOWN or not node.store:
                continue
            sid = next(iter(node.store))
            with self._lock:
                node.inflight += 1
                snap = node.inflight
            try:
                _, took = node.fetch(sid, inflight=snap)
            except BaseException:          # noqa: BLE001
                with self._lock:
                    node.inflight -= 1
                self._record_outcome(node, None)
                continue
            with self._lock:
                node.inflight -= 1
            self._record_outcome(node, took)
            out[node.node_id] = took
        return out

    def mark_down(self, node_id: int) -> None:
        """Administratively take a node out of the replica set (chaos
        injection / external health checks).  Unlike failure-detected
        DOWN, this is sticky: no auto-revival probe is armed."""
        node = self._node(node_id)
        with self._lock:
            node.auto_probe = False
            node.next_probe_at = None
        self._set_state(node, DOWN)

    def revive(self, node_id: int) -> None:
        """Return a down node to service (its EMA restarts fresh)."""
        node = self._node(node_id)
        with self._lock:
            node.consecutive_failures = 0
            node.resp_ema = None
            node.auto_probe = False
            node.next_probe_at = None
        self._set_state(node, HEALTHY)

    def _maybe_probe_down(self) -> None:
        """Probe-driven auto-revival: re-probe failure-detected DOWN
        nodes whose (backed-off) probe timer is due.  A successful probe
        revives the node and seeds its EMA; a failed probe only widens
        the backoff — it does NOT touch the node's failure counters
        (probes are health checks, not serving fetches, and a DOWN node
        never serves claims)."""
        if not self.policy.auto_revive:
            return
        now = time.monotonic()
        due: List[DataNode] = []
        with self._lock:
            for n in self.nodes:
                if (n.state == DOWN and n.auto_probe
                        and n.next_probe_at is not None
                        and now >= n.next_probe_at):
                    # claim the probe so concurrent fetchers don't race
                    n.next_probe_at = now + 3600.0
                    due.append(n)
        for node in due:
            sid = next(iter(node.store), None)
            ok = False
            took = None
            if sid is not None:
                with self._lock:
                    node.inflight += 1
                    snap = node.inflight
                try:
                    _, took = node.fetch(sid, inflight=snap)
                    ok = True
                except BaseException:      # noqa: BLE001
                    pass
                finally:
                    with self._lock:
                        node.inflight -= 1
            if ok:
                self.revive(node.node_id)
                self._record_outcome(node, took)   # seed the fresh EMA
            else:
                with self._lock:
                    node.probe_interval = min(
                        node.probe_interval
                        * self.policy.probe_backoff_factor,
                        self.policy.probe_max_interval)
                    node.next_probe_at = (time.monotonic()
                                          + node.probe_interval)

    def _node(self, node_id: int) -> DataNode:
        for n in self.nodes:
            if n.node_id == node_id:
                return n
        raise KeyError(f"no data node {node_id}")

    def _set_state(self, node: DataNode, state: str) -> None:
        with self._lock:
            changed = node.state != state
            node.state = state
        if changed:
            self._emit_state_change(node)
            if self.on_state_change is not None:
                self.on_state_change(node)

    def _refresh_state_locked(self, node: DataNode) -> Optional[DataNode]:
        """Recompute a node's availability from its counters/EMA; returns
        the node when its state changed (caller fires the callback
        outside the lock).  DOWN is sticky until :meth:`revive`."""
        if node.state == DOWN:
            return None
        if node.consecutive_failures >= self.policy.max_consecutive_failures:
            new = DOWN
            if self.policy.auto_revive:
                # failure-detected DOWN: arm the auto-revival probe
                # (administrative mark_down() stays sticky)
                node.auto_probe = True
                node.probe_interval = self.policy.probe_interval
                node.next_probe_at = (time.monotonic()
                                      + node.probe_interval)
        else:
            peers = [n.resp_ema for n in self.nodes
                     if n is not node and n.state != DOWN
                     and n.resp_ema is not None]
            if peers and node.resp_ema is not None:
                threshold = (self.policy.degraded_factor
                             * float(np.median(peers)))
                # hysteresis: enter DEGRADED above the threshold, leave
                # only below 0.8x of it — an EMA hovering at the edge
                # must not flap states (each flap re-ranks every ready
                # queue via on_state_change)
                if node.resp_ema > threshold:
                    new = DEGRADED
                elif node.resp_ema < 0.8 * threshold:
                    new = HEALTHY
                else:
                    new = node.state
            else:
                new = HEALTHY
        if new != node.state:
            node.state = new
            return node
        return None

    def _record_outcome(self, node: DataNode, took: Optional[float]) -> None:
        """Fold one fetch outcome (``took=None`` ⇒ failure) into the
        node's EMA/counters, then refresh EVERY node's availability: an
        outlier is relative to its peers, so a node that shed all its
        traffic after a slow probe must still be re-judged as the peer
        EMAs evolve."""
        with self._lock:
            if took is None:
                node.failures += 1
                node.consecutive_failures += 1
            else:
                node.fetches += 1
                node.consecutive_failures = 0
                a = self.policy.resp_alpha
                node.resp_ema = (took if node.resp_ema is None
                                 else (1 - a) * node.resp_ema + a * took)
            changed = [n for n in self.nodes
                       if self._refresh_state_locked(n) is not None]
        for n in changed:
            self._emit_state_change(n)
            if self.on_state_change is not None:
                self.on_state_change(n)

    def _emit_state_change(self, node: DataNode) -> None:
        bus = self.telemetry
        if bus is not None:
            bus.emit("node_state_change", node=node.node_id,
                     state=node.state, resp_ema=node.resp_ema,
                     consecutive_failures=node.consecutive_failures)

    # -- fetch path ----------------------------------------------------------
    def _claim_locked(self, sample_id: int,
                      exclude: Sequence[int] = ()) -> Optional[DataNode]:
        """Cheapest available holder of ``sample_id`` (excluding already-
        tried nodes), with its inflight count claimed.  ``static``
        selection takes the first available holder in placement order
        (the primary replica) — failover still moves past it when it
        raises."""
        by_id = {n.node_id: n for n in self.nodes}
        cands = [by_id[h] for h in self.replicas_of(sample_id)
                 if h not in exclude and h in by_id
                 and by_id[h].state != DOWN]
        if not cands:
            return None
        if self.select == "static":
            node = cands[0]
        else:
            node = min(cands,
                       key=lambda n: (self._score_locked(n), n.node_id))
        node.inflight += 1
        return node

    # -- block cache plumbing (DESIGN.md §14) --------------------------------
    def _cache_get(self, sample_id: int) -> Optional[np.ndarray]:
        """Consult the attached cache; emits ``cache_hit``/``cache_miss``
        on the bus.  ``None`` ⇒ the caller must fetch from a replica."""
        cache = self.cache
        if cache is None or not cache.options.enabled:
            return None
        data = cache.get(sample_id, self._versions.get(sample_id, 0))
        bus = self.telemetry
        if bus is not None:
            bus.emit("cache_hit" if data is not None else "cache_miss",
                     sample_id=sample_id)
        return data

    def _cache_fill(self, sample_id: int, data: np.ndarray) -> None:
        """Offer a fetched block to the cache; emits one ``cache_evict``
        per entry the admission displaced."""
        cache = self.cache
        if cache is None:
            return
        evicted = cache.put(sample_id, self._versions.get(sample_id, 0),
                            data)
        bus = self.telemetry
        if bus is not None:
            for esid in evicted:
                bus.emit("cache_evict", sample_id=esid)

    def fetch(self, sample_id: int,
              budget: Optional["rec.RetryBudget"] = None) -> np.ndarray:
        """Fetch one sample — from the worker-side block cache when it
        holds the current version, else from the cheapest available
        replica (the fetched block then populates the cache)."""
        data = self._cache_get(sample_id)
        if data is not None:
            return data
        data = self._fetch_replicated(sample_id, budget=budget)
        self._cache_fill(sample_id, data)
        return data

    def _fetch_replicated(self, sample_id: int,
                          budget: Optional["rec.RetryBudget"] = None
                          ) -> np.ndarray:
        """Fetch one sample from the cheapest available replica, under
        the unified :class:`~repro_torch.core.recovery.RetryPolicy`: a raising
        node records a failure (taking it DOWN after
        ``max_consecutive_failures``) and the fetch fails over to the
        next-best holder after the policy's (default zero) backoff.
        Permanent errors propagate immediately; ``budget`` exhaustion
        stops retrying early.  Replica exhaustion raises a
        :class:`DataNodeError` tagged ``permanent`` so upstream retry
        layers fail fast instead of re-spinning a dead sample."""
        self._maybe_probe_down()
        policy = self._retry
        tried: List[int] = []
        last_err: Optional[BaseException] = None
        for attempt in range(max(1, policy.max_attempts)):
            with self._lock:
                node = self._claim_locked(sample_id, exclude=tried)
                snap = node.inflight if node is not None else 0
            if node is None:
                break
            bus = self.telemetry
            if bus is not None:
                bus.emit("fetch_start", sample_id=sample_id,
                         node=node.node_id)
            try:
                data, took = node.fetch(sample_id, inflight=snap)
            except BaseException as e:     # noqa: BLE001
                last_err = e
                tried.append(node.node_id)
                with self._lock:
                    node.inflight -= 1
                if bus is not None:
                    bus.emit("fetch_failed", sample_id=sample_id,
                             node=node.node_id)
                self._record_outcome(node, None)
                if rec.is_permanent(e):
                    break
                if budget is not None and not budget.spend():
                    break
                delay = policy.delay(attempt + 1, self._rng)
                if delay > 0.0:
                    time.sleep(delay)
                continue
            with self._lock:
                node.inflight -= 1
            if bus is not None:
                bus.emit("fetch_done", sample_id=sample_id,
                         node=node.node_id, took=took)
            self._record_outcome(node, took)
            self._observe(took)
            return data
        err = DataNodeError(
            f"sample {sample_id}: no replica served the fetch "
            f"(tried nodes {tried})")
        err.permanent = True
        raise err from last_err

    def fetch_many(self, sample_ids: Sequence[int],
                   budget: Optional["rec.RetryBudget"] = None
                   ) -> List[np.ndarray]:
        """Batch fetch, spread across the replica set concurrently.

        ONE lock acquisition assigns every sample of the batch its
        cheapest available holder (scores recomputed as the batch claims
        inflight slots, so a multi-sample task never serializes on one
        node) and snapshots each node's inflight count for the latency
        model; the fetches themselves then run in parallel on a small
        shared pool.  A failed fetch fails over to the sample's next-best
        holder (bounded by ``max_fetch_attempts``, spending ``budget``).

        Cache-resident samples (current version) are served worker-side
        without claiming any replica — only the remainder touches the
        data plane, and those fetched blocks populate the cache."""
        self._maybe_probe_down()
        if len(sample_ids) <= 1:
            return [self.fetch(s, budget=budget) for s in sample_ids]
        cached: Dict[int, np.ndarray] = {}
        if self.cache is not None and self.cache.options.enabled:
            for sid in dict.fromkeys(sample_ids):
                data = self._cache_get(sid)
                if data is not None:
                    cached[sid] = data
            remaining = [sid for sid in sample_ids if sid not in cached]
            if not remaining:
                return [cached[sid] for sid in sample_ids]
        else:
            remaining = list(sample_ids)

        def one(claim):
            sid, node, snap = claim
            bus = self.telemetry
            if bus is not None:
                bus.emit("fetch_start", sample_id=sid, node=node.node_id)
            try:
                data, took = node.fetch(sid, inflight=snap)
            except BaseException:          # noqa: BLE001
                with self._lock:
                    node.inflight -= 1
                if bus is not None:
                    bus.emit("fetch_failed", sample_id=sid,
                             node=node.node_id)
                self._record_outcome(node, None)
                # failover path re-claims under the lock (different node)
                return sid, None, None
            with self._lock:
                node.inflight -= 1
            if bus is not None:
                bus.emit("fetch_done", sample_id=sid, node=node.node_id,
                         took=took)
            self._record_outcome(node, took)
            return sid, data, took

        # claims AND submissions happen under the one lock acquisition:
        # close() also swaps the executor under the lock, so it can never
        # shut the pool down between a claim (inflight incremented) and
        # its submit — already-submitted fetches survive shutdown(wait=
        # False) and their finally blocks settle the inflight accounting
        with self._lock:
            pool = self._fetch_pool_locked()
            futures = []
            for sid in remaining:
                node = self._claim_locked(sid)
                if node is None:
                    err = DataNodeError(
                        f"sample {sid}: every replica is down")
                    err.permanent = True
                    raise err
                futures.append(pool.submit(one, (sid, node, node.inflight)))

        out: Dict[int, np.ndarray] = dict(cached)
        order: List[int] = list(sample_ids)
        failed: List[int] = []
        for future in futures:
            sid, data, took = future.result()
            if data is None:
                failed.append(sid)
                continue
            self._observe(took)
            out[sid] = data
            self._cache_fill(sid, data)
        for sid in failed:                 # bounded failover, serial tail
            # _fetch_replicated, not fetch: this sample already counted
            # its cache miss above — a second consult would double-count
            out[sid] = self._fetch_replicated(sid, budget=budget)
            self._cache_fill(sid, out[sid])
        return [out[sid] for sid in order]

    def _fetch_pool_locked(self):
        """Shared fetch executor, lazily created; caller holds ``_lock``
        (so two concurrent first fetch_many() calls share one pool)."""
        if self._executor is None:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="datastore-fetch")
        return self._executor

    def close(self) -> None:
        """Shut down the shared fetch pool (idempotent; the store stays
        usable — a later ``fetch_many`` lazily recreates it)."""
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=False)

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter teardown: best effort
            pass

    # -- feedback from the scheduler ------------------------------------------
    def report_exec_time(self, exec_time: float) -> None:
        """Task execution times from the scheduler's feedback loop — used to
        estimate interference between execution and fetch cycles."""
        a = 0.3
        self._exec_ema = (exec_time if self._exec_ema is None
                          else (1 - a) * self._exec_ema + a * exec_time)

    def interference_estimate(self) -> float:
        """Fraction of the task SLO budget eaten by fetches: fetch_p95 /
        max(exec, ε).  > 1 ⇒ fetches dominate execution (the cache
        interference regime of §3.5)."""
        if not self._obs:
            return 0.0
        p95 = float(np.percentile(self._obs[-self.policy.window:], 95))
        return p95 / max(self._exec_ema or self.policy.fetch_slo, 1e-9)

    # -- adaptive replication ----------------------------------------------
    def _observe(self, took: float) -> None:
        with self._lock:
            self._obs.append(took)
            if len(self._obs) % self.policy.window:
                return
            p95 = float(np.percentile(self._obs[-self.policy.window:], 95))
            if (p95 > self.policy.fetch_slo
                    and len(self.nodes) < self.policy.max_replicas):
                nid = 1 + max(n.node_id for n in self.nodes)
                node = DataNode(nid, latency=self._latency)
                node.store.update(self._samples)
                self.nodes.append(node)
                if self._placement is not None:
                    for holders in self._placement.values():
                        holders.append(nid)
                self.resize_events.append((len(self._obs), len(self.nodes)))
            elif (p95 < self.policy.shrink_margin * self.policy.fetch_slo
                    and len(self.nodes) > self.policy.min_replicas
                    and self._placement is None):
                # sharded placement never shrinks (orphaned shards)
                self.nodes.pop()
                self.resize_events.append((len(self._obs), len(self.nodes)))

    def stats(self) -> Dict[str, float]:
        obs = np.asarray(self._obs[-self.policy.window:] or [0.0])
        with self._lock:
            states = [n.state for n in self.nodes]
            fetches = {n.node_id: n.fetches for n in self.nodes}
        served = sum(fetches.values())
        top = max(fetches.values()) if fetches else 0
        out = {
            "replicas": float(len(states)),
            "fetch_p50": float(np.percentile(obs, 50)),
            "fetch_p95": float(np.percentile(obs, 95)),
            "interference": self.interference_estimate(),
            "nodes_degraded": float(states.count(DEGRADED)),
            "nodes_down": float(states.count(DOWN)),
            # traffic skew: share of fetches served by the hottest node
            # (1/replicas ⇒ perfectly balanced)
            "fetch_skew": (top / served) if served else 0.0,
        }
        if self.cache is not None:
            for k, v in self.cache.stats().items():
                out[f"cache_{k}"] = float(v)
        return out

    def fetch_counts(self) -> Dict[int, int]:
        """Per-node successful-fetch counters (replica traffic skew)."""
        with self._lock:
            return {n.node_id: n.fetches for n in self.nodes}
