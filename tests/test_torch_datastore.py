"""The data plane in the PyTorch port (``repro_torch.core.datastore`` and
the driver's datastore branches) against the JAX reference
(``repro.core.datastore``), and the reference's invariants inside the port.

The datastore is numpy and the standard library in both packages, so the
same fetch sequence must leave both in the same state.  Its response times
are wall time plus the injected latency; the parity tests replace each
module's clock with one that stands still, so that a fetch takes exactly
its injected latency and both stores see the same numbers (the
reference's own ``test_node_scores_reflect_response_times`` reads the wall
clock and is no oracle here).  Sleeps are recorded, not slept: the retry
backoff's seeded jitter must give both packages the same delays.

Jobs with a store run the port with ``device="cpu"`` (the kernel wrappers'
plain versions) and must equal the same job without a store bit for bit:
the datastore models the data plane, the blocks still come from the plan.
Against the reference, ``mean`` and ``var`` agree to ``rtol=1e-5,
atol=1e-5`` (the tolerance ``tests/test_torch_platform.py`` states) and
counts exactly."""

import types

import numpy as np
import pytest

import repro.platform as ref_platform
import repro_torch.platform as port_platform
from repro.core import blockcache as ref_bc
from repro.core import datastore as ref_ds
from repro.core import recovery as ref_rec
from repro.platform import driver as ref_driver
from repro_torch.core import blockcache as port_bc
from repro_torch.core import datastore as port_ds
from repro_torch.core import recovery as port_rec
from repro_torch.core import subsample as pss
from repro_torch.core.blockcache import CacheOptions
from repro_torch.data import NetflixSpec, netflix_dataset
from repro_torch.platform import driver as port_driver
from repro_torch.platform.faults import FaultEvent, FaultInjector, FaultPlan

WL_SHAPE = dict(draws=4, draw_size=16)
REF_WL = ref_platform.MomentsSpec(**WL_SHAPE)
PORT_WL = port_platform.MomentsSpec(**WL_SHAPE)
KNEE = 4 * 96 * 4
RTOL, ATOL = 1e-5, 1e-5


class _Clock:
    """A module's ``time`` that stands still: ``perf_counter`` and
    ``monotonic`` read ``now`` (moved by the test), ``sleep`` records."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def module(self):
        return types.SimpleNamespace(perf_counter=lambda: self.now,
                                     monotonic=lambda: self.now,
                                     time=lambda: self.now,
                                     sleep=self.sleeps.append)


@pytest.fixture
def clocks(monkeypatch):
    ref_clock, port_clock = _Clock(), _Clock()
    monkeypatch.setattr(ref_ds, "time", ref_clock.module())
    monkeypatch.setattr(port_ds, "time", port_clock.module())
    return ref_clock, port_clock


def _stores(n_nodes=3, latencies=(2e-3, 1e-3, 1e-3), **policy_kw):
    """The same store in both packages: node ``i`` answers a fetch of n
    bytes in ``latencies[i] · (1 + n / 4096)`` seconds."""
    out = []
    for ds in (ref_ds, port_ds):
        policy = ds.ReplicationPolicy(window=10_000, max_replicas=n_nodes,
                                      **policy_kw)
        store = ds.ReplicatedDataStore(n_initial=n_nodes, policy=policy,
                                       seed=11)
        for node, lat in zip(store.nodes, latencies):
            node.latency = (lambda nbytes, _l=lat:
                            _l * (1.0 + nbytes / 4096.0))
        out.append(store)
    return out


def _samples(n=12, seed=0):
    rng = np.random.default_rng(seed)
    return {i: rng.standard_normal(int(rng.integers(16, 64))).astype(
        np.float32) for i in range(n)}


def _state(store, sample_ids):
    nodes = [(n.node_id, n.state, n.resp_ema, n.fetches, n.failures,
              n.consecutive_failures) for n in store.nodes]
    return dict(nodes=nodes, scores=store.node_scores(),
                states=store.node_states(),
                replicas={s: store.replicas_of(s) for s in sample_ids},
                task=[store.predicted_task_fetch(sample_ids[i:i + 3])
                      for i in range(0, len(sample_ids), 3)],
                counts=store.fetch_counts(), stats=store.stats(),
                resizes=list(store.resize_events))


@pytest.mark.parametrize("replication", [None, 2])
def test_placement_scores_and_states_match_reference(clocks, replication):
    ref, port = _stores(latencies=(9e-3, 1e-3, 1.2e-3))
    samples = _samples()
    for store in (ref, port):
        store.put_all(samples, replication=replication)
        store.probe()
    ids = sorted(samples)
    assert _state(port, ids) == _state(ref, ids)
    for i in range(30):
        for store in (ref, port):
            store.fetch(ids[(7 * i) % len(ids)])
    # the 9x node has turned DEGRADED in both, with the same EMAs
    assert _state(port, ids) == _state(ref, ids)
    assert port.node_states()[0] == port_ds.DEGRADED
    for store in (ref, port):
        store.report_exec_time(3e-3)
        store.put_all(samples)        # a re-put keeps the placement
    assert _state(port, ids) == _state(ref, ids)
    assert set(port.stats()) == set(ref.stats())


def test_failover_order_and_retry_jitter_match_reference(clocks):
    ref_clock, port_clock = clocks
    ref, port = _stores(retry_base_delay=1e-3, retry_jitter=0.5,
                        max_consecutive_failures=2)
    samples = _samples(n=9)
    seen = {id(ref): [], id(port): []}
    for store in (ref, port):
        store.put_all(samples, replication=2)
        store.on_state_change = (lambda node, _s=seen[id(store)]:
                                 _s.append((node.node_id, node.state)))
        store.probe()
        store.nodes[1].failing = True
    ids = sorted(samples)
    for i in range(18):
        for store in (ref, port):
            np.testing.assert_array_equal(store.fetch(ids[i % 9]),
                                          samples[ids[i % 9]])
    assert _state(port, ids) == _state(ref, ids)
    assert port.node_states()[1] == port_ds.DOWN
    assert seen[id(port)] == seen[id(ref)] != []
    # the retries slept the same seeded, jittered delays
    assert port_clock.sleeps == ref_clock.sleeps != []


def test_every_replica_down_raises_the_same_permanent_error(clocks):
    for store, ds, rec in zip(_stores(n_nodes=2), (ref_ds, port_ds),
                              (ref_rec, port_rec)):
        store.put_all({0: np.zeros(4, np.float32)})
        for node in store.nodes:
            node.failing = True
        with pytest.raises(ds.DataNodeError) as err:
            store.fetch(0)
        assert rec.is_permanent(err.value)


def test_auto_revival_probe_matches_reference(clocks):
    ref_clock, port_clock = clocks
    ref, port = _stores(max_consecutive_failures=1)
    samples = _samples(n=6)
    for store in (ref, port):
        store.put_all(samples)
        store.nodes[0].failing = True
        store.fetch(0)                  # node 0 fails once: DOWN
    assert port.node_states() == ref.node_states()
    assert port.node_states()[0] == port_ds.DOWN
    for store, clock in ((ref, ref_clock), (port, port_clock)):
        store.nodes[0].failing = False
        clock.now += 1.0                # the probe falls due
        store.fetch(1)
    assert _state(port, sorted(samples)) == _state(ref, sorted(samples))
    assert port.node_states()[0] == port_ds.HEALTHY


def test_block_cache_scores_resident_samples_free(clocks):
    ref, port = _stores()
    samples = _samples(n=6)
    for store, blockcache in ((ref, ref_bc), (port, port_bc)):
        store.cache = blockcache.BlockCache(
            blockcache.CacheOptions(capacity_bytes=1 << 20))
        store.put_all(samples)
        store.fetch_many([0, 1, 2])
    for store in (ref, port):
        assert store.predicted_task_fetch([0, 1, 2]) == 0.0
        assert store.cache_covers([0, 1, 2])
        assert not store.cache_covers([0, 3])
    assert port.stats() == ref.stats()


# -- the driver with a datastore ----------------------------------------------


def _dataset(n=20, length=96, seed=0):
    rng = np.random.default_rng(seed)
    samples, months = {}, {}
    for i in range(n):
        m = int(rng.integers(length // 2, length))
        samples[i] = rng.standard_normal(m).astype(np.float32)
        months[i] = rng.integers(0, 12, m).astype(np.int32)
    return samples, months


def _port_spec(*, backend="threaded", wave="on", balanced="auto",
               prefetch="auto", cache=0, **kw):
    return port_platform.PlatformSpec(
        platform="BTS", n_workers=2, backend=backend, seed=5,
        knee_bytes=kw.pop("knee_bytes", KNEE), device="cpu",
        waves=port_driver.WaveOptions(wave=wave, max_wave=4),
        schedule=port_driver.ScheduleOptions(balanced=balanced,
                                             prefetch=prefetch),
        cache=CacheOptions(capacity_bytes=cache), **kw)


def _port_store(latency=2e-4, n_nodes=3):
    return port_ds.ReplicatedDataStore(
        n_initial=n_nodes,
        policy=port_ds.ReplicationPolicy(window=10_000,
                                         max_replicas=n_nodes),
        latency=lambda nbytes: latency)


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


def _grid_dataset():
    return netflix_dataset(NetflixSpec(n_movies=20, mean_ratings=160))


def _job(engine):
    """(samples, months, workload, knee_bytes) of a small job on one of
    the port's two device engines."""
    if engine == "kernel":
        samples, months = _dataset()
        return samples, months, PORT_WL, KNEE
    samples, months = _grid_dataset()
    mean = float(np.mean([a.nbytes for a in samples.values()]))
    return samples, months, pss.NETFLIX_LOW, 4 * mean


@pytest.mark.parametrize("engine", ["kernel", "torch"])
@pytest.mark.parametrize("backend,wave", [("threaded", "on"),
                                          ("threaded", "off"),
                                          ("simulated", "off")])
def test_job_with_a_store_equals_the_job_without(engine, backend, wave):
    samples, months, wl, knee = _job(engine)
    plain = port_platform.Platform(_port_spec(
        backend=backend, wave=wave, knee_bytes=knee)).run(samples, months,
                                                          wl)
    threaded = backend == "threaded"
    store = _port_store()
    rep = port_platform.Platform(
        _port_spec(backend=backend, wave=wave, knee_bytes=knee,
                   balanced="on", prefetch="on" if threaded else "off",
                   cache=1 << 20 if threaded else 0),
        datastore=store).run(samples, months, wl)
    assert rep.engine == engine
    _assert_bitwise(plain.result, rep.result)
    assert rep.n_tasks == plain.n_tasks
    assert rep.datastore_stats["replicas"] == 3.0
    if threaded:
        assert sum(store.fetch_counts().values()) > 0
        assert rep.prefetch_stats is not None
        assert rep.cache_stats is not None
        assert rep.phases["distribute"] >= 0.0


def test_repeat_run_on_one_store_hits_the_cache_and_stays_bitwise():
    samples, months = _dataset()
    store = _port_store()
    spec = _port_spec(balanced="on", prefetch="on", cache=1 << 20)
    first = port_platform.Platform(spec, datastore=store).run(samples,
                                                              months,
                                                              PORT_WL)
    second = port_platform.Platform(spec, datastore=store).run(samples,
                                                               months,
                                                               PORT_WL)
    _assert_bitwise(first.result, second.result)
    assert second.cache_stats["hits"] > first.cache_stats["hits"]
    # the run's hooks are detached afterwards; the cache stays
    assert store.on_state_change is None and store.telemetry is None
    assert store.cache is not None and store.cache.on_change is None


@pytest.mark.parametrize("wave", ["on", "off"])
def test_balanced_job_matches_reference(wave):
    samples, months = _dataset()
    common = dict(platform="BTS", n_workers=2, seed=5, knee_bytes=KNEE)
    sched = dict(balanced="on", prefetch="on")
    ref_store = ref_ds.ReplicatedDataStore(n_initial=3)
    port_store = port_ds.ReplicatedDataStore(n_initial=3)
    ref = ref_platform.Platform(ref_platform.PlatformSpec(
        waves=ref_driver.WaveOptions(wave=wave, max_wave=4),
        schedule=ref_driver.ScheduleOptions(**sched), **common),
        datastore=ref_store).run(samples, months, REF_WL)
    port = port_platform.Platform(port_platform.PlatformSpec(
        waves=port_driver.WaveOptions(wave=wave, max_wave=4),
        schedule=port_driver.ScheduleOptions(**sched), device="cpu",
        **common), datastore=port_store).run(samples, months, PORT_WL)
    ref_plan = ref_driver.plan_job(samples, months, REF_WL,
                                   sizing="kneepoint", engine="pallas",
                                   n_exec=2, knee_bytes=KNEE)
    port_plan = port_driver.plan_job(samples, months, PORT_WL,
                                     sizing="kneepoint", engine="kernel",
                                     n_exec=2, knee_bytes=KNEE, device="cpu")
    assert [t.sample_ids for t in port_plan.tasks] == \
        [t.sample_ids for t in ref_plan.tasks]
    assert port.n_tasks == ref.n_tasks
    assert port.task_size_bytes == ref.task_size_bytes
    assert port.max_task_bytes == ref.max_task_bytes
    assert set(port.datastore_stats) == set(ref.datastore_stats)
    assert set(port.prefetch_stats) == set(ref.prefetch_stats)
    assert sum(port_store.fetch_counts().values()) == \
        sum(ref_store.fetch_counts().values())
    np.testing.assert_array_equal(port.result["count"], ref.result["count"])
    for key in ("mean", "var"):
        np.testing.assert_allclose(port.result[key], ref.result[key],
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("option", ["balanced", "prefetch"])
def test_on_without_a_store_raises(option):
    samples, months = _dataset(n=4)
    spec = _port_spec(**{option: "on"})
    with pytest.raises(ValueError, match=f"{option}='on' needs a datastore"):
        port_platform.Platform(spec).run(samples, months, PORT_WL)


def test_prefetch_on_with_the_simulated_backend_raises():
    samples, months = _dataset(n=4)
    spec = _port_spec(backend="simulated", wave="off", prefetch="on")
    with pytest.raises(ValueError, match="threaded backend"):
        port_platform.Platform(spec, datastore=_port_store()).run(
            samples, months, PORT_WL)


def _all_nodes_killed_at(completions, n_nodes=3):
    return FaultInjector(FaultPlan(tuple(
        FaultEvent("node_kill", target=i, at_completions=completions)
        for i in range(n_nodes))))


def test_exact_job_whose_replicas_are_gone_raises_degraded():
    samples, months = _dataset()
    with pytest.raises(port_rec.DegradedJobError) as err:
        port_platform.Platform(
            _port_spec(wave="off", balanced="on", prefetch="off"),
            datastore=_port_store(),
            fault_injector=_all_nodes_killed_at(2)).run(samples, months,
                                                        PORT_WL)
    assert err.value.n_tasks > err.value.completed >= 2


def test_epsilon_job_whose_replicas_are_gone_stops_degraded():
    samples, months = _dataset()
    spec = _port_spec(wave="off", balanced="on", prefetch="off",
                      approx=port_driver.ApproxOptions(epsilon=1e-9,
                                                       min_tasks=1))
    rep = port_platform.Platform(
        spec, datastore=_port_store(),
        fault_injector=_all_nodes_killed_at(2)).run(samples, months, PORT_WL)
    assert rep.stop_reason.startswith("degraded:")
    assert 2 <= rep.tasks_executed < rep.n_tasks
    assert np.all(np.isfinite(rep.result["mean"]))
