"""The multi-tenant job service (``repro_torch.platform.service``) on the
CPU: the port's ``PlatformService`` against the port's own
``Platform.run`` (bit for bit) and against the reference's
``PlatformService`` on the same numpy inputs.

Both services get the identical ``samples`` / ``months`` dicts and the same
seeds; the port runs with ``device="cpu"``, where the kernel wrappers take
their plain versions, the reference its Pallas kernel in interpret mode
(``pallas``) or its ``jnp`` engine.  Tolerances against the reference are
the port's platform tests': ``moments``' ``mean`` and ``var`` to ``rtol=1e-5,
atol=1e-5`` (tests/test_torch_platform.py), the grid statistics' sums to
``rtol=2e-5`` with an absolute floor of ``1e-5 · max|sum|``
(tests/test_torch_subsample.py); counts agree exactly.

Scheduling is asserted on the scheduler's claim order and on
``fused_dispatches``, never on wall-clock finish times: the resident pool's
lock is held while a test submits its jobs (``_held``), so every job is in
the ready queue before the first claim, and one worker makes the claims in
a fixed order."""

import contextlib
import dataclasses
import os
import threading
import time
import warnings

import numpy as np
import pytest

import repro.platform as ref_platform
from repro.core import subsample as rss
from repro_torch.core import subsample as pss
from repro_torch.data import EagletSpec, NetflixSpec, eaglet_dataset, \
    netflix_dataset
from repro_torch.platform import (AdmissionError, AdmissionPolicy,
                                  ApproxOptions, CancelledError,
                                  FaultOptions, MomentsSpec, Platform,
                                  PlatformService, PlatformSpec,
                                  WaveOptions)
from repro_torch.platform import compute as pc
from repro_torch.platform import service as svc_mod
from repro_torch.platform.driver import JobCheckpointer
from repro_torch.platform.faults import (FaultEvent, FaultInjector,
                                         FaultPlan, InjectedCrash)

WL_SHAPE = dict(draws=4, draw_size=16)
WL = MomentsSpec(**WL_SHAPE)
KNEE = 4 * 96 * 4                 # about four samples of 96 fp32 each
MOMENTS_RTOL, MOMENTS_ATOL = 1e-5, 1e-5
GRID_RTOL, GRID_ATOL_SCALE = 2e-5, 1e-5
COUNT_KEYS = ("count", "hits", "n")


def _dataset(n=32, length=96, seed=0, ragged=True):
    """``n`` samples of fp32 (lengths from length/2 to length when
    ``ragged``, so a job has several block shapes) with months."""
    rng = np.random.default_rng(seed)
    samples, months = {}, {}
    for i in range(n):
        m = int(rng.integers(length // 2, length)) if ragged else length
        samples[i] = rng.standard_normal(m).astype(np.float32)
        months[i] = rng.integers(0, 12, m).astype(np.int32)
    return samples, months


def _spec(wave="on", max_wave=16, **kw):
    base = dict(platform="BTS", n_workers=2, backend="threaded",
                knee_bytes=KNEE, seed=0, device="cpu",
                waves=WaveOptions(wave=wave, max_wave=max_wave))
    base.update(kw)
    return PlatformSpec(**base)


@pytest.fixture(scope="module")
def datasets():
    return {
        "moments": _dataset(),
        "netflix": netflix_dataset(NetflixSpec(n_movies=24,
                                               mean_ratings=1024)),
        "eaglet": eaglet_dataset(EagletSpec(n_families=24,
                                            mean_markers=512)),
    }


# name -> (dataset, port workload, reference workload, knee bytes)
CASES = {
    "moments": ("moments", WL, ref_platform.MomentsSpec(**WL_SHAPE), KNEE),
    "netflix_high": ("netflix", pss.NETFLIX_HIGH, rss.NETFLIX_HIGH,
                     4 * 1024 * 4),
    "netflix_low": ("netflix", pss.NETFLIX_LOW, rss.NETFLIX_LOW,
                    4 * 1024 * 4),
    "eaglet": ("eaglet", pss.EAGLET, rss.EAGLET, 8 * 512 * 4),
}


def _case(datasets, name):
    data, port_wl, ref_wl, knee = CASES[name]
    samples, months = datasets[data]
    return samples, months, port_wl, ref_wl, knee


def _assert_bitwise(want, got, what=""):
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      np.asarray(got[key]),
                                      err_msg=f"{what} {key}")


def _assert_close_to_reference(want, got, statistic):
    assert want.keys() == got.keys()
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        assert g.shape == w.shape, key
        if key in COUNT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif statistic == "moments":
            np.testing.assert_allclose(g, w, rtol=MOMENTS_RTOL,
                                       atol=MOMENTS_ATOL, err_msg=key)
        else:
            np.testing.assert_allclose(
                g, w, rtol=GRID_RTOL,
                atol=GRID_ATOL_SCALE * float(np.nanmax(np.abs(w))),
                err_msg=key)


@contextlib.contextmanager
def _held(svc):
    """The resident pool's lock held (it is re-entrant, so this thread's
    submits go through): no worker claims until the block ends, so every
    job submitted inside it is in the ready queue before the first claim."""
    with svc._pool._cond:
        yield


def _record_claims(svc):
    """The job ids of every batch the pool's scheduler hands out from now
    on, in claim order (appended under the pool's lock)."""
    sched = svc._pool.sched
    claims = []
    claim = sched.claim

    def recording(*args, **kwargs):
        batch = claim(*args, **kwargs)
        if batch:
            claims.append(tuple(j.job_id for j, _ in batch))
        return batch

    sched.claim = recording
    return claims


def _runs(claims):
    """Claim order as the chosen job of each claim (its first task's)."""
    return [c[0] for c in claims]


# -- submit ≡ the port's Platform.run, bit for bit ----------------------------


@pytest.mark.parametrize("name,wave,backend", [
    (name, wave, "threaded") for name, wave in (
        ("moments", "on"), ("moments", "off"), ("netflix_high", "on"),
        ("netflix_high", "off"), ("netflix_low", "auto"), ("eaglet", "on"),
        ("eaglet", "off"))] + [
    # the simulator runs per task (virtual time has no waves)
    (name, "auto", "simulated") for name in CASES])
def test_submit_bit_identical_to_platform_run(datasets, name, wave, backend):
    samples, months, wl, _, knee = _case(datasets, name)
    spec = _spec(wave=wave, backend=backend, n_workers=3, knee_bytes=knee,
                 seed=11)
    base = Platform(spec).run(samples, months, wl)
    with PlatformService(spec) as svc:
        handle = svc.register_dataset(samples, months)
        ticket = svc.submit(handle, wl, seed=11)
        got = ticket.result(timeout=120)
    _assert_bitwise(base.result, got, f"{name}/{wave}/{backend}")
    assert ticket.n_tasks == base.n_tasks
    assert ticket.tasks_executed == base.n_tasks


@pytest.mark.parametrize("name", ["moments", "netflix_low"])
def test_fused_results_equal_sequential_results(datasets, name):
    samples, months, wl, _, knee = _case(datasets, name)
    spec = _spec(knee_bytes=knee, n_workers=1)
    seq = {s: Platform(dataclasses.replace(spec, seed=s)).run(
        samples, months, wl).result for s in range(4)}
    with PlatformService(spec) as svc:
        handle = svc.register_dataset(samples, months)
        svc.submit(handle, wl, seed=99).result(timeout=120)  # the class
        fused_before = svc.stats()["fused_dispatches"]
        with _held(svc):
            tickets = {s: svc.submit(handle, wl, seed=s) for s in range(4)}
        for s, ticket in tickets.items():
            _assert_bitwise(seq[s], ticket.result(timeout=120), f"seed {s}")
        assert svc.stats()["fused_dispatches"] > fused_before


# -- the port's service against the reference's ------------------------------


@pytest.mark.parametrize("name,ref_engine", [
    ("moments", "pallas"), ("netflix_high", "jnp"),
    ("netflix_low", "jnp"), ("eaglet", "jnp")])
def test_service_matches_reference_service(datasets, name, ref_engine):
    samples, months, wl, ref_wl, knee = _case(datasets, name)
    common = dict(platform="BTS", n_workers=2, backend="threaded",
                  knee_bytes=knee, seed=5)
    ref_spec = ref_platform.PlatformSpec(
        engine=ref_engine, waves=ref_platform.WaveOptions(max_wave=8),
        **common)
    port_spec = PlatformSpec(device="cpu", waves=WaveOptions(max_wave=8),
                             **common)
    with ref_platform.PlatformService(ref_spec) as ref_svc:
        ref_h = ref_svc.register_dataset(samples, months)
        ref_t = ref_svc.submit(ref_h, ref_wl, seed=5)
        want = ref_t.result(timeout=300)
    with PlatformService(port_spec) as svc:
        handle = svc.register_dataset(samples, months)
        ticket = svc.submit(handle, wl, seed=5)
        got = ticket.result(timeout=120)
    _assert_close_to_reference(want, got, wl.statistic)
    (ref_qc,), (port_qc,) = ref_h._classes.values(), handle._classes.values()
    assert [t.sample_ids for t in port_qc.plan.tasks] == \
        [t.sample_ids for t in ref_qc.plan.tasks]
    assert [port_qc.plan.task_shape(t) for t in port_qc.plan.tasks] == \
        [ref_qc.plan.task_shape(t) for t in ref_qc.plan.tasks]
    assert port_qc.engine == ("kernel" if wl.statistic == "moments"
                              else "torch")
    # the arena and then only slot and seed vectors, 8 bytes a task
    assert ticket.bytes_uploaded == ref_t.bytes_uploaded
    assert ticket.n_tasks == ref_t.n_tasks


# -- the registry: cached arenas, separate query classes ----------------------


@pytest.mark.parametrize("name", ["moments", "netflix_low"])
def test_repeat_queries_hit_the_cached_arena(datasets, monkeypatch, name):
    samples, months, wl, _, knee = _case(datasets, name)
    waves = []
    run_map_wave = pc.run_map_wave

    def counted(arena, tasks, *args, **kwargs):
        waves.append(len(tasks))
        return run_map_wave(arena, tasks, *args, **kwargs)

    monkeypatch.setattr(pc, "run_map_wave", counted)
    with PlatformService(_spec(knee_bytes=knee)) as svc:
        handle = svc.register_dataset(samples, months, name="cached")
        first = svc.submit(handle, wl, seed=1)
        first.result(timeout=120)
        (qc,) = handle._classes.values()
        warm_ups = len(waves) - first.device_dispatches
        repeats = []
        for seed in (2, 3, 4):
            before = len(waves)
            ticket = svc.submit(handle, wl, seed=seed)
            ticket.result(timeout=120)
            repeats.append((ticket, len(waves) - before))
        assert len(handle._classes) == 1
    n = first.n_tasks
    # one warm-up wave a block shape, paid by the first query only
    assert warm_ups == len({qc.plan.task_shape(t) for t in qc.plan.tasks})
    assert first.bytes_uploaded == qc.arena_bytes + 8.0 * n
    assert qc.arena_bytes > 10 * 8.0 * n
    for ticket, launched in repeats:
        assert ticket.bytes_uploaded == 8.0 * n      # slot + seed vectors
        assert launched == ticket.device_dispatches  # no warm-up


def test_query_classes_are_isolated(datasets):
    samples, months = datasets["netflix"]
    other = MomentsSpec(draws=2, draw_size=16)     # 32 draws vs WL's 64
    with PlatformService(_spec(knee_bytes=4 * 1024 * 4)) as svc:
        handle = svc.register_dataset(samples, months)
        a = svc.submit(handle, WL, seed=0)
        b = svc.submit(handle, other, seed=0)
        c = svc.submit(handle, pss.NETFLIX_LOW, seed=0)
        ra, rb = a.result(timeout=120), b.result(timeout=120)
        c.result(timeout=120)
        classes = list(handle._classes.values())
    assert len(classes) == 3                     # one arena a query class
    assert len({qc.uid for qc in classes}) == 3
    assert sorted(qc.engine for qc in classes) == ["kernel", "kernel",
                                                   "torch"]
    assert all(qc.wave_ctx is not None for qc in classes)
    assert ra["count"] == 2.0 * rb["count"]


@pytest.mark.parametrize("name", ["moments", "netflix_low", "eaglet"])
def test_per_task_class_warms_up_and_counts_its_dispatches(
        datasets, monkeypatch, name):
    """A per-task query class of either device engine warms one task a
    block shape when it is built, and each task counts as a dispatch with
    its block's bytes (and the months', for the ``torch`` engine): the
    service names the port's engines, ``kernel`` and ``torch``, where the
    reference names ``pallas`` and ``jnp``."""
    samples, months, wl, _, knee = _case(datasets, name)
    calls = []
    run_map_task = pc.run_map_task

    def counted(block, mo, seed, workload, engine, **kwargs):
        calls.append(engine)
        return run_map_task(block, mo, seed, workload, engine, **kwargs)

    monkeypatch.setattr(pc, "run_map_task", counted)
    with PlatformService(_spec(wave="off", knee_bytes=knee)) as svc:
        handle = svc.register_dataset(samples, months)
        ticket = svc.submit(handle, wl, seed=3)
        ticket.result(timeout=120)
        (qc,) = handle._classes.values()
    engine = "kernel" if wl.statistic == "moments" else "torch"
    assert qc.engine == engine and qc.wave_ctx is None
    shapes = {qc.plan.task_shape(t) for t in qc.plan.tasks}
    assert len(calls) == len(shapes) + ticket.n_tasks
    assert set(calls) == {engine}
    assert ticket.device_dispatches == ticket.n_tasks
    want = sum(float(b.nbytes) + (float(m.nbytes) if engine == "torch"
                                  else 0.0)
               for b, m in (qc.block(t) for t in qc.plan.tasks))
    assert ticket.bytes_uploaded == want


# -- refusals -------------------------------------------------------------------


def test_mesh_devices_raises():
    """The reference's contract: ``mesh_devices`` without wave execution
    raises ``ValueError`` on submit; with waves, a 1-device CPU mesh
    serves the unsharded service's result bit for bit."""
    samples, months = _dataset(n=8)
    with PlatformService(_spec(waves=WaveOptions(wave="off",
                                                 mesh_devices=1))) as svc:
        handle = svc.register_dataset(samples, months)
        with pytest.raises(ValueError, match="mesh_devices"):
            svc.submit(handle, WL)
    results = []
    for mesh in (None, 1):
        with PlatformService(_spec(waves=WaveOptions(
                wave="on", mesh_devices=mesh))) as svc:
            handle = svc.register_dataset(samples, months)
            results.append(svc.submit(handle, WL).result(timeout=120))
    _assert_bitwise(results[0], results[1], "mesh 1")


@pytest.mark.parametrize("bad", ["backend", "admission"])
def test_bad_backend_or_admission_mode_raises(bad):
    with pytest.raises(ValueError):
        if bad == "backend":
            PlatformService(_spec(backend="vh"))
        else:
            PlatformService(_spec(), admission=AdmissionPolicy(mode="drop"))


def test_public_names_match_the_reference():
    import repro.platform.service as ref_service
    import repro_torch.platform as port_platform

    names = ("AdmissionError", "CancelledError", "AdmissionPolicy",
             "workload_key", "QueryClass", "DatasetHandle",
             "PartialEstimate", "JobTicket", "PlatformService", "QUEUED",
             "RUNNING", "DONE", "FAILED", "REJECTED", "CANCELLED")
    for name in names:
        assert hasattr(svc_mod, name) and hasattr(ref_service, name), name
    for name in ("QUEUED", "RUNNING", "DONE", "FAILED", "REJECTED",
                 "CANCELLED"):
        assert getattr(svc_mod, name) == getattr(ref_service, name)
    assert svc_mod.workload_key(WL) == ref_service.workload_key(
        ref_platform.MomentsSpec(**WL_SHAPE))
    service_exports = {"PlatformService", "AdmissionPolicy",
                       "DatasetHandle", "JobTicket", "PartialEstimate"}
    assert service_exports <= set(ref_platform.__all__)
    assert service_exports <= set(port_platform.__all__)
    assert port_platform.PlatformService is PlatformService


# -- scheduling: claim order and fusion, the pool held ------------------------


def _warm(svc, handle, wl=WL):
    svc.submit(handle, wl, seed=99).result(timeout=120)


def test_drr_small_job_not_starved_by_big_job():
    big_s, big_m = _dataset(256, ragged=False)
    small_s, small_m = _dataset(32, seed=1, ragged=False)
    with PlatformService(_spec(n_workers=1)) as svc:
        big_h = svc.register_dataset(big_s, big_m)
        small_h = svc.register_dataset(small_s, small_m)
        _warm(svc, big_h)
        _warm(svc, small_h)
        claims = _record_claims(svc)
        with _held(svc):
            big = svc.submit(big_h, WL, seed=1)       # 64 tasks, waves of 16
            small = svc.submit(small_h, WL, seed=2)   # 8 tasks
        small.result(timeout=120)
        big.result(timeout=120)
    b, s = big.job_id, small.job_id
    # deficit round robin: the small job's one wave goes second, not last
    assert _runs(claims) == [b, s, b, b, b]
    assert [len(c) for c in claims] == [16, 8, 16, 16, 16]


def test_deadline_boost_serves_the_urgent_job_first():
    samples, months = _dataset(256, ragged=False)
    small_s, small_m = _dataset(32, seed=1, ragged=False)
    policy = AdmissionPolicy(slo_aware=False)
    with PlatformService(_spec(n_workers=1), admission=policy) as svc:
        big_h = svc.register_dataset(samples, months)
        small_h = svc.register_dataset(small_s, small_m)
        _warm(svc, big_h)
        _warm(svc, small_h)
        claims = _record_claims(svc)
        with _held(svc):
            big = svc.submit(big_h, WL, seed=1)
            # a deadline already past by the first claim: urgent from then on
            urgent = svc.submit(small_h, WL, seed=2, deadline=1e-6)
        urgent.result(timeout=120)
        big.result(timeout=120)
    assert _runs(claims) == [urgent.job_id] + [big.job_id] * 4


def test_priority_tier_served_first():
    samples, months = _dataset(256, ragged=False)
    small_s, small_m = _dataset(32, seed=1, ragged=False)
    with PlatformService(_spec(n_workers=1)) as svc:
        big_h = svc.register_dataset(samples, months)
        small_h = svc.register_dataset(small_s, small_m)
        _warm(svc, big_h)
        _warm(svc, small_h)
        claims = _record_claims(svc)
        with _held(svc):
            low = svc.submit(big_h, WL, seed=1, priority=0)
            high = svc.submit(small_h, WL, seed=2, priority=5)
        high.result(timeout=120)
        low.result(timeout=120)
    assert _runs(claims) == [high.job_id] + [low.job_id] * 4


def test_concurrent_jobs_fuse_waves_across_jobs():
    # 10 tasks a job at a wave width of 16 (one worker): each claim fills
    # its job's tail with a peer's tasks
    samples, months = _dataset(40, ragged=False)
    with PlatformService(_spec(n_workers=1)) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)
        before = svc.stats()
        claims = _record_claims(svc)
        with _held(svc):
            tickets = [svc.submit(handle, WL, seed=i) for i in range(8)]
        for t in tickets:
            t.result(timeout=120)
        after = svc.stats()
    ids = [t.job_id for t in tickets]
    assert [len(c) for c in claims] == [16, 16, 16, 16, 16]
    assert claims[0] == (ids[0],) * 10 + (ids[1],) * 6
    fused = after["fused_dispatches"] - before["fused_dispatches"]
    assert fused == sum(1 for c in claims if len(set(c)) > 1) == 5
    assert after["device_dispatches"] - before["device_dispatches"] == 5
    # a fused wave counts once for each job it carried
    assert sum(t.device_dispatches for t in tickets) == sum(
        len(set(c)) for c in claims)
    for seed, t in enumerate(tickets):
        assert t.status == "done" and t.seed == seed


# -- admission ------------------------------------------------------------------


def test_admission_shed_rejects_over_capacity():
    samples, months = _dataset(64)
    policy = AdmissionPolicy(max_active_jobs=1, mode="shed")
    with PlatformService(_spec(n_workers=1), admission=policy) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)
        with _held(svc):
            first = svc.submit(handle, WL, seed=0)
            shed = svc.submit(handle, WL, seed=1)
        first.result(timeout=120)
        stats = svc.stats()
    assert shed.status == "rejected" and "max_active_jobs" in shed.reason
    with pytest.raises(AdmissionError):
        shed.result(timeout=5)
    assert stats["jobs_rejected"] == 1


def test_admission_queue_admits_when_capacity_frees():
    samples, months = _dataset(64)
    policy = AdmissionPolicy(max_active_jobs=1, mode="queue")
    spec = _spec(n_workers=1)
    solo = Platform(dataclasses.replace(spec, seed=1)).run(samples, months,
                                                            WL)
    with PlatformService(spec, admission=policy) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)
        with _held(svc):
            first = svc.submit(handle, WL, seed=0)
            queued = svc.submit(handle, WL, seed=1)
            assert queued.status == "queued"
            assert svc.stats()["jobs_waiting"] == 1
        first.result(timeout=120)
        got = queued.result(timeout=120)
    _assert_bitwise(solo.result, got, "queued job")
    assert queued.queue_wait is not None and queued.queue_wait >= 0


def test_slo_aware_admission_rejects_unmeetable_deadline():
    samples, months = _dataset(32)
    with PlatformService(_spec(n_workers=1)) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)                            # seeds the task EMA
        doomed = svc.submit(handle, WL, seed=1, deadline=1e-9)
    assert doomed.status == "rejected"
    assert "slo" in doomed.reason
    with pytest.raises(AdmissionError):
        doomed.result(timeout=5)


def test_bad_error_target_reserves_no_slot():
    samples, months = _dataset(32)
    with PlatformService(_spec()) as svc:
        handle = svc.register_dataset(samples, months)
        with pytest.raises(ValueError, match="epsilon"):
            svc.submit(handle, WL, approx=ApproxOptions(epsilon=-1.0))
        with pytest.raises(ValueError, match="confidence"):
            svc.submit(handle, WL, approx=ApproxOptions(epsilon=0.5,
                                                        confidence=1.5))
        assert svc.stats()["jobs_active"] == 0
        ok = svc.submit(handle, WL, seed=0)
        ok.result(timeout=120)
    assert ok.status == "done"


# -- cancel, close, failures -----------------------------------------------------


def test_cancel_running_job_leaves_peer_bitwise():
    samples, months = _dataset(256, ragged=False)
    spec = _spec(n_workers=1)
    solo = Platform(dataclasses.replace(spec, seed=2)).run(samples, months,
                                                            WL)
    with PlatformService(spec) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)
        with _held(svc):
            victim = svc.submit(handle, WL, seed=1)
            bystander = svc.submit(handle, WL, seed=2)
            assert victim.status == "running"
            assert svc.cancel(victim)
        with pytest.raises(CancelledError):
            victim.result(timeout=30)
        got = bystander.result(timeout=120)
        assert svc.stats()["pending_tasks"] == 0
    assert victim.status == "cancelled" and bystander.status == "done"
    assert not svc.cancel(victim)                # already terminal
    _assert_bitwise(solo.result, got, "bystander")


def test_cancel_queued_job():
    samples, months = _dataset(64)
    policy = AdmissionPolicy(max_active_jobs=1)
    with PlatformService(_spec(n_workers=1), admission=policy) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)
        with _held(svc):
            first = svc.submit(handle, WL, seed=0)
            queued = svc.submit(handle, WL, seed=1)
            assert queued.status == "queued"
            assert svc.cancel(queued)
            assert svc.stats()["jobs_waiting"] == 0
        first.result(timeout=120)
    with pytest.raises(CancelledError):
        queued.result(timeout=5)


def test_close_unblocks_outstanding_jobs():
    """close() never leaves a result() hanging: a running ticket either
    finished or fails with a service-closed error, and a ticket still
    waiting for admission is rejected."""
    samples, months = _dataset(256)
    policy = AdmissionPolicy(max_active_jobs=1)
    svc = PlatformService(_spec(n_workers=1), admission=policy)
    handle = svc.register_dataset(samples, months)
    _warm(svc, handle)
    with _held(svc):
        ticket = svc.submit(handle, WL, seed=1)
        waiting = svc.submit(handle, WL, seed=2)
        assert waiting.status == "queued"
    svc.close()
    try:
        ticket.result(timeout=30)
        assert ticket.status == "done"
    except RuntimeError as e:
        assert ticket.status == "failed" and "closed" in str(e)
    with pytest.raises((AdmissionError, RuntimeError)):
        waiting.result(timeout=30)
    assert waiting.status in ("rejected", "failed")
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(handle, WL)


def test_batch_failure_isolates_other_jobs(datasets):
    samples, months = _dataset(32)
    n_s, n_m = datasets["netflix"]
    spec = _spec(n_workers=1, knee_bytes=4 * 1024 * 4)
    base = Platform(spec).run(n_s, n_m, pss.NETFLIX_LOW)
    with PlatformService(spec) as svc:
        bad_h = svc.register_dataset(samples, months)
        good_h = svc.register_dataset(n_s, n_m)
        _warm(svc, bad_h)
        (qc,) = bad_h._classes.values()

        def boom(tasks, seeds):
            raise RuntimeError("injected batch failure")

        qc.wave_ctx.run = boom
        with _held(svc):
            bad = svc.submit(bad_h, WL, seed=1)
            good = svc.submit(good_h, pss.NETFLIX_LOW, seed=0)
        with pytest.raises(RuntimeError, match="injected batch failure"):
            bad.result(timeout=60)
        got = good.result(timeout=120)
    assert bad.status == "failed" and good.status == "done"
    _assert_bitwise(base.result, got, "healthy job")


# -- partial estimates, early stop ----------------------------------------------


def test_partial_estimates_stream_while_running():
    samples, months = _dataset(256, ragged=False)
    with PlatformService(_spec(n_workers=1)) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)
        (qc,) = handle._classes.values()
        gate, waves = threading.Event(), []
        run = qc.wave_ctx.run

        def gated(tasks, seeds):
            waves.append(len(tasks))
            if len(waves) > 1:
                assert gate.wait(60), "the test never opened the gate"
            return run(tasks, seeds)

        qc.wave_ctx.run = gated
        ticket = svc.submit(handle, WL, seed=1)
        try:
            assert ticket.partial() is None or ticket.progress()[0] > 0
            tree = ticket.tree
            tree.wait_leaves(16, timeout=60)      # the first wave, no more
            partial = None
            for _ in range(6000):
                partial = ticket.partial()
                if partial is not None and partial["tasks_in"] >= 16:
                    break
                time.sleep(1e-2)
            done, total = ticket.progress()
        finally:
            gate.set()
        final = ticket.result(timeout=120)
    assert (done, total) == (16, 64)
    assert partial["tasks_in"] == 16 and partial["n_tasks"] == 64
    assert {"value", "ci_low", "ci_high", "half_width",
            "estimate"} <= set(partial)
    assert set(partial["estimate"]) == {"mean", "var", "count"}
    assert float(partial["estimate"]["count"]) == 16 * 64
    assert np.isfinite(partial["half_width"])
    assert float(final["count"]) == 64 * 64
    done_partial = ticket.partial()
    np.testing.assert_array_equal(done_partial["estimate"]["mean"],
                                  final["mean"])


def test_early_stop_frees_capacity_for_peers():
    samples, months = _dataset(256, ragged=False)
    spec = _spec(n_workers=1, max_wave=8)
    solo = Platform(dataclasses.replace(spec, seed=1)).run(samples, months,
                                                            WL)
    with PlatformService(spec) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)
        with _held(svc):
            eps = svc.submit(handle, WL, seed=0,
                             approx=ApproxOptions(epsilon=0.6, min_tasks=8))
            peer = svc.submit(handle, WL, seed=1)
        r_eps = eps.result(timeout=120)
        r_peer = peer.result(timeout=120)
    assert eps.status == "done"
    assert 0 < eps.tasks_cancelled and eps.tasks_executed < eps.n_tasks
    assert eps.tasks_executed + eps.tasks_cancelled == eps.n_tasks
    assert "converged" in eps.stop_reason
    assert float(r_eps["count"]) == float(
        WL.draws * WL.draw_size * eps.tasks_executed)
    assert eps.final_ci is not None and eps.final_ci["tasks_in"] >= 8
    assert eps.final_ci["half_width"] <= 0.6
    assert peer.tasks_cancelled == 0
    _assert_bitwise(solo.result, r_peer, "peer")


def test_epsilon_defaults_from_spec():
    samples, months = _dataset(256, ragged=False)
    spec = _spec(n_workers=1, max_wave=8,
                 approx=ApproxOptions(epsilon=0.6, min_tasks=8))
    with PlatformService(spec) as svc:
        handle = svc.register_dataset(samples, months)
        _warm(svc, handle)
        with _held(svc):
            dflt = svc.submit(handle, WL, seed=0)          # inherits it
            forced = svc.submit(handle, WL, seed=0,
                                approx=ApproxOptions())    # exact
        dflt.result(timeout=120)
        forced.result(timeout=120)
    assert dflt.epsilon == 0.6 and dflt.tasks_cancelled > 0
    assert forced.epsilon is None and forced.tasks_cancelled == 0
    assert forced.tasks_executed == forced.n_tasks


def test_simulated_backend_early_stop():
    samples, months = _dataset(256, ragged=False)
    with PlatformService(_spec(wave="auto", backend="simulated")) as svc:
        handle = svc.register_dataset(samples, months)
        t = svc.submit(handle, WL, seed=0,
                       approx=ApproxOptions(epsilon=0.6, min_tasks=8))
        res = t.result(timeout=120)
    assert t.tasks_cancelled > 0 and t.tasks_executed < t.n_tasks
    assert "converged" in t.stop_reason
    assert float(res["count"]) == float(
        WL.draws * WL.draw_size * t.tasks_executed)


def test_legacy_error_kwargs_warn_and_still_apply():
    samples, months = _dataset(32)
    with PlatformService(_spec()) as svc:
        handle = svc.register_dataset(samples, months)
        with pytest.warns(DeprecationWarning, match="approx"):
            t = svc.submit(handle, WL, seed=0, epsilon=None)
        t.result(timeout=120)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            svc.submit(handle, WL, seed=0,
                       approx=ApproxOptions()).result(timeout=120)
    assert t.epsilon is None and t.tasks_executed == t.n_tasks


# -- checkpoint/resume through submit -------------------------------------------


@pytest.mark.parametrize("name", ["moments", "netflix_high"])
def test_checkpoint_crash_and_resume_through_submit(datasets, tmp_path,
                                                    name):
    samples, months, wl, _, knee = _case(datasets, name)
    # one worker: the wave that crashes at save 2 is the job's only one,
    # so no other worker's leaves reach the checkpoint after the crash
    spec = _spec(n_workers=1, knee_bytes=knee,
                 faults=FaultOptions(checkpoint_every=2))
    plain = Platform(dataclasses.replace(spec, seed=4)).run(samples, months,
                                                             wl)
    ckpt = str(tmp_path / "ck")
    inj = FaultInjector(FaultPlan((FaultEvent("checkpoint_crash",
                                              at_saves=2),)))
    with PlatformService(spec, fault_injector=inj) as svc:
        handle = svc.register_dataset(samples, months)
        crashed = svc.submit(handle, wl, seed=4, checkpoint_dir=ckpt)
        with pytest.raises(InjectedCrash):
            crashed.result(timeout=120)
    assert crashed.status == "failed"
    restored, n_tasks = JobCheckpointer.load(ckpt)
    assert n_tasks == plain.n_tasks and 0 < len(restored) < n_tasks
    with PlatformService(spec) as svc:
        handle = svc.register_dataset(samples, months)
        resumed = svc.submit(handle, wl, seed=4, resume_from=ckpt)
        got = resumed.result(timeout=120)
    _assert_bitwise(plain.result, got, "resumed")
    assert resumed.tasks_restored == len(restored)


def test_checkpointed_job_saves_and_resumes_when_complete(datasets,
                                                          tmp_path):
    samples, months = datasets["moments"]
    spec = _spec(faults=FaultOptions(checkpoint_every=2))
    ckpt = str(tmp_path / "ck")
    with PlatformService(spec) as svc:
        handle = svc.register_dataset(samples, months)
        full = svc.submit(handle, WL, seed=4, checkpoint_dir=ckpt)
        want = full.result(timeout=120)
        assert full.checkpointer.saves == full.n_tasks // 2
        again = svc.submit(handle, WL, seed=4, resume_from=ckpt)
        got = again.result(timeout=120)
        # everything restored: the job finishes off the tree, no dispatch
        assert again.tasks_restored == again.n_tasks
        assert again.device_dispatches == 0
        other = svc.register_dataset(*_dataset(12), name="other")
        with pytest.raises(ValueError, match="resume needs the same"):
            svc.submit(other, WL, seed=4, resume_from=ckpt)
        assert svc.stats()["jobs_active"] == 0
    _assert_bitwise(want, got, "restored")


def test_failed_job_leaves_no_save_in_flight(tmp_path):
    """The port's service joins a failed job's save in flight before its
    ``result()`` unblocks (the reference's service leaves it running)."""
    samples, months = _dataset(64, ragged=False)
    spec = _spec(n_workers=1, faults=FaultOptions(checkpoint_every=1))
    inj = FaultInjector(FaultPlan((FaultEvent("checkpoint_crash",
                                              at_saves=6),)))
    ckpt = str(tmp_path / "ck")
    with PlatformService(spec, fault_injector=inj) as svc:
        handle = svc.register_dataset(samples, months)
        ticket = svc.submit(handle, WL, seed=0, checkpoint_dir=ckpt)
        with pytest.raises(InjectedCrash):
            ticket.result(timeout=120)
        assert ticket.checkpointer.mgr._thread is None
        steps = sorted(os.listdir(ckpt))
    assert steps and not any(s.endswith(".tmp") for s in steps)
    restored, _ = JobCheckpointer.load(ckpt)
    assert len(restored) == 5


# -- observability -----------------------------------------------------------


def test_stats_and_telemetry_snapshot(tmp_path):
    samples, months = _dataset(32)
    with PlatformService(_spec(telemetry=True)) as svc:
        handle = svc.register_dataset(samples, months)
        ticket = svc.submit(handle, WL, seed=0)
        ticket.result(timeout=120)
        stats = svc.stats()
        snap = svc.telemetry_snapshot()
        trace = svc.write_trace(str(tmp_path / "trace.json"))
        svc.write_report(str(tmp_path / "report.html"))
        with pytest.raises(RuntimeError, match="monitor disabled"):
            svc.monitor_snapshot()
    assert stats["jobs_completed"] == 1 and stats["jobs_active"] == 0
    assert stats["device_dispatches"] == ticket.device_dispatches
    assert sum(stats["wave_sizes"]) == ticket.n_tasks
    assert stats["bytes_uploaded"] == ticket.bytes_uploaded
    assert snap["service"]["jobs_completed"] == 1
    assert trace and (tmp_path / "report.html").exists()
    assert ticket.stats()["status"] == "done"
    assert ticket.latency is not None and ticket.queue_wait is not None
