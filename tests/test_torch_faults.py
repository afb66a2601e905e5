"""Fault injection, checkpointing and resume in the PyTorch port
(``repro_torch.platform.faults``, ``repro_torch.checkpoint``, the driver's
``JobCheckpointer`` and ``run(resume_from=...)``) against the JAX
reference, and the reference's recovery invariants inside the port.

A fault plan counts logical progress (claims, completions, saves), so a
seeded plan is the same list of events in both packages.  A recovered job
must equal the fault-free job bit for bit: lease reclamation and
first-completion-wins settle each task once, per-task seeds make a rerun
draw the same rows, and the reduce tree's fixed shape adds the partials in
one order.  The port runs with ``device="cpu"`` (the kernel wrappers'
plain versions).

Checkpoints share one on-disk format, so either package restores the
other's: the same npz leaves, JAX key paths as names, bf16 as its bits.
Against the reference's results, ``mean`` and ``var`` agree to
``rtol=1e-5, atol=1e-5`` (the tolerance ``tests/test_torch_platform.py``
states) and counts exactly."""

import dataclasses
import json
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.platform as ref_platform
import repro_torch.platform as port_platform
from repro.checkpoint import manager as ref_mgr
from repro.platform import driver as ref_driver
from repro.platform import faults as ref_faults
from repro_torch.checkpoint import manager as port_mgr
from repro_torch.core import datastore as port_ds
from repro_torch.core import recovery as port_rec
from repro_torch.platform import driver as port_driver
from repro_torch.platform import faults as port_faults
from repro_torch.platform.faults import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    InjectedCrash,
)
from repro_torch.tree import tree_leaves_with_path

WL_SHAPE = dict(draws=4, draw_size=16)
REF_WL = ref_platform.MomentsSpec(**WL_SHAPE)
PORT_WL = port_platform.MomentsSpec(**WL_SHAPE)
KNEE = 2 * 96 * 4                 # about two samples of 96 fp32 each
RTOL, ATOL = 1e-5, 1e-5


def _dataset(n=48, length=96, seed=0):
    rng = np.random.default_rng(seed)
    samples, months = {}, {}
    for i in range(n):
        m = int(rng.integers(length // 2, length))
        samples[i] = rng.standard_normal(m).astype(np.float32)
        months[i] = rng.integers(0, 12, m).astype(np.int32)
    return samples, months


def _spec(pkg=port_platform, *, wave="on", backend="threaded",
          faults=None, **kw):
    driver = port_driver if pkg is port_platform else ref_driver
    if pkg is port_platform:
        kw["device"] = "cpu"
    return pkg.PlatformSpec(
        platform="BTS", n_workers=2, backend=backend, seed=5,
        knee_bytes=KNEE, waves=driver.WaveOptions(wave=wave, max_wave=4),
        faults=faults or driver.FaultOptions(), **kw)


def _run(spec, samples, months, pkg=port_platform, **kw):
    resume = kw.pop("resume_from", None)
    wl = PORT_WL if pkg is port_platform else REF_WL
    return pkg.Platform(spec, **kw).run(samples, months, wl,
                                        resume_from=resume)


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


def _assert_close(ref, port):
    np.testing.assert_array_equal(port["count"], ref["count"])
    for key in ("mean", "var"):
        np.testing.assert_allclose(port[key], ref[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)


# -- FaultPlan / FaultInjector -------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 23, 2024])
@pytest.mark.parametrize("shape", [
    dict(n_workers=2, n_nodes=3, n_tasks=12),
    dict(n_workers=4, n_nodes=3, n_tasks=16, worker_crashes=2,
         node_kills=2, latency_spikes=1, revive_after=2),
    dict(n_workers=8, n_nodes=5, n_tasks=278, worker_crashes=3,
         node_kills=1, latency_spikes=3, revive_after=10)])
def test_fault_plan_from_seed_matches_reference(seed, shape):
    ref = ref_faults.FaultPlan.from_seed(seed, **shape)
    port = FaultPlan.from_seed(seed, **shape)
    assert [dataclasses.astuple(e) for e in port.events] == \
        [dataclasses.astuple(e) for e in ref.events]
    assert port_faults.KINDS == ref_faults.KINDS


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultEvent(kind="meteor_strike")


def test_injector_fires_at_exact_claim_completion_and_save_counts():
    plan = FaultPlan((
        FaultEvent("node_kill", target=0, at_completions=3),
        FaultEvent("node_latency", target=1, at_completions=2, factor=4.0),
        FaultEvent("worker_crash", target=1, at_claims=2),
        FaultEvent("checkpoint_crash", at_saves=2)))
    inj = FaultInjector(plan)
    store = port_ds.ReplicatedDataStore(2, latency=lambda nbytes: 1e-4)
    store.put_all({0: np.zeros(4, np.float32)})
    inj.attach_store(store)
    emit = inj.wrap_emit(None)
    emit(0, None)
    assert inj.fired == []
    emit(1, None)                       # second completion: the spike
    assert [e.kind for e in inj.fired] == ["node_latency"]
    assert store.nodes[1].latency(100) == pytest.approx(4e-4)
    emit(2, None)                       # third completion: the kill
    assert store.node_states()[0] == port_ds.DOWN
    inj.worker_tick(0)                  # another worker never fires
    inj.worker_tick(1)
    with pytest.raises(port_rec.WorkerCrash):
        inj.worker_tick(1)              # the target's second claim
    inj.worker_tick(1)                  # once only: the respawn is safe
    inj.checkpoint_tick()
    with pytest.raises(InjectedCrash):
        inj.checkpoint_tick()
    inj.checkpoint_tick()
    assert len(inj.fired) == 4
    assert inj.stats() == {"events_fired": 4.0, "events_pending": 0.0,
                           "completions_seen": 3.0,
                           "checkpoint_saves_seen": 3.0}


def test_node_revive_restores_the_latency_model():
    plan = FaultPlan((
        FaultEvent("node_latency", target=0, at_completions=1, factor=4.0),
        FaultEvent("node_kill", target=0, at_completions=2),
        FaultEvent("node_revive", target=0, at_completions=3)))
    inj = FaultInjector(plan)
    store = port_ds.ReplicatedDataStore(2, latency=lambda nbytes: 1e-4)
    inj.attach_store(store)
    orig = store.nodes[0].latency
    inj.on_progress(2)
    assert store.node_states()[0] == port_ds.DOWN
    inj.on_progress(1)
    assert store.nodes[0].latency is orig
    assert store.node_states()[0] == port_ds.HEALTHY


# -- jobs under faults ----------------------------------------------------------


def _slow_store(latency=4e-3):
    return port_ds.ReplicatedDataStore(
        n_initial=3, policy=port_ds.ReplicationPolicy(window=10_000,
                                                      max_replicas=3),
        latency=lambda nbytes: latency)


@pytest.mark.parametrize("wave", ["on", "off"])
def test_crash_lease_expiry_and_node_kill_are_bitwise_fault_free(wave):
    samples, months = _dataset()
    clean = _run(_spec(wave=wave), samples, months)
    plan = FaultPlan((
        FaultEvent("worker_crash", target=0, at_claims=1),
        FaultEvent("node_kill", target=1, at_completions=2),
        FaultEvent("node_latency", target=2, at_completions=3, factor=3.0),
        FaultEvent("node_revive", target=1, at_completions=5)))
    inj = FaultInjector(plan)
    # fetches of ~4 ms a sample under a 2 ms lease: claims lapse while
    # their fetch runs, and the idle peer requeues them
    spec = _spec(wave=wave, telemetry=True,
                 faults=port_driver.FaultOptions(lease_seconds=2e-3),
                 schedule=port_driver.ScheduleOptions(balanced="on",
                                                      prefetch="off"))
    plat = port_platform.Platform(spec, datastore=_slow_store(),
                                  fault_injector=inj)
    rep = plat.run(samples, months, PORT_WL)
    _assert_bitwise(clean.result, rep.result)
    assert rep.restarts >= 1
    assert rep.fault_events == len(plan.events) == len(inj.fired)
    assert plat.telemetry.events("lease_reclaimed")
    assert plat.telemetry.events("fault_fired")


# seeds whose plan crashes worker 0 at its first claim, so every event
# fires whatever the claims' order
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("wave", ["on", "off"])
def test_seeded_plan_job_is_bitwise_fault_free(seed, wave):
    samples, months = _dataset(n=24)
    clean = _run(_spec(wave=wave), samples, months)
    plan = FaultPlan.from_seed(seed, n_workers=2, n_nodes=3,
                               n_tasks=clean.n_tasks, revive_after=2)
    assert [e.at_claims for e in plan.events
            if e.kind == "worker_crash"] == [1]
    rep = _run(_spec(wave=wave,
                     faults=port_driver.FaultOptions(lease_seconds=0.5)),
               samples, months, datastore=_slow_store(1e-4),
               fault_injector=FaultInjector(plan))
    _assert_bitwise(clean.result, rep.result)
    assert rep.restarts == 1
    assert rep.fault_events == len(plan.events)


# -- CheckpointManager ----------------------------------------------------------


def test_background_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = port_mgr.CheckpointManager(str(tmp_path / "ck"))

    def boom(tree):
        raise OSError("disk full")

    monkeypatch.setattr(port_mgr, "_flatten_with_names", boom)
    mgr.save(0, {"w": np.zeros(3, np.float32)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # raised once, then cleared


def test_background_save_error_surfaces_on_next_save(tmp_path, monkeypatch):
    mgr = port_mgr.CheckpointManager(str(tmp_path / "ck"))
    state = {"w": np.zeros(3, np.float32)}

    def boom(tree):
        raise OSError("disk full")

    monkeypatch.setattr(port_mgr, "_flatten_with_names", boom)
    mgr.save(0, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(1, state)              # the next save waits first


def test_saves_from_several_threads_take_turns(tmp_path):
    """A job's workers offer leaves, and so save, from several threads at
    once: no save may see another's thread before it has started, and
    the newest step holds its own state."""
    mgr = port_mgr.CheckpointManager(str(tmp_path / "ck"), keep=2)
    errors = []

    def saver(base):
        try:
            for k in range(10):
                mgr.save(base + k, {"w": np.full(64, base + k, np.int64)})
        except BaseException as e:      # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=saver, args=(100 * i,))
               for i in range(4 * (os.cpu_count() or 1))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    mgr.wait()
    assert errors == []
    assert len(mgr.all_steps()) == 2
    step = mgr.all_steps()[-1]
    np.testing.assert_array_equal(mgr.restore(step)["['w']"],
                                  np.full(64, step, np.int64))


def test_crash_mid_save_keeps_the_last_good_step(tmp_path):
    d = str(tmp_path / "ck")
    mgr = port_mgr.CheckpointManager(d)
    mgr.save(0, {"w": np.arange(3, dtype=np.float32)}, blocking=True)
    os.makedirs(os.path.join(d, "step_00000001.tmp"))   # died mid-write
    assert mgr.all_steps() == [0]
    got = mgr.restore_latest()
    np.testing.assert_array_equal(got["['w']"],
                                  np.arange(3, dtype=np.float32))


def test_keep_retains_the_newest_steps_fsynced(tmp_path):
    d = str(tmp_path / "ck")
    mgr = port_mgr.CheckpointManager(d, keep=2)
    for step in range(5):
        mgr.save(step, {"w": np.full(2, step, np.int32)})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    np.testing.assert_array_equal(mgr.restore_latest()["['w']"], [4, 4])


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"layers": [{"w": torch.randn(3, 4, generator=g).to(
                            torch.bfloat16),
                        "b": torch.randn(4, generator=g)},
                       {"w": torch.randn(2, 2, generator=g).to(
                           torch.bfloat16),
                        "b": torch.zeros(2)}],
            "step": np.asarray(7, np.int64),
            "scale": np.arange(5, dtype=np.float16)}


def test_names_are_jax_key_paths_in_jax_order(tmp_path):
    d = str(tmp_path / "ck")
    port_mgr.CheckpointManager(d).save(3, _tree(), blocking=True)
    with open(os.path.join(d, "step_00000003", "meta.json")) as f:
        meta = json.load(f)
    assert meta["names"] == [
        "['layers'][0]['b']", "['layers'][0]['w']", "['layers'][1]['b']",
        "['layers'][1]['w']", "['scale']", "['step']"]
    assert meta["dtypes"] == ["float32", "bfloat16", "float32", "bfloat16",
                              "float16", "int64"]
    assert meta["step"] == 3


def _assert_tree_equal(got, want):
    got_l = list(tree_leaves_with_path(got))
    want_l = list(tree_leaves_with_path(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (_, g), (_, w) in zip(got_l, want_l):
        assert type(g) is type(w)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_bf16_tree_round_trips_through_both_managers(tmp_path):
    tree = _tree()
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    port_mgr.CheckpointManager(port_dir).save(1, tree, blocking=True)
    _assert_tree_equal(port_mgr.CheckpointManager(port_dir).restore(
        1, example=tree), tree)
    # the reference reads the port's files: the same names and bits
    flat = ref_mgr.CheckpointManager(port_dir).restore(1)
    port_flat = port_mgr.CheckpointManager(port_dir).restore(1)
    assert list(flat) == list(port_flat)
    for name, got in flat.items():
        want = port_flat[name]
        if isinstance(want, torch.Tensor):
            assert got.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                np.asarray(got).view(np.uint16),
                want.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(got, want)
    # and the port reads the reference's
    ref_tree = {"layers": [{"w": jnp.asarray(layer["w"].float().numpy(),
                                             jnp.bfloat16),
                            "b": jnp.asarray(layer["b"].numpy())}
                           for layer in tree["layers"]],
                "step": jnp.asarray(7), "scale": tree["scale"]}
    ref_mgr.CheckpointManager(ref_dir).save(1, ref_tree, blocking=True)
    got = port_mgr.CheckpointManager(ref_dir).restore(1)
    assert list(got) == list(port_flat)
    for name in ("['layers'][0]['w']", "['layers'][1]['w']"):
        assert got[name].dtype == torch.bfloat16
        assert torch.equal(got[name], port_flat[name])
    np.testing.assert_array_equal(got["['layers'][0]['b']"],
                                  port_flat["['layers'][0]['b']"])


# -- JobCheckpointer and resume ------------------------------------------------


@pytest.fixture(autouse=True)
def _reference_saves_block(monkeypatch):
    """The reference's driver leaves its last save in flight when a crash
    leaves ``run``; its saves are made blocking here so that a directory
    it wrote is settled before a test reads it."""
    save = ref_mgr.CheckpointManager.save

    def blocking_save(self, step, state, *, blocking=False):
        save(self, step, state, blocking=True)

    monkeypatch.setattr(ref_mgr.CheckpointManager, "save", blocking_save)


def _crashed_run(ckpt_dir, samples, months, *, at_saves=2, every=2,
                 pkg=port_platform, wave="on"):
    driver = port_driver if pkg is port_platform else ref_driver
    faults_mod = port_faults if pkg is port_platform else ref_faults
    inj = faults_mod.FaultInjector(faults_mod.FaultPlan((
        faults_mod.FaultEvent("checkpoint_crash", at_saves=at_saves),)))
    spec = _spec(pkg, wave=wave, faults=driver.FaultOptions(
        checkpoint_dir=ckpt_dir, checkpoint_every=every))
    with pytest.raises(faults_mod.InjectedCrash):
        _run(spec, samples, months, pkg=pkg, fault_injector=inj)


@pytest.mark.parametrize("wave", ["on", "off"])
def test_resume_is_bitwise_and_runs_only_the_missing_tasks(tmp_path, wave):
    samples, months = _dataset()
    clean = _run(_spec(wave=wave), samples, months)
    d = str(tmp_path / "ck")
    _crashed_run(d, samples, months, wave=wave)
    restored, n_tasks = port_driver.JobCheckpointer.load(d)
    assert n_tasks == clean.n_tasks and 0 < len(restored) < n_tasks
    rep = _run(_spec(wave=wave), samples, months, resume_from=d)
    _assert_bitwise(clean.result, rep.result)
    assert rep.tasks_restored == len(restored)
    assert rep.tasks_executed == clean.n_tasks
    ran = sum(rep.wave_sizes) if wave == "on" else rep.device_dispatches
    assert ran == clean.n_tasks - len(restored)


def test_checkpointed_run_saves_and_equals_the_plain_run(tmp_path):
    samples, months = _dataset()
    clean = _run(_spec(), samples, months)
    spec = _spec(faults=port_driver.FaultOptions(
        checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3))
    rep = _run(spec, samples, months)
    _assert_bitwise(clean.result, rep.result)
    assert rep.checkpoint_saves == clean.n_tasks // 3
    assert rep.checkpoint_bytes > 0
    restored, n_tasks = port_driver.JobCheckpointer.load(str(tmp_path /
                                                             "ck"))
    assert n_tasks == clean.n_tasks
    assert len(restored) == 3 * rep.checkpoint_saves


def test_resume_on_the_simulated_backend_is_bitwise(tmp_path):
    samples, months = _dataset()
    clean = _run(_spec(), samples, months)
    d = str(tmp_path / "ck")
    _crashed_run(d, samples, months)
    rep = _run(_spec(wave="off", backend="simulated"), samples, months,
               resume_from=d)
    _assert_bitwise(clean.result, rep.result)
    assert rep.tasks_restored > 0


def test_resume_of_a_different_plan_raises(tmp_path):
    samples, months = _dataset()
    d = str(tmp_path / "ck")
    _crashed_run(d, samples, months)
    other = port_platform.PlatformSpec(
        platform="BTS", n_workers=2, seed=5, knee_bytes=2 * KNEE,
        device="cpu")
    with pytest.raises(ValueError, match="resume needs the same dataset"):
        port_platform.Platform(other).run(samples, months, PORT_WL,
                                          resume_from=d)


def test_resume_from_an_empty_directory_runs_everything(tmp_path):
    samples, months = _dataset()
    clean = _run(_spec(), samples, months)
    rep = _run(_spec(), samples, months,
               resume_from=str(tmp_path / "empty"))
    _assert_bitwise(clean.result, rep.result)
    assert rep.tasks_restored == 0


def _flat_equal(a, b):
    assert sorted(a) == sorted(b)
    for tid in a:
        assert a[tid].keys() == b[tid].keys()
        for name in a[tid]:
            np.testing.assert_array_equal(a[tid][name], b[tid][name])


def test_port_checkpoint_loads_in_the_reference_and_back(tmp_path):
    samples, months = _dataset()
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    _crashed_run(port_dir, samples, months)
    _crashed_run(ref_dir, samples, months, pkg=ref_platform)
    for d in (port_dir, ref_dir):
        port_parts, port_n = port_driver.JobCheckpointer.load(d)
        ref_parts, ref_n = ref_driver.JobCheckpointer.load(d)
        assert port_n == ref_n is not None and port_parts
        _flat_equal(port_parts, ref_parts)
        with open(os.path.join(d, sorted(
                s for s in os.listdir(d) if not s.endswith(".tmp"))[-1],
                "meta.json")) as f:
            names = json.load(f)["names"]
        assert names[-2:] == ["['__meta__/completed']",
                              "['__meta__/n_tasks']"]


def test_reference_job_interrupted_resumes_in_the_port(tmp_path):
    samples, months = _dataset()
    ref_clean = _run(_spec(ref_platform), samples, months, pkg=ref_platform)
    d = str(tmp_path / "ck")
    _crashed_run(d, samples, months, pkg=ref_platform)
    rep = _run(_spec(), samples, months, resume_from=d)
    assert rep.tasks_restored > 0
    _assert_close(ref_clean.result, rep.result)
    # and the other way round
    d2 = str(tmp_path / "ck2")
    _crashed_run(d2, samples, months)
    ref_rep = _run(_spec(ref_platform), samples, months, pkg=ref_platform,
                   resume_from=d2)
    assert ref_rep.tasks_restored > 0
    _assert_close(ref_rep.result, _run(_spec(), samples, months).result)
