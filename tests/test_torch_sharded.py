"""Sharded wave execution in the PyTorch port (``mesh_devices``,
``repro_torch.launch.mesh``, ``compute.ShardedBlockArena``,
``compute.run_map_wave_sharded``) on the CPU.

The mesh is emulated with repeated ``cpu`` entries (``make_wave_mesh(n,
"cpu")``), the port's counterpart of the reference's
``--xla_force_host_platform_device_count=8``; every entry runs the kernel
wrappers' plain versions.  The oracles are the port's own unsharded waves
(bit for bit, with the same dispatches), the reference's sharded path on a
1-device mesh (its ``shard_map`` with Pallas in interpret mode, in this
process) and the reference's host-side slot arithmetic.

Tolerance against the reference is the port's platform tests': ``moments``'
``mean`` and ``var`` to ``rtol=1e-5, atol=1e-5`` (the same rows summed in
another order inside each 8-row group, tests/test_torch_platform.py), the
grid statistics' sums to ``rtol=2e-5`` with an absolute floor of ``1e-5 ·
max|sum|`` (tests/test_torch_subsample.py); counts and hits exactly."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.platform as ref_platform
from repro.core import subsample as rss
from repro.platform import compute as ref_pc
from repro.platform import driver as ref_driver
from repro_torch.core import subsample as pss
from repro_torch.launch.mesh import WaveMesh, make_wave_mesh
from repro_torch.parallel.collectives import gather_shards
from repro_torch.parallel.sharding import wave_sharding
from repro_torch.platform import (ApproxOptions, FaultOptions,
                                  MomentsSpec, Platform,
                                  PlatformService, PlatformSpec,
                                  WaveOptions)
from repro_torch.platform import compute as pc
from repro_torch.platform import driver as port_driver
from repro_torch.platform.reduce import StreamingReduceTree, tree_add
from tests._hypothesis_compat import given, settings, st

MESH_SIZES = (1, 2, 4, 8)
WL_SHAPE = dict(draws=4, draw_size=16)
GRID_SHAPE = dict(draws=2, draw_size=8)
# name -> (port workload, reference workload); the reference's WL_* of
# tests/test_sharded_wave.py
CASES = {
    "kernel-moments": (MomentsSpec(**WL_SHAPE),
                       ref_platform.MomentsSpec(**WL_SHAPE)),
    "torch-eaglet": (dataclasses.replace(pss.EAGLET, **GRID_SHAPE),
                     dataclasses.replace(rss.EAGLET, **GRID_SHAPE)),
    "torch-netflix_high": (dataclasses.replace(pss.NETFLIX_HIGH, **GRID_SHAPE),
                           dataclasses.replace(rss.NETFLIX_HIGH,
                                               **GRID_SHAPE)),
}
MOMENTS_RTOL, MOMENTS_ATOL = 1e-5, 1e-5
GRID_RTOL, GRID_ATOL_SCALE = 2e-5, 1e-5
COUNT_KEYS = ("count", "hits", "n")


def _dataset(n, length=96, seed=0, ragged=True):
    """The reference's ``_dataset`` (tests/test_sharded_wave.py)."""
    rng = np.random.default_rng(seed)
    samples, months = {}, {}
    for i in range(n):
        m = int(rng.integers(length // 2, length)) if ragged else length
        samples[i] = rng.normal(size=m).astype(np.float32)
        months[i] = rng.integers(0, 12, m).astype(np.int32)
    return samples, months


def _spec(mesh=None, *, max_wave=4, **kw):
    base = dict(platform="BTS", n_workers=1, backend="threaded",
                knee_bytes=1024.0, device="cpu",
                waves=WaveOptions(wave="on", max_wave=max_wave,
                                  mesh_devices=mesh))
    base.update(kw)
    return PlatformSpec(**base)


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
                atol=GRID_ATOL_SCALE * float(np.abs(w).max()), err_msg=key)


@pytest.fixture(scope="module")
def dataset():
    """The reference's sharded-wave dataset, doubled: with a 1 KB knee and
    waves of at most 4, about 15 tasks in several buckets and waves."""
    return _dataset(48, seed=3)


@pytest.fixture(scope="module")
def unsharded(dataset):
    """The port's unsharded wave run of each case, computed once."""
    samples, months = dataset
    return {name: Platform(_spec()).run(samples, months, wl)
            for name, (wl, _) in CASES.items()}


# -- sharded ≡ unsharded, bit for bit -----------------------------------------


@pytest.mark.parametrize("mesh", MESH_SIZES)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_wave_bit_identical(dataset, unsharded, name, mesh):
    """Every mesh size reproduces the unsharded run to the last bit and
    issues the SAME waves: the scheduler's wave partition is
    mesh-invariant; sharding changes where lanes execute, never how waves
    are cut.  One worker, whose partition of a job into waves is fixed
    (with two, the cut of a job's tail depends on timing)."""
    samples, months = dataset
    wl, _ = CASES[name]
    ref = unsharded[name]
    rep = Platform(_spec(mesh)).run(samples, months, wl)
    _assert_bitwise(ref.result, rep.result, f"mesh {mesh}")
    assert rep.device_dispatches == ref.device_dispatches
    assert rep.wave_sizes == ref.wave_sizes
    assert rep.n_tasks == ref.n_tasks > 8
    assert rep.engine == ref.engine


@pytest.mark.parametrize("name", list(CASES))
def test_two_workers_sharded_bit_identical(dataset, unsharded, name):
    """Two workers dispatching sharded waves at once (on a 4-device mesh)
    give the unsharded result bit for bit and execute every task once."""
    samples, months = dataset
    wl, _ = CASES[name]
    rep = Platform(_spec(4, n_workers=2)).run(samples, months, wl)
    _assert_bitwise(unsharded[name].result, rep.result, "two workers")
    assert sum(rep.wave_sizes) == rep.n_tasks == unsharded[name].n_tasks


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_port_matches_reference_mesh_1(dataset, name):
    """The port at every mesh size against the reference's sharded path
    on a 1-device mesh (``shard_map``, Pallas interpreted): results within
    the stated tolerance, counts exact, the same task partition and waves,
    and at mesh 1 the same bytes uploaded (a larger mesh adds the arena's
    tail rows)."""
    samples, months = dataset
    port_wl, ref_wl = CASES[name]
    ref = ref_platform.Platform(ref_platform.PlatformSpec(
        platform="BTS", n_workers=1, backend="threaded", knee_bytes=1024.0,
        waves=ref_driver.WaveOptions(wave="on", max_wave=4,
                                     mesh_devices=1))).run(
            samples, months, ref_wl)
    for mesh in MESH_SIZES:
        rep = Platform(_spec(mesh)).run(samples, months, port_wl)
        _assert_close_to_reference(ref.result, rep.result,
                                   port_wl.statistic)
        assert rep.n_tasks == ref.n_tasks > 1
        assert rep.task_size_bytes == ref.task_size_bytes
        assert rep.device_dispatches == ref.device_dispatches
        assert rep.wave_sizes == ref.wave_sizes
        if mesh == 1:
            assert rep.bytes_uploaded == ref.bytes_uploaded
        else:              # the arena's tail rows, as the reference's
            assert rep.bytes_uploaded >= ref.bytes_uploaded


def test_sharded_epsilon_same_task_set():
    """The epsilon early stop settles on the same executed task set (and
    hence the same subset-reduce result) at every mesh size: the claim cap
    that cuts waves is mesh-invariant.  ``n_workers=1`` serialises wave
    settlement so the stop point is reproducible (the reference's
    ``test_sharded_epsilon_same_task_set``)."""
    rng = np.random.default_rng(1)
    samples = {i: rng.normal(size=64).astype(np.float32) for i in range(48)}
    months = {i: rng.integers(0, 12, 64).astype(np.int32) for i in samples}
    kw = dict(knee_bytes=256.0,
              approx=ApproxOptions(epsilon=5.0, min_tasks=4))
    wl = MomentsSpec(**WL_SHAPE)
    ref = Platform(_spec(**kw)).run(samples, months, wl)
    assert ref.stop_reason is not None, "epsilon target never converged"
    assert ref.tasks_executed < 48
    for mesh in MESH_SIZES:
        rep = Platform(_spec(mesh, **kw)).run(samples, months, wl)
        assert rep.stop_reason is not None
        assert rep.tasks_executed == ref.tasks_executed, \
            f"mesh={mesh} early-stopped on a different task set"
        _assert_bitwise(ref.result, rep.result, f"mesh {mesh}")


@pytest.mark.parametrize("path", ("run", "service"))
@pytest.mark.parametrize("mesh", (None, 4))
def test_epsilon_stop_independent_of_combiner_lag(monkeypatch, mesh, path):
    """The stop is decided on every leaf emitted before the settlement
    check, however far the reduce tree's combiner thread lags: a combiner
    slowed by 20 ms an insert early-stops on the undelayed run's task set
    and result, through ``Platform.run`` and through the service's pool
    (the reference feeds its estimator on the combiner thread, so under
    that lag its stop lands waves late or never)."""
    rng = np.random.default_rng(1)
    samples = {i: rng.normal(size=64).astype(np.float32) for i in range(48)}
    months = {i: rng.integers(0, 12, 64).astype(np.int32) for i in samples}
    spec = _spec(mesh, knee_bytes=256.0,
                 approx=ApproxOptions(epsilon=5.0, min_tasks=4))
    wl = MomentsSpec(**WL_SHAPE)

    def run():
        if path == "run":
            rep = Platform(spec).run(samples, months, wl)
            return rep.stop_reason, rep.tasks_executed, rep.result
        with PlatformService(spec) as svc:
            t = svc.submit(svc.register_dataset(samples, months), wl, seed=0)
            result = t.result(timeout=120)
            return t.stop_reason, t.tasks_executed, result

    fast_reason, fast_n, fast_result = run()
    assert fast_reason is not None and fast_n < 48
    insert = StreamingReduceTree._insert

    def slow_insert(self, level, idx, value):
        time.sleep(0.02)
        insert(self, level, idx, value)

    monkeypatch.setattr(StreamingReduceTree, "_insert", slow_insert)
    slow_reason, slow_n, slow_result = run()
    assert slow_reason is not None
    assert slow_n == fast_n, "the slowed combiner moved the stop"
    _assert_bitwise(fast_result, slow_result, "slowed combiner")


def test_resume_at_another_mesh_size(tmp_path):
    """A job checkpointed on a 1-device mesh and resumed on a 4-device
    mesh equals the job run whole: partials are keyed by task, never by
    where they ran."""
    from repro_torch.platform.faults import (FaultEvent, FaultInjector,
                                             FaultPlan, InjectedCrash)

    samples, months = _dataset(48, seed=5)
    wl = MomentsSpec(**WL_SHAPE)
    kw = dict(knee_bytes=2 * 96 * 4, max_wave=4)
    whole = Platform(_spec(**kw)).run(samples, months, wl)
    d = str(tmp_path / "ck")
    inj = FaultInjector(FaultPlan((FaultEvent("checkpoint_crash",
                                              at_saves=2),)))
    with pytest.raises(InjectedCrash):
        Platform(_spec(1, faults=FaultOptions(checkpoint_dir=d,
                                              checkpoint_every=2), **kw),
                 fault_injector=inj).run(samples, months, wl)
    restored, n_tasks = port_driver.JobCheckpointer.load(d)
    assert n_tasks == whole.n_tasks and 0 < len(restored) < n_tasks
    rep = Platform(_spec(4, **kw)).run(samples, months, wl, resume_from=d)
    _assert_bitwise(whole.result, rep.result)
    assert rep.tasks_restored == len(restored)
    assert sum(rep.wave_sizes) == whole.n_tasks - len(restored)


# -- the service ---------------------------------------------------------------


def test_service_sharded_waves_bit_identical():
    """The service at ``mesh_devices=4`` serves the unsharded service's
    result bit for bit: one job alone, then four jobs of one class
    submitted with the pool's lock held so their waves fuse (a fused wave
    lands one slot once a job, so an entry may hold more lanes than
    ``shard_wave_width`` gives it; the port pads nothing and needs no
    widening)."""
    samples, months = _dataset(32, seed=7)
    wl = MomentsSpec(**WL_SHAPE)

    def serve(mesh):
        spec = _spec(mesh, max_wave=16, knee_bytes=4 * 96 * 4)
        with PlatformService(spec) as svc:
            handle = svc.register_dataset(samples, months)
            alone = svc.submit(handle, wl, seed=0).result(timeout=120)
            fused_before = svc.stats()["fused_dispatches"]
            with svc._pool._cond:          # re-entrant: submits go through
                tickets = [svc.submit(handle, wl, seed=s)
                           for s in range(1, 5)]
            results = [t.result(timeout=120) for t in tickets]
            fused = svc.stats()["fused_dispatches"] - fused_before
            (qc,) = handle._classes.values()
        return alone, results, fused, qc

    ref_alone, ref_results, ref_fused, _ = serve(None)
    alone, results, fused, qc = serve(4)
    assert isinstance(qc.wave_ctx.arena, pc.ShardedBlockArena)
    assert qc.wave_ctx.arena.n_dev == 4
    _assert_bitwise(ref_alone, alone, "alone")
    for s, (want, got) in enumerate(zip(ref_results, results), 1):
        _assert_bitwise(want, got, f"seed {s}")
    assert fused > 0 and fused == ref_fused


def test_fused_wave_past_the_shard_width():
    """A wave that lands the same slot on one entry several times (as a
    fused wave of several jobs does) runs each lane with its own seed and
    equals the unsharded wave bit for bit, though the entry holds more
    lanes than ``shard_wave_width`` of the wave's width."""
    samples, months = _dataset(32, seed=7, ragged=False)
    plan = port_driver.plan_job(samples, months, MomentsSpec(**WL_SHAPE),
                                sizing="kneepoint", engine="kernel",
                                n_exec=1, knee_bytes=8 * 96 * 4,
                                device="cpu")
    wl = MomentsSpec(**WL_SHAPE)
    mesh = make_wave_mesh(4, "cpu")
    sharded = pc.ShardedBlockArena.pack(plan.tasks, plan.task_shape,
                                        plan.build_block, mesh,
                                        with_months=False)
    plain = pc.BlockArena.pack(plan.tasks, plan.task_shape,
                               plan.build_block, with_months=False,
                               device="cpu")
    task = plan.tasks[0]
    wave = [task] * 6                   # six jobs' copies of one task
    seeds = np.arange(6, dtype=np.int32) + 11
    devs = sharded.dev_slots(wave)[1]
    assert np.bincount(devs).max() == 6 > pc.shard_wave_width(6, 4)
    got = pc.run_map_wave(sharded, wave, seeds, wl, "kernel")
    want = pc.run_map_wave(plain, wave, seeds, wl, "kernel")
    for w, g in zip(want, got):
        _assert_bitwise(w, g)
    assert not np.array_equal(got[0]["sum"], got[1]["sum"])


# -- the arena ------------------------------------------------------------------


def _plan(engine="kernel", n=10):
    samples, months = _dataset(n, seed=11, ragged=False)
    wl = MomentsSpec(**WL_SHAPE) if engine == "kernel" else \
        dataclasses.replace(pss.NETFLIX_HIGH, **GRID_SHAPE)
    return port_driver.plan_job(samples, months, wl, sizing="kneepoint",
                                engine=engine, n_exec=2, knee_bytes=1024.0,
                                device="cpu")


@pytest.mark.parametrize("n_dev", range(1, 9))
@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_sharded_arena_physical_layout(engine, n_dev):
    """Each task's physical row is ``dev * per_dev + local`` of the
    device-major layout, on the entry ``dev`` at its local row, and holds
    the task's own block (and months); tail rows wrap-copy the logical
    slot ``unshard_slot(dev, local) % b``, the reference's formula."""
    plan = _plan(engine)
    with_months = engine == "torch"
    arena = pc.ShardedBlockArena.pack(plan.tasks, plan.task_shape,
                                      plan.build_block,
                                      make_wave_mesh(n_dev, "cpu"),
                                      with_months=with_months)
    by_key = {}
    for task in plan.tasks:
        by_key.setdefault(plan.task_shape(task), []).append(task)
    for key, group in by_key.items():
        data, months = arena.bucket(key)
        per_dev = arena._per_dev[key]
        assert per_dev == -(-len(group) // n_dev)
        assert len(data) == n_dev and all(
            t.shape[0] == per_dev for t in data)
        host = gather_shards(data)
        planes = [host] + ([gather_shards(months)] if with_months else [])
        order = [ref_pc.unshard_slot(dev, local, n_dev) % len(group)
                 for dev in range(n_dev) for local in range(per_dev)]
        for p, logical in enumerate(order):
            want = plan.build_block(group[logical])
            for plane, w in zip(planes, want):
                np.testing.assert_array_equal(plane[p], w)
    for task in plan.tasks:
        key, dev, local = arena._dev_slot[task.task_id]
        per_dev = arena._per_dev[key]
        assert arena._slot[task.task_id] == (key, dev * per_dev + local)
        np.testing.assert_array_equal(
            arena.bucket(key)[0][dev][local].numpy(),
            plan.build_block(task)[0])


def test_mesh_1_arena_is_the_reference_arena():
    """At mesh 1 the port's sharded arena places every task where the
    reference's does, slot for slot, with the same bytes."""
    samples, months = _dataset(10, seed=11)
    wl = MomentsSpec(**WL_SHAPE)
    port_plan = port_driver.plan_job(samples, months, wl,
                                     sizing="kneepoint", engine="kernel",
                                     n_exec=2, knee_bytes=1024.0,
                                     device="cpu")
    ref_plan = ref_driver.plan_job(samples, months,
                                   ref_platform.MomentsSpec(**WL_SHAPE),
                                   sizing="kneepoint", engine="pallas",
                                   n_exec=2, knee_bytes=1024.0)
    from repro.launch.mesh import make_wave_mesh as ref_make_wave_mesh

    ref = ref_pc.ShardedBlockArena.pack(
        ref_plan.tasks, ref_plan.task_shape, ref_plan.build_block,
        ref_make_wave_mesh(1), with_months=False)
    port = pc.ShardedBlockArena.pack(
        port_plan.tasks, port_plan.task_shape, port_plan.build_block,
        make_wave_mesh(1, "cpu"), with_months=False)
    assert port._slot == ref._slot
    assert port._dev_slot == ref._dev_slot
    assert port._per_dev == ref._per_dev
    assert port.nbytes == ref.nbytes
    for key in ref.keys():
        np.testing.assert_array_equal(gather_shards(port.bucket(key)[0]),
                                      np.asarray(ref.bucket(key)[0]))


def test_wave_sharding_places_contiguous_blocks():
    mesh = WaveMesh((torch.device("cpu"),) * 3)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    parts = wave_sharding(mesh).place(x)
    assert [tuple(p.shape) for p in parts] == [(2, 4)] * 3
    np.testing.assert_array_equal(gather_shards(parts), x)
    with pytest.raises(ValueError, match="split"):
        wave_sharding(mesh).place(x[:5])


def test_wave_mesh_compares_by_its_devices():
    a, b = make_wave_mesh(4, "cpu"), make_wave_mesh(4, "cpu")
    assert a == b and hash(a) == hash(b) and a.n_dev == 4
    assert a != make_wave_mesh(2, "cpu")
    assert a.devices == (torch.device("cpu"),) * 4
    assert a.stream(0) is None                  # a CPU entry has no stream
    with pytest.raises(ValueError, match=">=1"):
        WaveMesh(())


# -- slot arithmetic (pure host), each held to the reference's -----------------


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 100_000), st.integers(1, 64))
def test_shard_slot_round_trip(index, n_dev):
    dev, local = pc.shard_slot(index, n_dev)
    assert (dev, local) == ref_pc.shard_slot(index, n_dev)
    assert 0 <= dev < n_dev
    assert pc.unshard_slot(dev, local, n_dev) == index
    assert ref_pc.unshard_slot(dev, local, n_dev) == index


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 512), st.integers(1, 16))
def test_shard_slot_no_cross_device_aliasing(bucket, n_dev):
    """Distinct logical slots map to distinct physical rows."""
    per_dev = -(-bucket // n_dev)
    seen = set()
    for i in range(bucket):
        dev, local = pc.shard_slot(i, n_dev)
        assert (dev, local) == ref_pc.shard_slot(i, n_dev)
        assert local < per_dev
        phys = dev * per_dev + local
        assert phys not in seen
        seen.add(phys)
    assert len(seen) == bucket


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 256), st.integers(1, 16))
def test_shard_slot_tail_bucket_padding(bucket, n_dev):
    """The device-major physical order: real positions hold their own
    logical slot; tail positions wrap to a valid earlier block."""
    per_dev = -(-bucket // n_dev)
    order = [pc.unshard_slot(dev, local, n_dev) % bucket
             for dev in range(n_dev) for local in range(per_dev)]
    assert order == [ref_pc.unshard_slot(dev, local, n_dev) % bucket
                     for dev in range(n_dev) for local in range(per_dev)]
    assert all(0 <= x < bucket for x in order)
    for i in range(bucket):
        dev, local = pc.shard_slot(i, n_dev)
        assert order[dev * per_dev + local] == i


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 512), st.integers(1, 16), st.integers(1, 64),
       st.integers(0, 511))
def test_contiguous_claim_occupancy_bound(bucket, n_dev, width, start):
    """A contiguous FIFO claim of ``width`` logical slots lands at most
    ``ceil(width / n_dev)`` lanes on any one device, within
    ``shard_wave_width`` of the claim cap (the reference's)."""
    assert pc.shard_wave_width(width, n_dev) == \
        ref_pc.shard_wave_width(width, n_dev)
    start = start % bucket
    run = [pc.shard_slot(i, n_dev)[0]
           for i in range(start, min(start + width, bucket))]
    if not run:
        return
    occupancy = np.bincount(run, minlength=n_dev)
    assert occupancy.max() <= -(-width // n_dev)
    assert pc.pow2_ceil(int(occupancy.max())) <= \
        pc.shard_wave_width(max(width, 1), n_dev)


# -- refusals -------------------------------------------------------------------


def test_mesh_devices_requires_wave_execution():
    samples, months = _dataset(4, seed=0, ragged=False)
    spec = _spec(waves=WaveOptions(wave="off", mesh_devices=2))
    with pytest.raises(ValueError, match="mesh_devices"):
        Platform(spec).run(samples, months, MomentsSpec(**WL_SHAPE))
    with pytest.raises(ValueError, match=">= 1"):
        Platform(_spec(0)).run(samples, months, MomentsSpec(**WL_SHAPE))


def test_wave_mesh_refusals():
    with pytest.raises(ValueError, match=">=1"):
        make_wave_mesh(0)
    with pytest.raises(ValueError, match=">=1"):
        make_wave_mesh(0, "cpu")


def test_cuda_mesh_without_enough_cards_raises():
    n_cards = torch.cuda.device_count()
    if n_cards:
        with pytest.raises(ValueError, match="device"):
            make_wave_mesh(n_cards + 1)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_wave_mesh(1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Platform(PlatformSpec(waves=WaveOptions(mesh_devices=1)))


# -- multi-shard reduce ordering (the reference's two tests, on the port) ------


def _leaf(i):
    return {"sum": np.float32(1.0 + 0.1 * i), "count": np.float32(1.0)}


def test_reduce_tree_multi_shard_out_of_order_arrivals():
    """Partials arriving interleaved from several shard producer threads,
    each offering its own slice in reversed order, combine to the same
    root as the sorted single-producer stream."""
    n, n_shards = 37, 4
    ref_tree = StreamingReduceTree(n)
    for i in range(n):
        ref_tree.offer(i, _leaf(i))
    ref = ref_tree.result(timeout=30.0)

    tree = StreamingReduceTree(n)
    barrier = threading.Barrier(n_shards)

    def producer(shard):
        mine = [i for i in range(n) if i % n_shards == shard]
        barrier.wait(timeout=30.0)
        for i in reversed(mine):
            tree.offer(i, _leaf(i))

    threads = [threading.Thread(target=producer, args=(s,))
               for s in range(n_shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    got = tree.result(timeout=30.0)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k])


def test_combine_subset_depends_only_on_task_set():
    """The early-stop finalize: the same executed subset handed over in
    scrambled per-shard dict orders yields one bitwise answer, equal to
    the same leaves flowing through a live tree."""
    n = 29
    executed = [i for i in range(n) if i % 3 != 0]
    orders = [executed,
              list(reversed(executed)),
              executed[1::2] + executed[0::2],
              [executed[(7 * k) % len(executed)]
               for k in range(len(executed))]]
    roots = []
    for order in orders:
        assert sorted(order) == sorted(executed)
        items = {i: _leaf(i) for i in order}
        roots.append(StreamingReduceTree.combine_subset(n, items, tree_add))
    live = StreamingReduceTree(n)
    for i in executed:
        live.offer(i, _leaf(i))
    live.wait_leaves(len(executed), timeout=30.0)
    roots.append(live.snapshot())
    live.close()
    for other in roots[1:]:
        for k in roots[0]:
            np.testing.assert_array_equal(roots[0][k], other[k])
