"""``Platform.run`` end to end: the PyTorch port against the JAX
reference on the same dataset, and the reference's invariants inside the
port.

Both packages are handed the identical numpy ``samples`` / ``months``
dicts and the same ``PlatformSpec`` seed: the dataset is the system's
only state and the per-task seed its only randomness (the port's threefry
reproduces jax's draws), so there is nothing else to convert.  The
reference runs its Pallas kernel in interpret mode; the port runs with
``device="cpu"``, so its kernel wrapper takes the plain version.

Tolerance for the reference comparison: ``mean`` and ``var`` agree to
``rtol=1e-5, atol=1e-5``.  The rows summed are identical; only the order
inside each 8-row group differs, a few fp32 ulps in Σ and Σ².  ``var`` is
Σ²/n − mean², a difference of two sums, so its absolute error follows
the size of Σ²/n (about 1 for this unit-variance data), not of ``var``.
``count`` and everything integral agree exactly."""

import dataclasses

import numpy as np
import pytest

import repro.platform as ref_platform
import repro_torch.platform as port_platform
from repro.core import scheduler as ref_sch
from repro.core import tiny_task as ref_tiny_task
from repro.platform import driver as ref_driver
from repro_torch.core import scheduler as port_sch
from repro_torch.platform import driver as port_driver

WL_SHAPE = dict(draws=4, draw_size=16)
REF_WL = ref_platform.MomentsSpec(**WL_SHAPE)
PORT_WL = port_platform.MomentsSpec(**WL_SHAPE)
KNEE = 4 * 96 * 4                 # about four samples of 96 fp32 each
RTOL, ATOL = 1e-5, 1e-5


def _dataset(n=20, length=96, seed=0):
    rng = np.random.default_rng(seed)
    samples, months = {}, {}
    for i in range(n):
        m = int(rng.integers(length // 2, length))
        samples[i] = rng.standard_normal(m).astype(np.float32)
        months[i] = rng.integers(0, 12, m).astype(np.int32)
    return samples, months


def _waves(wave, max_wave):
    kw = dict(wave=wave, max_wave=max_wave)
    return (ref_driver.WaveOptions(**kw), port_driver.WaveOptions(**kw))


def _run_both(samples, months, *, platform, wave="on", max_wave=8,
              n_workers=1, backend="threaded", seed=5):
    ref_w, port_w = _waves(wave, max_wave)
    common = dict(platform=platform, n_workers=n_workers, backend=backend,
                  seed=seed, knee_bytes=KNEE)
    ref = ref_platform.Platform(ref_platform.PlatformSpec(
        waves=ref_w, **common)).run(samples, months, REF_WL)
    port = port_platform.Platform(port_platform.PlatformSpec(
        waves=port_w, device="cpu", **common)).run(samples, months, PORT_WL)
    return ref, port


def _run_port(samples, months, *, platform="BTS", wave="on", max_wave=8,
              n_workers=2, backend="threaded", seed=5):
    spec = port_platform.PlatformSpec(
        platform=platform, n_workers=n_workers, backend=backend, seed=seed,
        knee_bytes=KNEE, device="cpu",
        waves=port_driver.WaveOptions(wave=wave, max_wave=max_wave))
    return port_platform.Platform(spec).run(samples, months, PORT_WL)


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


@pytest.mark.parametrize("sizing", ["kneepoint", "tiny"])
def test_same_task_partition(sizing):
    samples, months = _dataset()
    ref = ref_driver.plan_job(samples, months, REF_WL, sizing=sizing,
                              engine="pallas", n_exec=2, knee_bytes=KNEE)
    port = port_driver.plan_job(samples, months, PORT_WL, sizing=sizing,
                                engine="kernel", n_exec=2, knee_bytes=KNEE,
                                device="cpu")
    assert [t.sample_ids for t in port.tasks] == \
        [t.sample_ids for t in ref.tasks]
    assert [t.size_bytes for t in port.tasks] == \
        [t.size_bytes for t in ref.tasks]
    assert (port.pad_len, port.max_count) == (ref.pad_len, ref.max_count)
    assert [port.task_shape(t) for t in port.tasks] == \
        [ref.task_shape(t) for t in ref.tasks]


@pytest.mark.parametrize("platform", ["BTS", "BTT"])
@pytest.mark.parametrize("wave", ["on", "off"])
def test_results_and_dispatches_match_reference(platform, wave):
    samples, months = _dataset()
    ref, port = _run_both(samples, months, platform=platform, wave=wave)
    assert port.n_tasks == ref.n_tasks
    assert port.device_dispatches == ref.device_dispatches
    assert port.wave_sizes == ref.wave_sizes
    assert port.bytes_uploaded == ref.bytes_uploaded
    assert port.engine == "kernel" and ref.engine == "pallas"
    np.testing.assert_array_equal(port.result["count"], ref.result["count"])
    for key in ("mean", "var"):
        np.testing.assert_allclose(port.result[key], ref.result[key],
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_wave_bit_identical_to_per_task():
    samples, months = _dataset()
    per = _run_port(samples, months, wave="off")
    wav = _run_port(samples, months, wave="on")
    assert per.device_dispatches == per.n_tasks
    assert sum(wav.wave_sizes) == wav.n_tasks
    _assert_bitwise(per.result, wav.result)


def test_threaded_bit_identical_to_simulated():
    samples, months = _dataset()
    wav = _run_port(samples, months, wave="on")
    sim = _run_port(samples, months, wave="off", backend="simulated",
                    n_workers=6)
    _assert_bitwise(wav.result, sim.result)


def test_invariant_to_wave_size():
    samples, months = _dataset(n=16)
    results = [_run_port(samples, months, platform="BTT", n_workers=1,
                         max_wave=w).result for w in (1, 2, 4, 8, 16)]
    for other in results[1:]:
        _assert_bitwise(results[0], other)


@pytest.mark.parametrize("option", ["mesh_devices"])
def test_deferred_options_raise(option):
    """``mesh_devices``, the last option the port deferred, now raises
    only where the reference's does: without wave execution it shards
    nothing (``ValueError`` naming it, on both packages); with waves a
    1-device CPU mesh runs, bit for bit the unsharded run
    (tests/test_torch_sharded.py holds every mesh size)."""
    samples, months = _dataset(n=8)
    for pkg, driver, wl, extra in (
            (ref_platform, ref_driver, REF_WL, {}),
            (port_platform, port_driver, PORT_WL, {"device": "cpu"})):
        spec = pkg.PlatformSpec(
            knee_bytes=KNEE, n_workers=1,
            waves=driver.WaveOptions(wave="off", **{option: 1}), **extra)
        with pytest.raises(ValueError, match=option):
            pkg.Platform(spec).run(samples, months, wl)
    runs = [port_platform.Platform(port_platform.PlatformSpec(
        knee_bytes=KNEE, n_workers=1, device="cpu",
        waves=port_driver.WaveOptions(wave="on", **kw))).run(
            samples, months, PORT_WL) for kw in ({}, {option: 1})]
    _assert_bitwise(runs[0].result, runs[1].result)
    assert runs[0].device_dispatches == runs[1].device_dispatches


def _scaleout_specs(pkg, driver, case):
    common = dict(seed=3, startup_scale=0.5)
    if case == "bts":
        return pkg.PlatformSpec(platform="BTS", n_workers=4,
                                backend="simulated", knee_bytes=6_000.0,
                                **common)
    if case == "btt_hetero":
        workers = tuple(
            ref_sch.SimWorker(i, speed=0.5 if i == 0 else 1.0)
            if pkg is ref_platform else
            port_sch.SimWorker(i, speed=0.5 if i == 0 else 1.0)
            for i in range(3))
        return pkg.PlatformSpec(platform="BTT", backend="simulated",
                                sim_workers=workers, **common)
    if case == "vh":
        return pkg.PlatformSpec(platform="VH", n_workers=8,
                                backend="simulated", **common)
    # SLO-aware pool sizing from the cost model
    return pkg.PlatformSpec(
        platform="BTS", n_workers=16, backend="simulated",
        knee_bytes=6_000.0,
        schedule=driver.ScheduleOptions(slo_seconds=0.5), **common)


def _scaleout_report(rep):
    return (rep.makespan, rep.n_tasks, rep.scale_decision, rep.queue_depths,
            rep.n_workers_used, rep.task_size_bytes, rep.max_task_bytes,
            rep.startup_time, rep.backend, rep.engine, rep.result,
            rep.restarts, rep.speculative_launches, rep.tasks_executed)


@pytest.mark.parametrize("case", ["bts", "btt_hetero", "vh", "slo"])
@pytest.mark.parametrize("model", ["per_sample", "exec_fetch"])
def test_run_scaleout_equals_reference(case, model):
    rng = np.random.default_rng(4)
    sizes = [int(s) for s in rng.integers(500, 4_000, 96)]
    if model == "per_sample":
        kw = dict(per_sample_exec=2e-3)
    else:
        kw = dict(exec_model=lambda t: 1e-3 + 1e-6 * t.size_bytes,
                  fetch_model=lambda t: 5e-4 * len(t.sample_ids))
    ref = ref_platform.Platform(_scaleout_specs(
        ref_platform, ref_driver, case)).run_scaleout(sizes, **kw)
    port_spec = dataclasses.replace(_scaleout_specs(
        port_platform, port_driver, case), device="cpu")
    port = port_platform.Platform(port_spec).run_scaleout(sizes, **kw)
    assert _scaleout_report(port) == _scaleout_report(ref)
    assert port.n_tasks > 1 and port.result is None
    assert port.engine == "cost-model" and port.backend == "simulated"
    if case == "slo" and model == "per_sample":
        assert port.scale_decision is not None


def test_run_scaleout_needs_exactly_one_cost_model():
    plat = port_platform.Platform(port_platform.PlatformSpec(
        backend="simulated", knee_bytes=KNEE, device="cpu"))
    with pytest.raises(AssertionError):
        plat.run_scaleout([4, 4])
    with pytest.raises(AssertionError):
        plat.run_scaleout([4, 4], per_sample_exec=1e-3,
                          exec_model=lambda t: 1e-3)


def test_tiny_task_facade_equals_platform_run():
    from repro_torch.core import tiny_task

    samples, months = _dataset()
    rep = tiny_task.run_subsampling_job(samples, months, PORT_WL,
                                        n_workers=2, knee_bytes=KNEE,
                                        seed=5, device="cpu")
    spec = port_platform.PlatformSpec(platform="BTS", n_workers=2,
                                      backend="threaded", knee_bytes=KNEE,
                                      seed=5, device="cpu")
    want = port_platform.Platform(spec).run(samples, months, PORT_WL)
    _assert_bitwise(rep.result, want.result)
    assert rep.n_tasks == want.n_tasks
    ref = ref_tiny_task.run_subsampling_job(samples, months, REF_WL,
                                            n_workers=2, knee_bytes=KNEE,
                                            seed=5)
    np.testing.assert_array_equal(rep.result["count"], ref.result["count"])
    for key in ("mean", "var"):
        np.testing.assert_allclose(rep.result[key], ref.result[key],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    # the same facade surface as the reference's
    assert tiny_task.PLATFORMS.keys() == ref_tiny_task.PLATFORMS.keys()
    parts = tiny_task._pad_to_common([np.ones(3, np.float32),
                                      np.ones(5, np.float32)])
    assert {p.shape for p in parts} == {
        p.shape for p in ref_tiny_task._pad_to_common(
            [np.ones(3, np.float32), np.ones(5, np.float32)])}


def test_tiny_task_facade_defaults_to_the_card():
    import torch

    from repro_torch.core import tiny_task

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    samples, months = _dataset(n=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiny_task.run_subsampling_job(samples, months, PORT_WL,
                                      knee_bytes=KNEE)


def test_engine_resolution():
    """``auto`` gives the reference's choice under the port's names: the
    ``kernel`` engine (the reference's ``pallas``) for ``moments`` and the
    ``torch`` engine (the reference's ``jnp``) for the paper's grid
    statistics; each device engine refuses the other's statistic."""
    pc = port_platform.compute
    assert pc.resolve_engine("moments", "auto") == "kernel"
    assert pc.resolve_engine("alod", "auto") == "torch"
    assert pc.resolve_engine("monthly_mean", "auto") == "torch"
    assert pc.resolve_engine("alod", "numpy") == "numpy"
    assert pc.resolve_engine("monthly_mean", "torch") == "torch"
    assert pc.wave_supported("torch") and pc.wave_supported("kernel")
    assert not pc.wave_supported("numpy")
    with pytest.raises(ValueError, match="grid statistics"):
        pc.resolve_engine("moments", "torch")
    with pytest.raises(ValueError):
        pc.resolve_engine("alod", "kernel")
    with pytest.raises(ValueError):
        pc.resolve_engine("moments", "pallas")
