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

import numpy as np
import pytest

import repro.platform as ref_platform
import repro_torch.platform as port_platform
from repro.platform import driver as ref_driver
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


@pytest.mark.parametrize("option", ["datastore", "fault_injector",
                                    "checkpoint_dir", "mesh_devices",
                                    "resume_from", "run_scaleout"])
def test_deferred_options_raise(option):
    samples, months = _dataset(n=4)
    spec_kw = dict(device="cpu", knee_bytes=KNEE)
    init_kw = {}
    if option == "checkpoint_dir":
        spec_kw["faults"] = port_driver.FaultOptions(checkpoint_dir="ckpt")
    elif option == "mesh_devices":
        spec_kw["waves"] = port_driver.WaveOptions(mesh_devices=1)
    elif option in ("datastore", "fault_injector"):
        init_kw[option] = object()
    with pytest.raises(NotImplementedError, match="later slice"):
        plat = port_platform.Platform(port_platform.PlatformSpec(**spec_kw),
                                      **init_kw)
        if option == "resume_from":
            plat.run(samples, months, PORT_WL, resume_from="ckpt")
        elif option == "run_scaleout":
            plat.run_scaleout([4, 4], per_sample_exec=1e-3)


def test_engine_resolution():
    pc = port_platform.compute
    assert pc.resolve_engine("moments", "auto") == "kernel"
    assert pc.resolve_engine("alod", "numpy") == "numpy"
    for statistic, prefer in (("alod", "auto"), ("monthly_mean", "auto"),
                              ("moments", "torch")):
        with pytest.raises(NotImplementedError, match="next slice"):
            pc.resolve_engine(statistic, prefer)
    with pytest.raises(ValueError):
        pc.resolve_engine("alod", "kernel")
    with pytest.raises(ValueError):
        pc.resolve_engine("moments", "pallas")
