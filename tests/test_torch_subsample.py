"""The paper's workloads in the PyTorch port (``repro_torch.core.subsample``
and the ``torch`` engine) against the JAX reference (``repro.core.subsample``
and its ``jnp`` engine) on the same numpy inputs, and the reference's
invariants inside the port.

Both packages get the same numpy blocks and the same seeds.  The port's
threefry reproduces jax's draws, so both gather the same elements and bin
them into the same cells: counts (``hits``, ``count``) agree exactly.  The
sums are fp32 sums of the same terms in another order (and ``alod``'s
scores come from a mean and a std summed in another order), so they agree
to ``rtol=2e-5`` with an absolute floor of ``1e-5 · max|sum|``.  The port
runs with ``device="cpu"``, where the ``subsample_grid`` wrapper takes its
plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.platform as ref_platform
import repro_torch.platform as port_platform
from repro.core import subsample as rss
from repro.platform import driver as ref_driver
from repro_torch import prng
from repro_torch.core import subsample as pss
from repro_torch.data import EagletSpec, NetflixSpec, eaglet_dataset, \
    netflix_dataset
from repro_torch.kernels import ops, ref
from repro_torch.kernels import subsample_grid as sgrid
from repro_torch.platform import compute as pc
from repro_torch.platform import driver as port_driver
import _grid_order  # tests/_grid_order.py, beside this file

RTOL, ATOL_SCALE = 2e-5, 1e-5
COUNT_KEYS = ("hits", "count")


def _assert_partials(want, got):
    assert set(want) == set(got)
    for key in want:
        w, g = np.asarray(want[key]), np.asarray(got[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if key in COUNT_KEYS:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(
                g, w, rtol=RTOL, atol=ATOL_SCALE * float(np.abs(w).max()),
                err_msg=key)


def _block(ns, sl, grid, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((ns, sl)).astype(np.float32)
    # months reach past [0, grid) on both sides: the statistic clips them
    months = rng.integers(-3, grid + 4, (ns, sl)).astype(np.int32)
    return data, months


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


# -- the draws and the map task -----------------------------------------------


@pytest.mark.parametrize("shape,hi", [((30, 4, 256), 2048), ((8, 3, 33), 96),
                                      ((8, 1, 2048), 65536),
                                      ((1, 64, 32), 512)])
@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_randint_at_the_map_task_shape_matches_jax(shape, hi, seed):
    want = jax.random.randint(jax.random.PRNGKey(seed), shape, 0, hi)
    got = pss.draw_indices(prng.PRNGKey(seed), shape[1], hi,
                           draws=shape[0], draw_size=shape[2])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("statistic,grid", [("alod", 64), ("alod", 120),
                                            ("monthly_mean", 120),
                                            ("monthly_mean", 8)])
@pytest.mark.parametrize("ns,sl,draws,ds", [(3, 64, 4, 16), (2, 96, 5, 33),
                                            (1, 512, 3, 200),
                                            (4, 256, 30, 256)])
def test_map_task_matches_reference(statistic, grid, ns, sl, draws, ds):
    for seed in (0, 11, 2**31 - 1):
        data, months = _block(ns, sl, grid, seed)
        kw = dict(draws=draws, draw_size=ds, grid=grid, statistic=statistic)
        want = rss.map_task(jnp.asarray(data), jnp.asarray(months),
                            jax.random.PRNGKey(seed), **kw)
        got = pss.map_task(torch.from_numpy(data), torch.from_numpy(months),
                           prng.PRNGKey(seed), **kw)
        _assert_partials({k: np.asarray(v) for k, v in want.items()},
                         {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("wl", list(pss.WORKLOADS.values()), ids=str)
def test_workloads_are_the_reference_ones(wl):
    want = rss.WORKLOADS[wl.name]
    assert (wl.name, wl.statistic, wl.draws, wl.draw_size, wl.grid) == (
        want.name, want.statistic, want.draws, want.draw_size, want.grid)


@pytest.mark.parametrize("name", ["eaglet", "netflix_low"])
def test_run_map_task_np_matches_reference(name):
    """One task as a wave of one through ``subsample_grid``'s wrapper (the
    plain version on the CPU) against the reference's jitted map task,
    on a block of the padded power-of-two length the platform builds."""
    wl_ref, wl_port = rss.WORKLOADS[name], pss.WORKLOADS[name]
    data, months = _block(5, 1024, wl_port.grid, 3)
    want = rss.run_map_task_np(data, months, 42, wl_ref)
    got = pss.run_map_task_np(data, months, 42, wl_port, device="cpu")
    _assert_partials(want, got)


@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
def test_reduce_stats_matches_reference(statistic):
    rng = np.random.default_rng(1)
    keys = (("sum_curve", "hits") if statistic == "alod"
            else ("sum", "count"))
    partials = [{k: rng.random(12).astype(np.float32) * (k != "hits")
                 + rng.integers(0, 5, 12).astype(np.float32)
                 for k in keys} for _ in range(5)]
    if statistic == "alod":
        for i, p in enumerate(partials):
            p["count"] = np.asarray(float(10 + i), np.float32)
    want = rss.reduce_stats(partials, statistic)
    got = pss.reduce_stats(partials, statistic)
    _assert_bitwise(want, got)


def test_exhaustive_monthly_mean_matches_reference():
    data, months = _block(6, 300, 24, 9)
    np.testing.assert_array_equal(
        pss.exhaustive_monthly_mean(data, months, 24),
        rss.exhaustive_monthly_mean(data, months, 24))


# -- the kernel's plain version and its wrapper -------------------------------


def test_plain_version_is_map_task_per_slot():
    """Task ``b`` of ``subsample_grid`` reads slot ``rows[b]``: the same as
    ``grid_partial`` on that slot's block alone."""
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.standard_normal((3, 2, 128)).astype(
        np.float32))
    months = torch.from_numpy(rng.integers(0, 30, (3, 2, 128)).astype(
        np.int32))
    rows = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    idx = torch.from_numpy(rng.integers(0, 128, (4, 5, 2, 40)).astype(
        np.int32))
    for statistic in ("alod", "monthly_mean"):
        out = ops.subsample_grid(data, months, rows, idx, grid=30,
                                 statistic=statistic)
        assert out.shape == (4, 2, 30) and out.dtype == torch.float32
        for b, r in enumerate(rows.tolist()):
            assert torch.equal(out[b], ref.grid_partial(
                data[r], months[r], idx[b], grid=30, statistic=statistic))
        assert float(out[:, 1].sum()) == 4 * 5 * 2 * 40


@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
def test_plain_version_in_float64_is_an_exact_oracle(statistic):
    """Float64 data gives the fp32 version's cells and counts, with the
    scores and sums in float64: ``chip_smoke.py`` holds the kernel to it,
    since the fp32 version adds with atomics on the card, in no fixed
    order.  The same partial as numpy float64 from the same indices."""
    import chip_smoke

    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.standard_normal((3, 500)).astype(
        np.float32))
    months = torch.from_numpy(rng.integers(-3, 40, (3, 500)).astype(
        np.int32))
    idx = torch.from_numpy(rng.integers(0, 500, (6, 3, 77)).astype(
        np.int32))
    single = ref.grid_partial(data, months, idx, grid=30,
                              statistic=statistic)
    double = ref.grid_partial(data.double(), months, idx, grid=30,
                              statistic=statistic)
    assert single.dtype == torch.float32 and double.dtype == torch.float64
    assert torch.equal(double[1], single[1].double())
    host = chip_smoke._grid_f64(data.numpy(), months.numpy(), idx.numpy(),
                                30, statistic)[0]
    np.testing.assert_allclose(double.numpy(), host, rtol=1e-12, atol=1e-12)


def test_cpu_tensors_do_not_count_as_launches():
    data, months = _block(2, 64, 16, 0)
    before = ops.launch_count("subsample_grid")
    ops.subsample_grid(torch.from_numpy(data)[None],
                       torch.from_numpy(months)[None],
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros((1, 3, 2, 8), dtype=torch.int32),
                       grid=16, statistic="monthly_mean")
    assert ops.launch_count("subsample_grid") == before


@pytest.mark.parametrize("case", ["rows_int64", "idx_3d", "ns_mismatch",
                                  "months_int64", "grid_too_wide", "grid_zero",
                                  "bad_statistic", "months_shape",
                                  "fp64_data", "strided", "counts_inexact"])
def test_op_rejects_what_the_kernel_does_not_take(case):
    data = torch.zeros((2, 3, 64))
    months = torch.zeros((2, 3, 64), dtype=torch.int32)
    rows = torch.zeros(4, dtype=torch.int32)
    idx = torch.zeros((4, 5, 3, 16), dtype=torch.int32)
    kw = dict(grid=64, statistic="monthly_mean")
    if case == "rows_int64":
        rows = rows.long()
    elif case == "idx_3d":
        idx = idx[0]
    elif case == "ns_mismatch":
        idx = torch.zeros((4, 5, 2, 16), dtype=torch.int32)
    elif case == "months_int64":
        months = months.long()
    elif case == "grid_too_wide":
        kw["grid"] = 513
    elif case == "grid_zero":
        kw["grid"] = 0
    elif case == "bad_statistic":
        kw["statistic"] = "moments"
    elif case == "months_shape":
        months = months[:, :, :32]
    elif case == "fp64_data":
        data = data.double()
    elif case == "strided":
        data = torch.zeros((2, 3, 128))[:, :, ::2]
    elif case == "counts_inexact":
        # 3 x 4,096 x 2,048 drawn elements, 2**24 and more: a view, no memory
        idx = torch.zeros(1, dtype=torch.int32).expand(1, 2 ** 12, 3, 2 ** 11)
        rows = rows[:1]
    with pytest.raises((ValueError, TypeError)):
        ops.subsample_grid(data, months, rows, idx, **kw)


@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
@pytest.mark.parametrize("case", _grid_order.CASES)
def test_grid_order_emulation_matches_plain_version(case, statistic):
    """The kernel's fixed order (tests/_grid_order.py), one fp32 add at a
    time on the CPU, against the plain version on the same indices at
    shapes that take each branch of it: counts equal, sums within the
    stated tolerance.  The card tests hold the kernel to this emulation bit
    for bit."""
    data, months, rows, idx = _grid_order.inputs(*case, seed=sum(case))
    grid = case[-1]
    got = _grid_order.emulate(data, months, rows, idx, grid=grid,
                              statistic=statistic)
    want = ref.subsample_grid_ref(
        *(torch.from_numpy(a) for a in (data, months, rows, idx)),
        grid=grid, statistic=statistic).numpy()
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL,
                               atol=ATOL_SCALE * float(np.abs(want[:, 0]).max()))


def test_grid_plan_is_fixed_by_the_shape():
    """``subsample_grid``'s cut depends on the shape alone: a forced body
    keeps the groups and copies of the one chosen (so the order, and the
    bits, stay); the staged body is taken where a row fits beside the bins
    and has as many draws as elements, refused where it does not fit."""
    nh = dict(draws=8, draw_size=2048, grid=120, statistic="monthly_mean")
    for sl, body, groups in ((16384, "staged", 2), (32768, "direct", 4),
                             (65536, "direct", 4)):
        cut = sgrid.plan(sl, **nh)
        assert (cut.body, cut.groups, cut.copies) == (body, groups, 4)
        other = "direct" if body == "staged" else "staged"
        if sgrid.stageable(sl, 120, "monthly_mean"):
            assert sgrid.plan(sl, **nh, body=other) == sgrid.Plan(
                other, groups, 4)
        else:
            with pytest.raises(ValueError):
                sgrid.plan(sl, **nh, body=other)
    # a row just inside and one just past shared memory
    last = max(sl for sl in range(4, 65536, 4)
               if sgrid.stageable(sl, 120, "monthly_mean"))
    assert sgrid.staged_bytes(last, 120) <= sgrid.MAX_SMEM
    assert sgrid.staged_bytes(last + 4, 120) > sgrid.MAX_SMEM
    assert sgrid.plan(last, 8, 2 * last, 120, "monthly_mean").body == "staged"
    assert sgrid.plan(last + 4, 8, 2 * last, 120,
                      "monthly_mean").body == "direct"
    # EAGLET's rows never fit; NETFLIX_LOW's 256 draws a row never pay
    assert sgrid.plan(524288, 30, 256, 64, "alod") == sgrid.Plan("direct", 4,
                                                                 8)
    assert sgrid.plan(32768, 8, 32, 120, "monthly_mean").body == "direct"
    # alod is never staged, whatever its row
    assert not sgrid.stageable(4096, 64, "alod")
    with pytest.raises(ValueError):
        sgrid.plan(4096, 30, 256, 64, "alod", body="staged")
    # unaligned data, or months past a byte, go direct
    assert sgrid.plan(16384, **nh, aligned=False).body == "direct"
    assert sgrid.plan(4096, 8, 2048, 512, "monthly_mean").body == "direct"
    assert sgrid.copies_for(512) == 1 and sgrid.copies_for(8) == 32


def test_alod_ignores_the_months_plane():
    data, months = _block(2, 64, 64, 5)
    idx = pss.draw_indices(prng.PRNGKey(3), 2, 64, draws=4, draw_size=20)
    args = (torch.zeros(1, dtype=torch.int32), idx[None])
    kw = dict(grid=64, statistic="alod")
    data = torch.from_numpy(data)[None]
    months = torch.from_numpy(months)[None]
    assert torch.equal(ops.subsample_grid(data, months, *args, **kw),
                       ops.subsample_grid(data, months * 0 - 7, *args, **kw))


# -- the draw form: indices from the seeds --------------------------------------


def _arena(n_slots, ns, sl, grid, seed):
    blocks = [_block(ns, sl, grid, seed + k) for k in range(n_slots)]
    return (np.stack([d for d, _ in blocks]), np.stack([m for _, m in blocks]))


SEEDED_CASES = [  # statistic, grid, n_slots, ns, sl, draws, ds
    ("alod", 64, 3, 4, 256, 30, 16),
    ("alod", 120, 2, 3, 300, 5, 33),        # sl not a power of two
    ("monthly_mean", 120, 3, 4, 512, 8, 64),
    ("monthly_mean", 8, 2, 2, 1000, 3, 7),
]


@pytest.mark.parametrize("case", SEEDED_CASES, ids=str)
def test_seeded_op_is_the_read_op_on_prng_indices(case):
    """On CPU tensors the draw form is ``prng.randint``'s indices fed to
    the read form, bit for bit, and counts no launch."""
    statistic, grid, n_slots, ns, sl, draws, ds = case
    data, months = (torch.from_numpy(a) for a in _arena(n_slots, ns, sl,
                                                         grid, 1))
    rows = torch.tensor([2 % n_slots, 0, 1, 0], dtype=torch.int32)
    seeds = torch.tensor([-1, 0, 2**31 - 1, -2**31], dtype=torch.int32)
    idx = prng.randint(prng.PRNGKey(seeds), (draws, ns, ds), 0, sl)
    before = ops.launch_count("subsample_grid")
    got = ops.subsample_grid_seeded(data, months, rows, seeds, draws=draws,
                                    draw_size=ds, grid=grid,
                                    statistic=statistic)
    assert ops.launch_count("subsample_grid") == before
    assert torch.equal(got, ops.subsample_grid(data, months, rows, idx,
                                               grid=grid,
                                               statistic=statistic))


@pytest.mark.parametrize("name", ["eaglet", "netflix_high", "netflix_low"])
def test_seeded_op_matches_reference_jnp_wave(name):
    """The draw form against the reference's jitted wave body
    (``_jnp_wave_jit``: ``jax.random.randint`` and ``map_task`` under
    ``jax.vmap``) on the same arena, slots and seeds: counts equal, sums
    within the stated tolerance."""
    from repro.platform import compute as ref_compute

    wl = pss.WORKLOADS[name]
    draws, ds = wl.draws, min(wl.draw_size, 256)      # small on the CPU
    data, months = _arena(3, 4, 1024, wl.grid, 7)
    rows = np.asarray([1, 0, 2, 1, 1], np.int32)
    seeds = np.asarray([3, -1, 2**31 - 1, -2**31, 12], np.int32)
    want = ref_compute._jnp_wave_jit()(
        jnp.asarray(data), jnp.asarray(months), jnp.asarray(rows),
        jnp.asarray(seeds), draws=draws, draw_size=ds, grid=wl.grid,
        statistic=wl.statistic)
    got = ops.subsample_grid_seeded(
        torch.from_numpy(data), torch.from_numpy(months),
        torch.from_numpy(rows), torch.from_numpy(seeds), draws=draws,
        draw_size=ds, grid=wl.grid, statistic=wl.statistic).numpy()
    sums, counts = (("sum_curve", "hits") if wl.statistic == "alod"
                    else ("sum", "count"))
    np.testing.assert_array_equal(got[:, 1], np.asarray(want[counts]))
    w = np.asarray(want[sums])
    np.testing.assert_allclose(got[:, 0], w, rtol=RTOL,
                               atol=ATOL_SCALE * float(np.abs(w).max()))


@pytest.mark.parametrize("case", [
    "seeds_int64", "seeds_2d", "seeds_short", "rows_int64", "fp64_data",
    "months_int64", "sl_zero", "draws_past_2_32", "grid_zero", "strided"])
def test_seeded_op_rejects_what_the_kernel_does_not_take(case):
    data = torch.zeros((2, 3, 64))
    months = torch.zeros((2, 3, 64), dtype=torch.int32)
    rows = torch.zeros(4, dtype=torch.int32)
    seeds = torch.zeros(4, dtype=torch.int32)
    kw = dict(draws=5, draw_size=16, grid=64, statistic="monthly_mean")
    if case == "seeds_int64":
        seeds = seeds.long()
    elif case == "seeds_2d":
        seeds = seeds[:, None]
    elif case == "seeds_short":
        seeds = seeds[:3]
    elif case == "rows_int64":
        rows = rows.long()
    elif case == "fp64_data":
        data = data.double()
    elif case == "months_int64":
        months = months.long()
    elif case == "sl_zero":
        data, months = data[:, :, :0], months[:, :, :0]
    elif case == "draws_past_2_32":
        kw["draws"] = 2 ** 32 // (3 * 16) + 1      # ns x ds = 3 x 16
    elif case == "grid_zero":
        kw["grid"] = 0
    elif case == "strided":
        seeds = torch.zeros(8, dtype=torch.int32)[::2]
    with pytest.raises((ValueError, TypeError)):
        ops.subsample_grid_seeded(data, months, rows, seeds, **kw)


@pytest.mark.parametrize("case", ["int64", "2d", "past_2_32", "hi_past_int32",
                                  "strided"])
def test_randint_op_rejects_what_the_kernel_does_not_take(case):
    seeds = torch.zeros(3, dtype=torch.int32)
    shape, hi = (4, 5), 10
    if case == "int64":
        seeds = seeds.long()
    elif case == "2d":
        seeds = seeds[None]
    elif case == "past_2_32":
        shape = (2 ** 16, 2 ** 16)
    elif case == "hi_past_int32":
        hi = 2 ** 31
    elif case == "strided":
        seeds = torch.zeros(6, dtype=torch.int32)[::2]
    with pytest.raises((ValueError, TypeError)):
        ops.randint(seeds, shape, 0, hi)


def test_randint_op_is_prng_randint_on_the_cpu():
    seeds = torch.tensor([-1, -2**31, 2**31 - 1, 0, 15], dtype=torch.int32)
    before = ops.launch_count("threefry_randint")
    got = ops.randint(seeds, (8, 3, 33), 0, 1000)
    assert ops.launch_count("threefry_randint") == before
    assert torch.equal(got, prng.randint(prng.PRNGKey(seeds), (8, 3, 33), 0,
                                         1000))


# -- the torch engine: waves against per-task ---------------------------------


def _arena_tasks(wl, n_tasks=7, ns=3, sl=256, seed=0):
    """``n_tasks`` same-shape blocks packed into a CPU arena with their
    months, as the driver packs them for the torch engine."""
    from repro_torch.core.scheduler import Task

    blocks = [_block(ns, sl, wl.grid, seed + t) for t in range(n_tasks)]
    tasks = [Task(task_id=t, sample_ids=(t,), size_bytes=1.0)
             for t in range(n_tasks)]
    arena = pc.BlockArena.pack(tasks, lambda t: (ns, sl),
                               lambda t: blocks[t.task_id], with_months=True,
                               device="cpu")
    return arena, tasks, blocks


@pytest.mark.parametrize("name", ["eaglet", "netflix_high", "netflix_low"])
@pytest.mark.parametrize("width", [1, 2, 5, 16])
def test_wave_partials_equal_per_task_bitwise(name, width):
    """Each task's partial out of a wave (padded to a power of two by
    repeating the first slot and seed) equals its per-task partial bit
    for bit, and so do the padded lanes, which repeat task 0."""
    wl = pss.WORKLOADS[name]
    arena, tasks, blocks = _arena_tasks(wl, n_tasks=max(width, 3))
    wave = tasks[-width:]
    seeds = np.asarray([100 + t.task_id for t in wave], np.int32)
    per_task = [pc.run_map_task(blocks[t.task_id][0], blocks[t.task_id][1],
                                int(s), wl, "torch", device="cpu")
                for t, s in zip(wave, seeds)]
    got = pc.run_map_wave(arena, wave, seeds, wl, "torch")
    assert len(got) == width
    for want, have in zip(per_task, got):
        _assert_bitwise(want, have)
    key, rows = arena.slots(wave)
    data, months = arena.bucket(key)
    b_pad = pc.pow2_ceil(width)
    rows = np.concatenate([rows, np.repeat(rows[:1], b_pad - width)])
    lanes = pss.split_partials(
        pss.map_wave(data, months, rows, np.concatenate(
            [seeds, np.repeat(seeds[:1], b_pad - width)]), wl).numpy(),
        wl, data.shape[1])
    for lane in lanes[width:]:
        _assert_bitwise(per_task[0], lane)


@pytest.mark.parametrize("name", ["eaglet", "netflix_high", "netflix_low"])
@pytest.mark.parametrize("width", [1, 3, 5])
def test_torch_wave_below_the_pinned_width_is_unchanged(name, width):
    """A ``torch`` wave of ``b`` tasks, below a pinned width of 16, launches
    over its ``b`` tasks only (``run_map_wave`` takes no pinned width), and
    gives the partials that the launch padded to 16 gave (lanes repeating
    the first slot and seed, indices from ``prng.randint``, the read
    form), bit for bit."""
    wl = pss.WORKLOADS[name]
    arena, tasks, _ = _arena_tasks(wl, n_tasks=6)
    wave = tasks[:width]
    seeds = np.asarray([-5 + 3 * t.task_id for t in wave], np.int32)
    got = pc.run_map_wave(arena, wave, seeds, wl, "torch")
    key, rows = arena.slots(wave)
    data, months = arena.bucket(key)
    pad = 16 - width
    rows_p = torch.from_numpy(np.concatenate([rows, np.repeat(rows[:1],
                                                              pad)]))
    seeds_p = torch.from_numpy(np.concatenate([seeds, np.repeat(seeds[:1],
                                                                pad)]))
    idx = prng.randint(prng.PRNGKey(seeds_p), (wl.draws, data.shape[1],
                                               wl.draw_size),
                       0, data.shape[2])
    before = ops.subsample_grid(data, months, rows_p, idx, grid=wl.grid,
                                statistic=wl.statistic)
    want = pss.split_partials(before[:width].numpy(), wl, data.shape[1])
    assert len(got) == width
    for w, g in zip(want, got):
        _assert_bitwise(w, g)


# -- Platform.run end to end ---------------------------------------------------


def _dataset(name):
    if name == "eaglet":
        return eaglet_dataset(EagletSpec(n_families=12, mean_markers=96))
    return netflix_dataset(NetflixSpec(n_movies=20, mean_ratings=160))


def _spec(pkg, *, wave, n_workers=1, backend="threaded", knee_count=4,
          samples, **kw):
    mean = float(np.mean([a.nbytes for a in samples.values()]))
    driver = ref_driver if pkg is ref_platform else port_driver
    return pkg.PlatformSpec(
        platform="BTS", n_workers=n_workers, backend=backend, seed=3,
        knee_bytes=knee_count * mean,
        waves=driver.WaveOptions(wave=wave, max_wave=4), **kw)


def _run_port(samples, months, wl, **kw):
    return port_platform.Platform(_spec(
        port_platform, samples=samples, device="cpu", **kw)).run(
            samples, months, wl)


@pytest.mark.parametrize("name", ["eaglet", "netflix_high", "netflix_low"])
@pytest.mark.parametrize("wave", ["on", "off"])
def test_platform_run_matches_reference(name, wave):
    samples, months = _dataset(name)
    ref = ref_platform.Platform(_spec(ref_platform, samples=samples,
                                      wave=wave)).run(
        samples, months, rss.WORKLOADS[name])
    port = _run_port(samples, months, pss.WORKLOADS[name], wave=wave)
    assert ref.engine == "jnp" and port.engine == "torch"
    plan_kw = dict(sizing="kneepoint", n_exec=1,
                   knee_bytes=_spec(port_platform, samples=samples,
                                    wave=wave).knee_bytes)
    ref_plan = ref_driver.plan_job(samples, months, rss.WORKLOADS[name],
                                   engine="jnp", **plan_kw)
    port_plan = port_driver.plan_job(samples, months, pss.WORKLOADS[name],
                                     engine="torch", device="cpu", **plan_kw)
    assert [t.sample_ids for t in port_plan.tasks] == \
        [t.sample_ids for t in ref_plan.tasks]
    assert port.n_tasks == ref.n_tasks > 1
    assert port.device_dispatches == ref.device_dispatches
    assert port.wave_sizes == ref.wave_sizes
    assert port.bytes_uploaded == ref.bytes_uploaded
    assert set(port.result) == set(ref.result)
    for key, want in ref.result.items():
        want = np.asarray(want)
        got = np.asarray(port.result[key])
        if key in ("count", "n"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL,
                                       atol=ATOL_SCALE * np.abs(want).max(),
                                       err_msg=key)


@pytest.mark.parametrize("name", ["eaglet", "netflix_low"])
def test_threaded_equals_simulated_bitwise(name):
    samples, months = _dataset(name)
    wl = pss.WORKLOADS[name]
    thr = _run_port(samples, months, wl, wave="on", n_workers=2)
    sim = _run_port(samples, months, wl, wave="off", backend="simulated",
                    n_workers=3)
    _assert_bitwise(thr.result, sim.result)


@pytest.mark.parametrize("name", ["eaglet", "netflix_high"])
def test_wave_equals_per_task_bitwise(name):
    samples, months = _dataset(name)
    wl = pss.WORKLOADS[name]
    per = _run_port(samples, months, wl, wave="off", n_workers=2)
    wav = _run_port(samples, months, wl, wave="on", n_workers=2)
    assert per.device_dispatches == per.n_tasks
    assert sum(wav.wave_sizes) == wav.n_tasks
    _assert_bitwise(per.result, wav.result)


def test_auto_waves_only_the_small_draw_workload():
    """``wave="auto"`` batches NETFLIX_LOW (8 × 32 drawn elements) and
    keeps EAGLET (7,680) and NETFLIX_HIGH (16,384) per task, as the
    reference does."""
    for name, waved in (("netflix_low", True), ("eaglet", False),
                        ("netflix_high", False)):
        samples, months = _dataset(name)
        rep = _run_port(samples, months, pss.WORKLOADS[name], wave="auto")
        assert rep.engine == "torch"
        assert bool(rep.wave_sizes) == waved, name


def test_kneepoint_sizing_measures_the_torch_engine():
    """With no explicit knee, the offline kneepoint phase times isolated
    tasks of the job's own engine: here ``torch`` on the CPU."""
    samples, months = _dataset("netflix_low")
    plan = port_driver.plan_job(samples, months, pss.NETFLIX_LOW,
                                sizing="kneepoint", engine="torch", n_exec=2,
                                kneepoint_sizes=(1, 2, 4), device="cpu")
    assert plan.knee_res is not None and plan.knee_bytes > 0
    assert len(plan.knee_res.curve) == 3
    assert sum(len(t.sample_ids) for t in plan.tasks) == len(samples)


def test_the_card_is_the_default_and_nothing_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    data, months = _block(2, 64, 120, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pss.run_map_task_np(data, months, 0, pss.NETFLIX_LOW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.run_map_task(data, months, 0, pss.EAGLET, "torch")
