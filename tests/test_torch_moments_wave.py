"""The ``kernel`` engine's wave: ``ops.subsample_stats_seeded`` against the
reference's own wave, and the unpadded wave against per-task execution.

The reference's wave (``repro.platform.compute._moments_wave_jit``) takes
the slots out of the resident arena, draws each task's rows with
``jax.random.randint`` under ``vmap`` and runs its Pallas kernel, in
interpret mode here.  The port's op, given CPU tensors, runs its plain
version: ``prng.randint`` (jax's draws, bit for bit), then
``subsample_stats_ref`` on ``arena[rows]`` (on the card the kernel reads
the arena through the slots and draws the rows itself; ``chip_smoke.py``
phase 3 and ``tests/test_torch_cuda.py`` hold it against this version).
Inputs are made with numpy from a seed.

Tolerance against the reference: ``rtol=1e-5, atol=1e-4``.  Both sides sum
the same fp32 rows, but in other orders inside each 8-row group, so they
agree to a few ulps of the sums, not bit for bit.  Everything inside the
port is compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.platform import compute as ref_compute
from repro_torch import prng
from repro_torch.kernels import ops, ref
from repro_torch.platform import compute as pc

RTOL, ATOL = 1e-5, 1e-4


def _arena(n_slots, n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_slots, n, d)).astype(np.float32)


# slots out of order, one repeated
ROWS = np.asarray([4, 0, 3, 4, 1], np.int32)
SEEDS = np.asarray([7, -3, 2 ** 31 - 1, 7, 0], np.int32)


@pytest.mark.parametrize("n,d,n_idx", [
    (64, 96, 512),       # the main path's N and draws: a power-of-two span
    (40, 128, 64),       # a multiplier that is not 0: two hashes a draw
    (40, 36, 13),        # T not a multiple of 8
])
def test_seeded_stats_match_the_reference_wave(n, d, n_idx):
    arena = _arena(6, n, d, seed=n + d + n_idx)
    want = np.asarray(ref_compute._moments_wave_jit()(
        jnp.asarray(arena), jnp.asarray(ROWS), jnp.asarray(SEEDS), n=n_idx))
    got = ops.subsample_stats_seeded(
        torch.from_numpy(arena), torch.from_numpy(ROWS),
        torch.from_numpy(SEEDS), n_idx=n_idx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 2, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the repeated slot with the repeated seed is the same task
    assert torch.equal(got[0], got[3])


@pytest.mark.parametrize("n,rows_per_step", [(64, 8), (40, 8), (40, 3),
                                             (7, 256)])
def test_seeded_plain_version_is_the_read_form_on_prng_draws(n,
                                                             rows_per_step):
    """The draw form's plain version equals ``subsample_stats_ref`` on
    ``arena[rows]`` and ``prng.randint``'s indices, bit for bit."""
    arena = torch.from_numpy(_arena(6, n, 40, seed=n))
    rows, seeds = torch.from_numpy(ROWS), torch.from_numpy(SEEDS)
    idx = prng.randint(prng.PRNGKey(seeds), (300,), 0, n)
    want = ref.subsample_stats_ref(arena[rows.long()], idx,
                                   rows_per_step=rows_per_step)
    got = ops.subsample_stats_seeded(arena, rows, seeds, n_idx=300,
                                     rows_per_step=rows_per_step)
    assert torch.equal(got, want)
    assert torch.equal(got, ops.subsample_stats(
        arena[rows.long()].contiguous(), idx, rows_per_step=rows_per_step))


def test_seeded_stats_on_the_cpu_count_no_launch():
    before = ops.launch_count()
    ops.subsample_stats_seeded(torch.from_numpy(_arena(6, 8, 16, 0)),
                               torch.from_numpy(ROWS),
                               torch.from_numpy(SEEDS), n_idx=8)
    assert ops.launch_count() == before


@pytest.mark.parametrize("case", ["rows_past_the_arena", "negative_row",
                                  "int64_rows", "int64_seeds", "seeds_shape",
                                  "fp16", "strided", "rows_per_step",
                                  "n_idx_2_32", "no_rows_to_draw"])
def test_seeded_op_rejects_what_the_kernel_does_not_take(case):
    arena = torch.zeros((6, 8, 16), dtype=torch.float32)
    rows = torch.from_numpy(ROWS.copy())
    seeds = torch.from_numpy(SEEDS.copy())
    kw = dict(n_idx=8)
    if case == "rows_past_the_arena":
        rows[2] = 6
    elif case == "negative_row":
        rows[0] = -1
    elif case == "int64_rows":
        rows = rows.long()
    elif case == "int64_seeds":
        seeds = seeds.long()
    elif case == "seeds_shape":
        seeds = seeds[:3]
    elif case == "fp16":
        arena = arena.half()
    elif case == "strided":
        arena = arena.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "rows_per_step":
        kw["rows_per_step"] = 0
    elif case == "n_idx_2_32":
        kw["n_idx"] = 2 ** 32
    else:
        arena = arena[:, :0]
    with pytest.raises((TypeError, ValueError)):
        ops.subsample_stats_seeded(arena, rows, seeds, **kw)


# -- run_map_wave on the kernel engine ---------------------------------------


def _moments_arena(n_tasks=6, count=5, length=48, seed=0):
    """``n_tasks`` same-shape blocks packed into a CPU arena, as the driver
    packs them for the ``kernel`` engine (no months plane)."""
    from repro_torch.core.scheduler import Task

    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((n_tasks, count, length)).astype(np.float32)
    tasks = [Task(task_id=t, sample_ids=(t,), size_bytes=1.0)
             for t in range(n_tasks)]
    arena = pc.BlockArena.pack(
        tasks, lambda t: (count, length),
        lambda t: (blocks[t.task_id], np.zeros((count, length), np.int32)),
        with_months=False, device="cpu")
    return arena, tasks, blocks


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


WL = pc.MomentsSpec(draws=4, draw_size=16)


def test_kernel_wave_of_three_equals_three_waves_of_one():
    arena, tasks, blocks = _moments_arena()
    wave = [tasks[4], tasks[1], tasks[2]]
    seeds = np.asarray([11, -11, 5], np.int32)
    got = pc.run_map_wave(arena, wave, seeds, WL, "kernel")
    assert len(got) == 3
    for task, seed, lane in zip(wave, seeds, got):
        alone = pc.run_map_wave(arena, [task], seed[None], WL, "kernel")
        _assert_bitwise(alone[0], lane)
        per_task = pc.run_map_task(blocks[task.task_id], None, int(seed), WL,
                                   "kernel", device="cpu")
        _assert_bitwise(per_task, lane)


def test_kernel_wave_equals_the_first_lanes_of_a_wider_wave():
    arena, tasks, _ = _moments_arena()
    seeds = np.asarray([3, 1, 4, 1, 5, 9], np.int32)
    wide = pc.run_map_wave(arena, tasks, seeds, WL, "kernel")
    narrow = pc.run_map_wave(arena, tasks[:3], seeds[:3], WL, "kernel")
    for a, b in zip(narrow, wide[:3]):
        _assert_bitwise(a, b)


def test_kernel_wave_is_one_seeded_launch_over_its_own_tasks(monkeypatch):
    """The wave is one call of the op, handed its own slots and seeds,
    unpadded, and the arena bucket itself (no gathered copy of it)."""
    arena, tasks, _ = _moments_arena()
    calls = []
    seeded = ops.subsample_stats_seeded

    def spy(data, rows, seeds, **kw):
        calls.append((data is arena.bucket((5, 48))[0], rows.tolist(),
                      seeds.tolist(), kw))
        return seeded(data, rows, seeds, **kw)

    monkeypatch.setattr(ops, "subsample_stats_seeded", spy)
    pc.run_map_wave(arena, tasks[2:5], np.asarray([1, 2, 3], np.int32), WL,
                    "kernel")
    assert calls == [(True, [2, 3, 4], [1, 2, 3], {"n_idx": 64})]
