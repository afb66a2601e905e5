"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here but the check of a kernel source is marked
``cuda`` and skips on a machine without a CUDA device.  This file imports
neither JAX nor the reference package, so it also runs where JAX is not
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import math
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.config import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, ref
from repro_torch.kernels import subsample_grid as sgrid
from repro_torch.models import Model
from repro_torch.models import layers as L
import _decode_tol  # tests/_decode_tol.py, beside this file
import _grid_order  # tests/_grid_order.py, beside this file

# The kernel and its plain version add the same fp32 values in the same
# order without fused multiply-adds, so they should agree bit for bit;
# the tolerance is that of the reference comparison (different orders).
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (sm_90a)")
    return torch.device("cuda")


def _inputs(b, n, d, t, seed, device):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((b, n, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, t)).astype(np.int32)
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(idx).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,t", [(3, 40, 96, 13), (4, 64, 4096, 512),
                                     (2, 17, 30, 21), (1, 8, 1028, 0)])
def test_kernel_matches_plain_version(cuda, b, n, d, t):
    x, i = _inputs(b, n, d, t, b + n + d + t, cuda)
    before = ops.launch_count()
    got = ops.subsample_stats(x, i)
    torch.cuda.synchronize()
    assert ops.launch_count() == before + 1
    want = ref.subsample_stats_ref(x, i)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    singles = torch.cat([ops.subsample_stats(x[k:k + 1], i[k:k + 1])
                         for k in range(b)])
    assert torch.equal(got, singles)


@pytest.mark.cuda
def test_kernel_rejects_cpu_indices_with_cuda_data(cuda):
    x, i = _inputs(1, 8, 16, 8, 0, cuda)
    with pytest.raises(ValueError):
        ops.subsample_stats(x, i.cpu())


# -- subsample_stats' draw form: the arena read through slots, rows drawn in
# -- the kernel


def _stats_arena(n_slots, n, d, b, seed, device):
    """An arena of ``n_slots`` blocks [n, d], a wave of ``b`` slots out of
    order (repeating where ``b`` > ``n_slots``) and ``b`` seeds."""
    rng = np.random.default_rng(seed)
    arena = rng.standard_normal((n_slots, n, d)).astype(np.float32)
    rows = ((np.arange(b) * 7 + 3) % n_slots).astype(np.int32)
    seeds = np.arange(-b, b, 2).astype(np.int32) * 977
    return tuple(torch.from_numpy(x).to(device) for x in (arena, rows, seeds))


STATS_SEEDED_CASES = [  # n_slots, n, d, b, n_idx
    (20, 64, 4096, 16, 512),   # the main path's N and draws: staged, C = 256
    (8, 40, 4096, 5, 512),     # N not a power of two (a multiplier, %): C = 512
    (6, 48, 1030, 4, 77),      # D % 4 != 0: the global body, scalar reads
    (3, 2048, 256, 3, 100),    # N past the staged tile: global, float4 reads
    (6, 5, 36, 4, 13),         # T not a multiple of 8, a tile of 64 columns
    (4, 16, 8192, 3, 64),      # staged, C = 1024: float4 reads
    (4, 8, 8192, 3, 0),        # T = 0: zeros
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STATS_SEEDED_CASES)
def test_seeded_stats_kernel_equals_the_read_kernel(cuda, case):
    """The draw form equals the read form fed ``ops.randint``'s indices on
    ``arena[rows]``, bit for bit, counts one ``subsample_stats`` launch,
    repeats bit for bit, and is within the stated tolerance of its plain
    version."""
    n_slots, n, d, b, n_idx = case
    arena, rows, seeds = _stats_arena(n_slots, n, d, b, sum(case), cuda)
    idx = ops.randint(seeds, (n_idx,), 0, n)
    assert torch.equal(idx, prng.randint(prng.PRNGKey(seeds), (n_idx,), 0, n))
    before = ops.launch_count()
    got = ops.subsample_stats_seeded(arena, rows, seeds, n_idx=n_idx)
    torch.cuda.synchronize()
    assert ops.launch_count() == before + 1
    assert got.shape == (b, 2, d) and got.dtype == torch.float32
    assert torch.equal(got, ops.subsample_stats(
        arena[rows.long()].contiguous(), idx))
    assert torch.equal(got, ops.subsample_stats_seeded(arena, rows, seeds,
                                                       n_idx=n_idx))
    torch.testing.assert_close(
        got, ref.subsample_stats_seeded_ref(arena, rows, seeds, n_idx=n_idx),
        rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_step", [1, 3, 8, 16])
@pytest.mark.parametrize("d", [4096, 1030])
def test_seeded_stats_kernel_at_other_group_sizes(cuda, rows_per_step, d):
    """Groups of another size than the platform's 8 go row by row, and so
    does a full group of 8 left after the pairs (T = 77: four pairs, one
    group and a tail of 5), on the staged body (D = 4,096) and the global
    one (D = 1,030): the draw form still equals the read form bit for
    bit, and its plain version within the stated tolerance."""
    arena, rows, seeds = _stats_arena(6, 64, d, 4, rows_per_step, cuda)
    kw = dict(n_idx=77, rows_per_step=rows_per_step)
    idx = ops.randint(seeds, (77,), 0, 64)
    got = ops.subsample_stats_seeded(arena, rows, seeds, **kw)
    assert torch.equal(got, ops.subsample_stats(
        arena[rows.long()].contiguous(), idx, rows_per_step=rows_per_step))
    torch.testing.assert_close(
        got, ref.subsample_stats_seeded_ref(arena, rows, seeds, **kw),
        rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_seeded_stats_task_does_not_depend_on_the_wave_or_the_slot(cuda):
    arena, rows, seeds = _stats_arena(20, 64, 2048, 16, 4, cuda)
    wave = ops.subsample_stats_seeded(arena, rows, seeds, n_idx=512)
    shifted = torch.roll(arena, 5, dims=0).contiguous()   # block s at s + 5
    moved = ops.subsample_stats_seeded(shifted, (rows + 5) % 20, seeds,
                                       n_idx=512)
    assert torch.equal(wave, moved)
    for b in range(16):
        one = ops.subsample_stats_seeded(arena, rows[b:b + 1].contiguous(),
                                         seeds[b:b + 1].contiguous(),
                                         n_idx=512)
        assert torch.equal(wave[b], one[0]), b


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["columns", "rows", "alignment"])
def test_stats_global_body_equals_the_staged_body(cuda, split):
    """The same rows, added by a launch the shape sends to the global body
    and by one it sends to the staged body, give the same bits: D % 4 (1,030
    columns against the first 1,030 of 1,032), N (a block of 2,048 rows
    against its first 64, the indices below 64), and a data pointer 4
    bytes past a 16-byte boundary."""
    from repro_torch.kernels import subsample_gather as sg

    rng = np.random.default_rng(11)
    n, d = (2048, 512) if split == "rows" else (40, 1032)
    data = torch.from_numpy(rng.standard_normal((3, n, d)).astype(
        np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 64 if split == "rows" else n,
                                        (3, 300)).astype(np.int32)).to(cuda)
    if split == "columns":
        staged, other = data, data[:, :, :1030].contiguous()
    elif split == "rows":
        staged, other = data[:, :64].contiguous(), data
    else:
        staged = data
        buf = torch.empty(data.numel() + 1, device=cuda)
        other = buf[1:].view(data.shape)
        other.copy_(data)
    assert sg.tile_cols(staged, 300) > 0 and sg.tile_cols(other, 300) == 0
    want = ops.subsample_stats(staged, idx)
    got = ops.subsample_stats(other, idx)
    assert torch.equal(got, want[:, :, :got.shape[2]])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["cpu_seeds", "cpu_rows", "slot_past_the_end",
                                 "negative_slot"])
def test_seeded_stats_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    arena, rows, seeds = _stats_arena(6, 8, 64, 4, 0, cuda)
    if bad == "cpu_seeds":
        seeds = seeds.cpu()
    elif bad == "cpu_rows":
        rows = rows.cpu()
    elif bad == "slot_past_the_end":
        rows[1] = 6
    else:
        rows[3] = -1
    before = ops.launch_count()
    with pytest.raises(ValueError):
        ops.subsample_stats_seeded(arena, rows, seeds, n_idx=16)
    assert ops.launch_count() == before


@pytest.mark.cuda
def test_moments_wave_draws_in_the_kernel(cuda, monkeypatch):
    """On the card the ``kernel`` engine's wave is one launch: it never
    calls ``prng.randint``, the plain version or a slot gather."""
    from repro_torch.platform import compute as pc

    arena, _, _ = _stats_arena(6, 64, 1024, 1, 2, cuda)
    rows = np.asarray([5, 0, 5], np.int32)
    seeds = np.asarray([1, 2, 1], np.int32)
    want = pc._moments_wave(arena, rows, seeds, n_idx=512)

    def forbidden(*args, **kwargs):
        raise AssertionError("the wave left the kernel's path")

    monkeypatch.setattr(prng, "randint", forbidden)
    monkeypatch.setattr(ref, "subsample_stats_seeded_ref", forbidden)
    monkeypatch.setattr(torch.Tensor, "index_select", forbidden)
    before = ops.launch_count()
    got = pc._moments_wave(arena, rows, seeds, n_idx=512)
    assert ops.launch_count() == before + 1
    assert np.array_equal(got, want) and np.array_equal(got[0], got[2])


@pytest.mark.cuda
def test_platform_moments_job_launches_once_a_wave(cuda):
    """A waved ``moments`` job through ``Platform.run`` launches
    ``subsample_stats`` once a wave plus one warm-up a block shape, and no
    ``threefry_randint``; per task it gives the same result bit for bit."""
    from repro_torch.data import NetflixSpec, netflix_dataset
    from repro_torch.platform import (MOMENTS, Platform, PlatformSpec,
                                      WaveOptions)
    from repro_torch.platform.driver import plan_job

    samples, months = netflix_dataset(NetflixSpec(n_movies=96,
                                                  mean_ratings=300))
    knee = 8 * float(np.mean([a.nbytes for a in samples.values()]))

    def run(wave):
        spec = PlatformSpec(platform="BTS", n_workers=2, knee_bytes=knee,
                            waves=WaveOptions(wave=wave, max_wave=4))
        return Platform(spec).run(samples, months, MOMENTS)

    ops.reset_launch_count()
    rep = run("on")
    launches = ops.launch_count()
    plan = plan_job(samples, months, MOMENTS, sizing="kneepoint",
                    engine="kernel", n_exec=2, knee_bytes=knee)
    warm_ups = len({plan.task_shape(t) for t in plan.tasks})
    assert rep.engine == "kernel" and len(rep.wave_sizes) > 0
    assert launches == len(rep.wave_sizes) + warm_ups
    assert ops.launch_count("threefry_randint") == 0
    per = run("off")
    for key in rep.result:
        assert np.array_equal(np.asarray(rep.result[key]),
                              np.asarray(per.result[key])), key


# -- rwkv6_chunked -----------------------------------------------------------

# The kernel and its plain version (kernels.ref.rwkv6_chunk_form_ref) compute
# the same fp32 chunk form from the same inputs, with the same log-decay sums
# (a cumulative sum in row order, as torch.cumsum takes it on the card along
# a dimension that is not the last), but add the products in other orders:
# the kernel on the tensor cores, each fp32 operand split into two TF32
# parts (about 2^-21 of each product), A's off-diagonal blocks factored at
# sub-chunk boundaries.  Outputs of order 10 agree to a few ulps of the sums.
RW_TOL = 1e-4


def _rwkv_inputs(b, h, s, hd, dtype, logw_dtype, seed, device, span=2.45):
    """Decays logw in [-0.05 - span, -0.05]: span 2.45 is the realistic
    range, 39.95 reaches -40 a token (extreme decay)."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, hd)).astype(
        np.float32)).to(device, dtype) for _ in range(3))
    logw = torch.from_numpy((-0.05 - span * rng.random((b, h, s, hd))).astype(
        np.float32)).to(device, logw_dtype)
    u = torch.from_numpy((0.3 * rng.standard_normal((h, hd))).astype(
        np.float32)).to(device, dtype)
    state = torch.from_numpy((0.5 * rng.standard_normal((b, h, hd, hd))
                              ).astype(np.float32)).to(device)
    return r, k, v, logw, u, state


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,hd,chunk,dtype,logw_dtype", [
    (2, 4, 256, 64, 64, torch.bfloat16, torch.float32),   # the model's types
    (1, 3, 13, 64, 64, torch.bfloat16, torch.float32),    # one short chunk
    (2, 2, 96, 32, 32, torch.float32, torch.float32),     # hd = 32
    (1, 2, 40, 64, 8, torch.float32, torch.bfloat16),     # bf16 decays
    (3, 1, 21, 32, 7, torch.bfloat16, torch.bfloat16),    # odd chunk
    (2, 3, 256, 32, 32, torch.bfloat16, torch.float32),   # hd 32, 8 chunks
    (2, 4, 128, 64, 16, torch.bfloat16, torch.float32),   # chunk 16
    (1, 2, 80, 64, 40, torch.float32, torch.float32),     # ragged sub-chunk
])
def test_rwkv6_kernel_matches_plain_version(cuda, b, h, s, hd, chunk, dtype,
                                            logw_dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    r, k, v, logw, u, state = _rwkv_inputs(b, h, s, hd, dtype, logw_dtype,
                                           b * h + s, cuda)
    before = ops.launch_count("rwkv6_chunked")
    out, state_out = ops.rwkv6_chunked(r, k, v, logw, u, chunk=chunk,
                                       state=state)
    torch.cuda.synchronize()
    assert ops.launch_count("rwkv6_chunked") == before + 1
    want, want_state = ref.rwkv6_chunk_form_ref(r, k, v, logw, u, state,
                                                min(chunk, s))
    torch.testing.assert_close(out, want, rtol=RW_TOL, atol=RW_TOL)
    torch.testing.assert_close(state_out, want_state, rtol=RW_TOL,
                               atol=RW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.float32, 32)])
def test_rwkv6_kernel_matches_plain_version_at_extreme_decays(cuda, dtype,
                                                              hd):
    """logw down to -40 a token: the log-decay sums reach -2,560 in a
    chunk of 64, and most factors underflow to 0; nothing may overflow."""
    torch.backends.cuda.matmul.allow_tf32 = False
    r, k, v, logw, u, state = _rwkv_inputs(2, 3, 192, hd, dtype,
                                           torch.float32, 17, cuda,
                                           span=39.95)
    out, state_out = ops.rwkv6_chunked(r, k, v, logw, u, chunk=64,
                                       state=state)
    want, want_state = ref.rwkv6_chunk_form_ref(r, k, v, logw, u, state, 64)
    assert bool(torch.isfinite(out).all() and torch.isfinite(state_out).all())
    torch.testing.assert_close(out, want, rtol=RW_TOL, atol=RW_TOL)
    torch.testing.assert_close(state_out, want_state, rtol=RW_TOL,
                               atol=RW_TOL)


@pytest.mark.cuda
def test_rwkv6_kernel_is_bitwise_repeatable_and_its_passes_compose(cuda):
    """No atomics: two calls agree bit for bit, and the state pass then the
    output pass, launched apart, give what one call gives."""
    from repro_torch.kernels import rwkv6_scan

    r, k, v, logw, u, state = _rwkv_inputs(2, 4, 256, 64, torch.bfloat16,
                                           torch.float32, 5, cuda)
    first = ops.rwkv6_chunked(r, k, v, logw, u, chunk=64, state=state)
    second = ops.rwkv6_chunked(r, k, v, logw, u, chunk=64, state=state)
    out = torch.empty_like(first[0])
    state_out = torch.empty_like(first[1])
    states = rwkv6_scan.scratch_states(r, 64)
    rwkv6_scan.launch(r, k, v, logw, u, state, 64, out, state_out, states,
                      rwkv6_scan.STATE_PASS)
    rwkv6_scan.launch(r, k, v, logw, u, state, 64, out, state_out, states,
                      rwkv6_scan.OUT_PASS)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, (out, state_out)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_rwkv6_kernel_takes_inputs_that_are_not_16_byte_aligned(cuda):
    """A contiguous view 4 bytes into its storage: the wrapper hands the
    kernel an aligned copy."""
    r, k, v, logw, u, state = _rwkv_inputs(1, 2, 64, 32, torch.float32,
                                           torch.float32, 8, cuda)
    shifted = torch.empty(r.numel() + 1, device=cuda)[1:].view(r.shape)
    shifted.copy_(r)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    got = ops.rwkv6_chunked(shifted, k, v, logw, u, chunk=16, state=state)
    want = ops.rwkv6_chunked(r, k, v, logw, u, chunk=16, state=state)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd16", "chunk65", "ragged"])
def test_rwkv6_launch_raises_on_shapes_the_kernel_refuses(cuda, bad):
    """The launcher itself, past the op's checks, refuses and raises."""
    from repro_torch.kernels import rwkv6_scan

    hd = 16 if bad == "hd16" else 64
    r, k, v, logw, u, state = _rwkv_inputs(1, 2, 130, hd, torch.float32,
                                           torch.float32, 0, cuda)
    chunk = {"hd16": 13, "chunk65": 65, "ragged": 64}[bad]   # S = 130
    with pytest.raises(RuntimeError):
        rwkv6_scan.rwkv6_chunked(r, k, v, logw, u, state, chunk)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_rwkv6_kernel_from_zero_state_matches_sequential_recurrence(cuda):
    r, k, v, logw, u, _ = _rwkv_inputs(1, 2, 64, 64, torch.float32,
                                       torch.float32, 9, cuda)
    out, _ = ops.rwkv6_chunked(r, k, v, logw, u, chunk=16)
    # chunked closed form vs sequential scan: the reference's 2e-3
    torch.testing.assert_close(out, ref.rwkv6_chunked_ref(r, k, v, logw, u),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd16", "chunk128", "strided"])
def test_rwkv6_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    hd = 16 if bad == "hd16" else 64
    r, k, v, logw, u, _ = _rwkv_inputs(1, 2, 128, hd, torch.float32,
                                       torch.float32, 0, cuda)
    chunk = 128 if bad == "chunk128" else 64
    if bad == "strided":                   # same shape, not contiguous
        r = torch.cat([r, r], dim=-1)[..., :hd]
    before = ops.launch_count("rwkv6_chunked")
    with pytest.raises(ValueError):
        ops.rwkv6_chunked(r, k, v, logw, u, chunk=chunk)
    assert ops.launch_count("rwkv6_chunked") == before


# -- rglru_scan --------------------------------------------------------------


def _scan_inputs(b, s, w, seed, device):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.99, (b, s, w)).astype(np.float32)
    bb = (0.5 * rng.standard_normal((b, s, w))).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (a, bb, h0))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", [(4, 512, 2560), (2, 13, 100), (1, 1, 7),
                                   (3, 67, 64), (2, 130, 2563), (1, 64, 20)])
def test_rglru_kernel_equals_plain_version(cuda, b, s, w):
    """Both round a·h, then add b, step by step: equal bit for bit."""
    a, bb, h0 = _scan_inputs(b, s, w, b + s + w, cuda)
    before = ops.launch_count("rglru_scan")
    out = ops.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert ops.launch_count("rglru_scan") == before + 1
    assert torch.equal(out, ref.linear_scan_ref(a, bb, h0))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["bf16", "strided"])
def test_rglru_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    a, bb, h0 = _scan_inputs(2, 16, 32, 0, cuda)
    if bad == "bf16":
        a = a.to(torch.bfloat16)
    else:
        a = torch.cat([a, a], dim=-1)[..., :32]
    before = ops.launch_count("rglru_scan")
    with pytest.raises((ValueError, TypeError)):
        ops.rglru_scan(a, bb, h0)
    assert ops.launch_count("rglru_scan") == before


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["a", "b"])
def test_rglru_kernel_takes_views_that_are_not_16_byte_aligned(cuda, which):
    """A contiguous view 4 bytes into its storage: the read form copies its
    rows 4 bytes at a time and still equals the plain version."""
    a, bb, h0 = _scan_inputs(2, 70, 96, 11, cuda)
    x = a if which == "a" else bb
    shifted = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    args = (shifted, bb) if which == "a" else (a, shifted)
    out = ops.rglru_scan(*args, h0)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.linear_scan_ref(a, bb, h0))


def _gated_inputs(b, s, w, u_dtype, gate_dtype, seed, device,
                  lam_mean=1.0):
    """u and the gate vectors away from their one/zero inits; Λ near
    ``lam_mean`` (far below 0, softplus(Λ) is tiny, a rounds to 1 and the
    clamp of 1 − a² binds)."""
    rng = np.random.default_rng(seed)
    u = 2.0 * rng.standard_normal((b, s, w))
    gates = [1.0 + 0.3 * rng.standard_normal(w),
             0.2 * rng.standard_normal(w),
             1.0 + 0.3 * rng.standard_normal(w),
             0.2 * rng.standard_normal(w)]
    lam = lam_mean + 0.3 * rng.standard_normal(w)
    h0 = rng.standard_normal((b, w))
    as_t = lambda x, dt: torch.from_numpy(x.astype(np.float32)).to(device, dt)
    sp = torch.nn.functional.softplus(as_t(lam, torch.float32))
    return (as_t(u, u_dtype), *(as_t(g, gate_dtype) for g in gates), sp,
            as_t(h0, torch.float32))


def _torch_gates_then_scan(u, wa, ba, wx, bx, sp, h0):
    return ops.rglru_scan(*ref.rglru_gates(u, wa, ba, wx, bx, sp), h0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w,u_dtype,gate_dtype,lam_mean", [
    (4, 512, 2560, torch.bfloat16, torch.bfloat16, 1.0),  # the model's
    (2, 13, 100, torch.float32, torch.float32, 1.0),
    (1, 1, 7, torch.bfloat16, torch.float32, 1.0),
    (3, 70, 2563, torch.float32, torch.bfloat16, 1.0),
    (2, 200, 48, torch.bfloat16, torch.bfloat16, -20.0),  # clamp binds
])
def test_rglru_gated_kernel_equals_torch_gates_and_read_form(
        cuda, b, s, w, u_dtype, gate_dtype, lam_mean):
    """The kernel takes the gates' torch ops one by one in their order and
    rounding: equal bit for bit to those ops on the card followed by the
    read form and to its plain version (the same ops followed by the
    sequential scan), and one launch counted as ``rglru_scan``."""
    args = _gated_inputs(b, s, w, u_dtype, gate_dtype, b + s + w, cuda,
                         lam_mean)
    want = _torch_gates_then_scan(*args)
    before = ops.launch_count("rglru_scan")
    got = ops.rglru_gated_scan(*args)
    torch.cuda.synchronize()
    assert ops.launch_count("rglru_scan") == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, s, w)
    assert torch.equal(got, want)
    assert torch.equal(got, ref.rglru_gated_scan_ref(*args))
    assert torch.equal(got, ops.rglru_gated_scan(*args))


@pytest.mark.cuda
def test_rglru_gated_kernel_keeps_a_nan_as_the_torch_ops_do(cuda):
    """A NaN in u runs through the clamp (torch.clamp keeps a NaN) into its
    channel's states from that step on, and nowhere else."""
    args = list(_gated_inputs(2, 40, 32, torch.float32, torch.float32, 3,
                              cuda))
    args[0][1, 7, 5] = float("nan")
    got = ops.rglru_gated_scan(*args)
    want = _torch_gates_then_scan(*args)
    torch.cuda.synchronize()
    assert got[1, 7:, 5].isnan().all() and got.isnan().sum() == 33
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["gate_dtypes", "u_int", "strided", "cpu_h0",
                                 "sp_bf16"])
def test_rglru_gated_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    args = list(_gated_inputs(2, 16, 32, torch.bfloat16, torch.bfloat16, 0,
                              cuda))
    if bad == "gate_dtypes":
        args[2] = args[2].float()
    elif bad == "u_int":
        args[0] = args[0].to(torch.int32)
    elif bad == "strided":
        args[0] = torch.cat([args[0], args[0]], dim=-1)[..., :32]
    elif bad == "cpu_h0":
        args[6] = args[6].cpu()
    else:
        args[5] = args[5].to(torch.bfloat16)
    before = ops.launch_count("rglru_scan")
    with pytest.raises((ValueError, TypeError)):
        ops.rglru_gated_scan(*args)
    assert ops.launch_count("rglru_scan") == before


# -- flash_attention ---------------------------------------------------------

# fp32 runs on the CUDA cores: the same fp32 scores and softmax as the plain
# version, products and the online softmax's rescaled partial sums added in
# other orders, so outputs of order 1 agree to ~1e-5.  bf16 runs on the
# tensor cores: products of bf16 values are exact in fp32, so the scores
# differ from the plain version's only in the order of summation, and P
# enters P V as a bf16 high and low part, which keeps each weight to about
# 2^-17; the fp32 output agrees to ~1e-5 again, and the bf16 output is one
# rounding of it, so the two may differ by one bf16 ulp (2^-8 relative).
FA_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _attn_inputs(bh, sq, skv, hd, group, dtype, seed, device):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bh // group, skv, hd)).astype(np.float32)
            for _ in range(2))
    return tuple(torch.from_numpy(x).to(device, dtype) for x in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,hd,causal,window,group,dtype", [
    (20, 300, 300, 256, True, 128, 10, torch.bfloat16),  # the model's form
    (4, 256, 256, 64, True, 0, 1, torch.float32),        # the TPU function
    (4, 256, 256, 64, False, 0, 1, torch.bfloat16),      # not causal
    (6, 100, 100, 32, True, 16, 3, torch.float32),       # HD 32, ragged
    (2, 70, 150, 128, True, 0, 2, torch.float32),        # Sq < Skv
    (3, 1, 1, 256, True, 0, 1, torch.float32),           # one token
    # bf16, the tensor-core body: every HD, ragged lengths, both windows
    (4, 577, 1000, 32, False, 0, 2, torch.bfloat16),     # HD 32, Sq < Skv
    (4, 1000, 577, 64, True, 16, 1, torch.bfloat16),     # window < a tile
    (20, 1000, 1000, 128, True, 300, 10, torch.bfloat16),  # window > a tile
    (10, 577, 577, 256, False, 0, 10, torch.bfloat16),   # group 10, not causal
    (2, 70, 150, 256, True, 0, 2, torch.bfloat16),       # Sq < Skv, causal
    (4, 1000, 577, 64, True, 300, 1, torch.bfloat16),    # rows that see no key
    (3, 1, 1, 256, True, 0, 1, torch.bfloat16),          # one token
    (3, 1, 1000, 128, False, 0, 1, torch.bfloat16),      # Sq = 1, many keys
    # the dense decoders' form: HD 128, window 0, causal, ragged last tiles
    (4, 4064, 4064, 128, True, 0, 1, torch.bfloat16),    # deepseek-7b's S
    (6, 1000, 1000, 128, True, 0, 1, torch.bfloat16),    # ragged, MHA
    (12, 700, 700, 128, True, 0, 6, torch.bfloat16),     # group 6 (internlm2)
    (16, 577, 577, 128, True, 0, 8, torch.bfloat16),     # group 8 (qwen2)
    (6, 1000, 1000, 64, True, 0, 1, torch.bfloat16),     # HD 64 (musicgen)
])
def test_flash_kernel_matches_plain_version(cuda, bh, sq, skv, hd, causal,
                                            window, group, dtype):
    q, k, v = _attn_inputs(bh, sq, skv, hd, group, dtype, bh + sq + hd, cuda)
    before = ops.launch_count("flash_attention")
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              group=group)
    torch.cuda.synchronize()
    assert ops.launch_count("flash_attention") == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   group=group)
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_kernel_bf16_with_large_score_gaps(cuda, hd):
    """q and k scaled by 8: scores spread over hundreds, so the running max
    moves by large steps from tile to tile and the online rescale runs on
    weights that underflow to 0 in between."""
    q, k, v = _attn_inputs(8, 700, 700, hd, 2, torch.float32, hd, cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q * 8, k * 8, v))
    out = ops.flash_attention(q, k, v, causal=True, window=0, group=2)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=0, group=2)
    assert torch.isfinite(out.float()).all()
    rtol, atol = FA_TOL[torch.bfloat16]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_is_padded_latent_attention(cuda, dtype):
    """DeepSeek-V2's prefill form: q and k of 192 and v of 128 zero-padded
    to HD 256, q carrying the model's softmax scale times sqrt(256) (as
    ``mla.mla_apply`` lays it out).  The output equals the plain version,
    and the padded columns are zeros."""
    from repro_torch.models import mla
    fold = (mla.softmax_scale(get_config("deepseek-v2-lite"))
            * math.sqrt(mla.KERNEL_HD))
    q, k, v = _attn_inputs(8, 1000, 1000, 256, 1, torch.float32, 41, cuda)
    q[..., 192:] = 0
    k[..., 192:] = 0
    v[..., 128:] = 0
    q, k, v = (x.to(dtype) for x in (q * fold, k, v))
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
    assert not out[..., 128:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_repeats_bit_for_bit(cuda, dtype):
    """No atomics, one CTA an output tile: two launches on the same inputs
    are equal."""
    q, k, v = _attn_inputs(20, 1000, 1000, 256, 10, dtype, 7, cuda)
    first = ops.flash_attention(q, k, v, causal=True, window=300, group=10)
    second = ops.flash_attention(q, k, v, causal=True, window=300, group=10)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_kernel_takes_bf16_views_that_are_not_16_byte_aligned(cuda,
                                                                    which):
    """A contiguous bf16 view one element (2 bytes) into its storage: the
    wrapper hands the kernel's TMA an aligned copy, as the reference's
    kernel takes any input."""
    q, k, v = _attn_inputs(20, 300, 300, 256, 10, torch.bfloat16, 9, cuda)
    x = {"q": q, "k": k, "v": v}[which]
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    args = {"q": (shifted, k, v), "k": (q, shifted, v),
            "v": (q, k, shifted)}[which]
    out = ops.flash_attention(*args, causal=True, window=128, group=10)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=128,
                                   group=10)
    rtol, atol = FA_TOL[torch.bfloat16]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd48", "strided", "group"])
def test_flash_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    hd = 48 if bad == "hd48" else 64
    q, k, v = _attn_inputs(4, 32, 32, hd, 1, torch.float32, 0, cuda)
    kwargs = {}
    if bad == "strided":
        q = torch.cat([q, q], dim=-1)[..., :hd]
    elif bad == "group":
        kwargs["group"] = 3
    before = ops.launch_count("flash_attention")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kwargs)
    assert ops.launch_count("flash_attention") == before


@pytest.mark.cuda
def test_dense_attention_prefill_hands_the_kernel_aligned_tensors(
        cuda, monkeypatch):
    """The dense prefill's q, k and v are permuted copies, contiguous and
    on 16 bytes, so the wrapper's alignment copy does not run."""
    cfg = dataclasses.replace(get_config("deepseek-7b"), num_layers=2,
                              d_model=256, num_heads=2, num_kv_heads=2,
                              d_ff=512, vocab_size=512)
    model = Model(cfg, device=cuda)
    params = model.init(model.generator(0))
    seen = []
    real = fa.aligned

    def spy(t):
        out = real(t)
        seen.append(out is t)
        return out

    monkeypatch.setattr(fa, "aligned", spy)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), device=cuda)
    before = ops.launch_count("flash_attention")
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ops.launch_count("flash_attention") == before + 2
    assert seen == [True] * 6
    assert torch.isfinite(logits).all()
    assert caches["blocks"][0]["k"].dtype == torch.int8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_quantize_on_the_card_equals_the_cpu(cuda, dtype):
    """``quantize_kv`` and ``dequantize_kv`` are torch ops: on the card
    they give the CPU's int8 values and scales bit for bit (an absmax, one
    correctly rounded division, round half to even)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 257, 8, 128))
         * rng.choice([1e-3, 1.0, 30.0], (4, 257, 8, 1)))
    x[..., 0], x[..., 1], x[0, 0, 0] = 127.0, 0.5, 0.0
    host = torch.from_numpy(x.astype(np.float32)).to(dtype)
    want_q, want_s = L.quantize_kv(host)
    got_q, got_s = L.quantize_kv(host.to(cuda))
    assert torch.equal(got_q.cpu(), want_q)
    assert torch.equal(got_s.cpu(), want_s)
    assert torch.equal(L.dequantize_kv(got_q, got_s, dtype).cpu(),
                       L.dequantize_kv(want_q, want_s, dtype))


# -- attention_decode_int8 ----------------------------------------------------

def _decode_int8_inputs(b, s_max, kv, g, hd, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, kv, g, hd), generator=gen).to(device, dtype)
    k = (2.0 * torch.randn((b, 1, kv, hd), generator=gen)).to(device, dtype)
    v = (2.0 * torch.randn((b, 1, kv, hd), generator=gen)).to(device, dtype)
    cache = {}
    for n in ("k", "v"):
        rows = (torch.randn((b, s_max, kv, hd), generator=gen)
                * torch.exp(torch.randn((b, s_max, kv, 1), generator=gen)))
        cache[n], cache[n + "_scale"] = L.quantize_kv(rows.to(device, dtype))
    return q, k, v, cache


@pytest.mark.cuda
@pytest.mark.parametrize("b,s_max,kv,g,hd,pos,window,dtype", [
    (2, 300, 4, 1, 128, 299, 0, torch.bfloat16),   # the last slot
    (2, 300, 4, 1, 128, 0, 0, torch.bfloat16),     # the first write
    (3, 16, 2, 4, 128, 37, 16, torch.bfloat16),    # a wrapped window
    (3, 16, 2, 4, 128, 5, 16, torch.bfloat16),     # a window filling
    (2, 40, 2, 6, 128, 20, 0, torch.bfloat16),     # G 6
    (1, 600, 1, 10, 128, 555, 0, torch.bfloat16),  # G 10: two CTAs a head
    (2, 1000, 2, 2, 128, 700, 0, torch.bfloat16),
    (1, 5000, 1, 1, 128, 4999, 0, torch.bfloat16),  # many splits
])
def test_attention_decode_int8_kernel_equals_plain_version(
        cuda, b, s_max, kv, g, hd, pos, window, dtype):
    """The returned cache bit for bit (the same quantize arithmetic), the
    old cache untouched, each output within its budget (tests/_decode_tol.py),
    and a second launch equal to the first bit for bit (the splits combine
    in a fixed order)."""
    q, k, v, cache = _decode_int8_inputs(b, s_max, kv, g, hd, dtype,
                                         s_max + pos, cuda)
    kept = {n: t.clone() for n, t in cache.items()}
    before = ops.launch_count("attention_decode_int8")
    got, got_cache = ops.attention_decode_int8(q, k, v, cache, pos,
                                               window=window)
    again, _ = ops.attention_decode_int8(q, k, v, cache, pos, window=window)
    torch.cuda.synchronize()
    assert ops.launch_count("attention_decode_int8") == before + 2
    want, want_cache = ref.attention_decode_int8_ref(q, k, v, cache, pos,
                                                     window=window)
    for n in cache:
        assert torch.equal(got_cache[n], want_cache[n]), n
        assert torch.equal(cache[n], kept[n]), n
    assert got.dtype == dtype and torch.equal(got, again)
    bound = _decode_tol.budget(q, want_cache, pos, window, want)
    assert _decode_tol.share(got, want, bound) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype,error", [
    (64, torch.bfloat16, ValueError), (256, torch.bfloat16, ValueError),
    (128, torch.float32, TypeError)])
def test_attention_decode_int8_refuses_what_the_kernel_is_not_built_for(
        cuda, hd, dtype, error):
    """The kernel is built for HD 128 in bf16: the wrapper refuses the
    rest on the card, where the CPU runs the plain version for any."""
    q, k, v, cache = _decode_int8_inputs(2, 64, 2, 1, hd, dtype, 3, cuda)
    with pytest.raises(error):
        ops.attention_decode_int8(q, k, v, cache, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [32, 64, 256])
def test_attention_decode_int8_any_split_agrees(cuda, chunk):
    """Forced splits of 32, 64 and 256 slots a CTA write the same cache and
    agree with the plain version."""
    from repro_torch.kernels import attention_decode_int8 as ad

    q, k, v, cache = _decode_int8_inputs(2, 700, 4, 2, 128, torch.bfloat16,
                                         chunk, cuda)
    want, want_cache = ref.attention_decode_int8_ref(q, k, v, cache, 650)
    work = {n: t.clone() for n, t in cache.items()}
    got = ad.attention_decode_int8(q, k, v, work["k"], work["v"],
                                   work["k_scale"], work["v_scale"],
                                   write_at=650, n_valid=651, chunk=chunk)
    torch.cuda.synchronize()
    for n in cache:
        assert torch.equal(work[n], want_cache[n]), n
    bound = _decode_tol.budget(q, want_cache, 650, 0, want)
    assert _decode_tol.share(got, want, bound) <= 1


# -- subsample_gather --------------------------------------------------------


def _gather_inputs(n, d, t, dtype, seed, device):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, t).astype(np.int32)
    return (torch.from_numpy(data).to(device, dtype),
            torch.from_numpy(idx).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 1030, 65536])
@pytest.mark.parametrize("t", [1, 13, 512])
def test_gather_kernel_equals_plain_version(cuda, dtype, d, t):
    """Both add row after row into fp32, the square rounded first: equal
    bit for bit, with n_valid below, at and above T."""
    x, i = _gather_inputs(64, d, t, dtype, d + t, cuda)
    for n_valid in (t // 2, t, t + 5):
        nv = torch.full((1,), n_valid, dtype=torch.int32, device=cuda)
        before = ops.launch_count("subsample_gather")
        gathered, stats = ops._subsample_gather_padded(x, i, nv)
        torch.cuda.synchronize()
        assert ops.launch_count("subsample_gather") == before + 1
        want_g, want_s = ref.subsample_gather_ref(x, i, nv)
        assert gathered.dtype == dtype and stats.dtype == torch.float32
        assert torch.equal(gathered, x[i.long()])
        assert torch.equal(gathered, want_g)
        assert torch.equal(stats, want_s)


@pytest.mark.cuda
def test_gather_op_counts_one_launch_a_call(cuda):
    x, i = _gather_inputs(64, 4096, 512, torch.float32, 0, cuda)
    before = ops.launch_count("subsample_gather")
    for k in range(3):
        ops.subsample_gather(x, i)
        assert ops.launch_count("subsample_gather") == before + k + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["strided", "int64", "cpu_n_valid", "fp16"])
def test_gather_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    x, i = _gather_inputs(16, 64, 8, torch.float32, 0, cuda)
    nv = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    if bad == "strided":
        x = torch.cat([x, x], dim=-1)[:, :64]
    elif bad == "int64":
        i = i.long()
    elif bad == "cpu_n_valid":
        nv = nv.cpu()
    else:
        x = x.half()
    before = ops.launch_count("subsample_gather")
    with pytest.raises((ValueError, TypeError)):
        ops._subsample_gather_padded(x, i, nv)
    assert ops.launch_count("subsample_gather") == before


# -- subsample_grid ------------------------------------------------------------

# The kernel and its plain version (kernels.ref.grid_partial) gather the same
# elements and bin them into the same cells, so the counts are equal; the
# sums are fp32 sums of the same terms (for alod, scores from a mean and a
# std also summed) in another order: relative 2e-5, with an absolute floor
# of 1e-5 of the largest sum for bins that nearly cancel.
GRID_RTOL, GRID_ATOL_SCALE = 2e-5, 1e-5
GRID_SOURCE = (Path(ops.__file__).resolve().parent / "csrc"
               / "subsample_grid.cu")
THREEFRY_SOURCE = GRID_SOURCE.with_name("threefry.cuh")


def _grid_inputs(n_slots, ns, sl, b, draws, ds, grid, seed, device):
    """An arena of ``n_slots`` blocks, months reaching past ``[0, grid)``
    on both sides, a wave of ``b`` slots and its indices."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n_slots, ns, sl)).astype(np.float32)
    months = rng.integers(-3, grid + 4, (n_slots, ns, sl)).astype(np.int32)
    rows = rng.integers(0, n_slots, b).astype(np.int32)
    idx = rng.integers(0, sl, (b, draws, ns, ds)).astype(np.int32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (data, months, rows, idx))


def _assert_grid_close(got, want):
    assert torch.equal(got[:, 1], want[:, 1])             # counts: exact
    atol = GRID_ATOL_SCALE * float(want[:, 0].abs().max())
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=GRID_RTOL,
                               atol=atol)


GRID_CASES = [  # n_slots, ns, sl, b, draws, ds, grid
    (4, 64, 4096, 3, 30, 256, 64),      # EAGLET's draws on 64 families
    (4, 64, 4096, 3, 8, 2048, 120),     # NETFLIX_HIGH's
    (20, 64, 4096, 16, 8, 32, 120),     # NETFLIX_LOW's, a wave of 16
    (3, 1, 512, 2, 5, 40, 64),          # ns = 1
    (3, 5, 300, 4, 9, 77, 120),         # ds not a multiple of 32, sl not 2^k
    (2, 3, 64, 2, 3, 1, 8),             # ds = 1
]


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
@pytest.mark.parametrize("case", GRID_CASES)
def test_grid_kernel_matches_plain_version(cuda, statistic, case):
    n_slots, ns, sl, b, draws, ds, grid = case
    data, months, rows, idx = _grid_inputs(*case, sum(case), cuda)
    before = ops.launch_count("subsample_grid")
    got = ops.subsample_grid(data, months, rows, idx, grid=grid,
                             statistic=statistic)
    torch.cuda.synchronize()
    assert ops.launch_count("subsample_grid") == before + 1
    want = ref.subsample_grid_ref(data, months, rows, idx, grid=grid,
                                  statistic=statistic)
    assert got.shape == (b, 2, grid) and got.dtype == torch.float32
    _assert_grid_close(got, want)
    again = ops.subsample_grid(data, months, rows, idx, grid=grid,
                               statistic=statistic)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
def test_grid_kernel_task_does_not_depend_on_the_wave(cuda, statistic):
    """Task b's partial in a wave of 16 equals the same task alone (slot
    and indices), launched as a wave of one: bit for bit."""
    data, months, rows, idx = _grid_inputs(20, 8, 1024, 16, 8, 100, 120, 5,
                                           cuda)
    wave = ops.subsample_grid(data, months, rows, idx, grid=120,
                              statistic=statistic)
    for b in range(16):
        one = ops.subsample_grid(data, months, rows[b:b + 1].contiguous(),
                                 idx[b:b + 1].contiguous(), grid=120,
                                 statistic=statistic)
        assert torch.equal(wave[b], one[0]), b


@pytest.mark.cuda
def test_grid_kernel_reads_the_slot_not_a_copy(cuda):
    """A wave over slots equals the same wave over an arena holding only
    those slots' blocks in wave order."""
    data, months, rows, idx = _grid_inputs(6, 4, 256, 5, 4, 64, 64, 8, cuda)
    packed = data[rows.long()].contiguous()
    packed_mo = months[rows.long()].contiguous()
    order = torch.arange(5, dtype=torch.int32, device=cuda)
    for statistic in ("alod", "monthly_mean"):
        assert torch.equal(
            ops.subsample_grid(data, months, rows, idx, grid=64,
                               statistic=statistic),
            ops.subsample_grid(packed, packed_mo, order, idx, grid=64,
                               statistic=statistic))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["cpu_rows", "int64_idx", "strided"])
def test_grid_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    data, months, rows, idx = _grid_inputs(2, 3, 64, 2, 3, 8, 16, 0, cuda)
    if bad == "cpu_rows":
        rows = rows.cpu()
    elif bad == "int64_idx":
        idx = idx.long()
    else:
        data = torch.cat([data, data], dim=-1)[:, :, :64]
    before = ops.launch_count("subsample_grid")
    with pytest.raises((ValueError, TypeError)):
        ops.subsample_grid(data, months, rows, idx, grid=16,
                           statistic="monthly_mean")
    assert ops.launch_count("subsample_grid") == before


@pytest.mark.cuda
@pytest.mark.parametrize("name,wave", [("eaglet", "on"), ("eaglet", "off"),
                                       ("netflix_low", "auto")])
def test_platform_runs_the_paper_workloads_on_the_kernel(cuda, monkeypatch,
                                                         name, wave):
    """``Platform.run`` with ``engine="auto"`` on the card launches
    ``subsample_grid`` (one launch a wave or a task, plus one a warm-up)
    and never its plain version."""
    from repro_torch.core import subsample as ss
    from repro_torch.data import (EagletSpec, NetflixSpec, eaglet_dataset,
                                  netflix_dataset)
    from repro_torch.platform import Platform, PlatformSpec, WaveOptions
    from repro_torch.platform.driver import plan_job

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card's path")

    monkeypatch.setattr(ref, "subsample_grid_ref", plain)
    samples, months = (
        eaglet_dataset(EagletSpec(n_families=24, mean_markers=512))
        if name == "eaglet"
        else netflix_dataset(NetflixSpec(n_movies=64, mean_ratings=400)))
    mean = float(np.mean([a.nbytes for a in samples.values()]))
    spec = PlatformSpec(platform="BTS", n_workers=2, knee_bytes=8 * mean,
                        waves=WaveOptions(wave=wave, max_wave=4))
    before = ops.launch_count("subsample_grid")
    rep = Platform(spec).run(samples, months, ss.WORKLOADS[name])
    launches = ops.launch_count("subsample_grid") - before
    plan = plan_job(samples, months, ss.WORKLOADS[name], sizing="kneepoint",
                    engine="torch", n_exec=2, knee_bytes=spec.knee_bytes)
    warm_ups = len({plan.task_shape(t) for t in plan.tasks})
    assert rep.engine == "torch"
    assert launches == rep.device_dispatches + warm_ups
    assert rep.device_dispatches == (len(rep.wave_sizes) if wave != "off"
                                     else rep.n_tasks)
    assert (len(rep.wave_sizes) > 0) == (wave != "off")
    result = next(iter(rep.result.values()))
    assert np.all(np.isfinite(np.asarray(result)))


def test_grid_kernel_adds_no_float_with_an_atomic():
    """The kernel's sums keep one fixed order: its source and the threefry
    header it includes call no atomic at all (comments aside)."""
    code = re.sub(r"//[^\n]*", "", GRID_SOURCE.read_text())
    assert "__global__" in code and '#include "threefry.cuh"' in code
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", code)
    header = re.sub(r"//[^\n]*", "", THREEFRY_SOURCE.read_text())
    assert "threefry2x32" in header and "__global__" not in header
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", header)


# -- subsample_grid's draw form: jax's threefry in the kernel ------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,hi", [
    ((30, 64, 256), 2 ** 21), ((8, 64, 2048), 2 ** 15), ((8, 64, 32), 2 ** 14),
    ((8, 4, 300), 77), ((8, 4, 300), 1000), ((8, 4, 300), 65537),
    ((8, 4, 300), 3), ((257,), 2 ** 31 - 1)])
def test_randint_kernel_equals_prng(cuda, shape, hi):
    seeds = torch.tensor([-1, -2 ** 31, 2 ** 31 - 1] + list(range(16)),
                         dtype=torch.int32, device=cuda)
    before = ops.launch_count("threefry_randint")
    got = ops.randint(seeds, shape, 0, hi)
    assert ops.launch_count("threefry_randint") == before + 1
    want = prng.randint(prng.PRNGKey(seeds), shape, 0, hi)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_randint_kernel_with_a_negative_lo(cuda):
    seeds = torch.arange(-4, 4, dtype=torch.int32, device=cuda)
    for lo, hi in ((-5, 37), (2 ** 31 - 8, 2 ** 31 - 1), (10, 10)):
        assert torch.equal(ops.randint(seeds, (513,), lo, hi),
                           prng.randint(prng.PRNGKey(seeds), (513,), lo, hi))


SEEDED_CASES = GRID_CASES + [
    (2, 8, 2048, 3, 8, 2048, 64),       # alod draws each index again
]


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
@pytest.mark.parametrize("case", SEEDED_CASES)
def test_seeded_grid_kernel_equals_the_read_kernel(cuda, statistic, case):
    """The draw form equals the read form fed ``prng.randint``'s indices,
    bit for bit, counts one ``subsample_grid`` launch, and is within the
    stated tolerance of its plain version."""
    n_slots, ns, sl, b, draws, ds, grid = case
    data, months, rows, _ = _grid_inputs(*case, sum(case), cuda)
    seeds = torch.arange(-b, b, 2, dtype=torch.int32, device=cuda)
    kw = dict(grid=grid, statistic=statistic)
    idx = prng.randint(prng.PRNGKey(seeds), (draws, ns, ds), 0, sl)
    before = ops.launch_count("subsample_grid")
    got = ops.subsample_grid_seeded(data, months, rows, seeds, draws=draws,
                                    draw_size=ds, **kw)
    torch.cuda.synchronize()
    assert ops.launch_count("subsample_grid") == before + 1
    assert torch.equal(got, ops.subsample_grid(data, months, rows, idx, **kw))
    _assert_grid_close(got, ref.subsample_grid_seeded_ref(
        data, months, rows, seeds, draws=draws, draw_size=ds, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
def test_seeded_grid_task_does_not_depend_on_the_wave(cuda, statistic):
    data, months, rows, _ = _grid_inputs(20, 8, 1024, 16, 8, 100, 120, 5,
                                         cuda)
    seeds = torch.arange(16, dtype=torch.int32, device=cuda) * 7919 - 50000
    kw = dict(draws=8, draw_size=100, grid=120, statistic=statistic)
    wave = ops.subsample_grid_seeded(data, months, rows, seeds, **kw)
    assert torch.equal(wave, ops.subsample_grid_seeded(data, months, rows,
                                                       seeds, **kw))
    for b in range(16):
        one = ops.subsample_grid_seeded(data, months,
                                        rows[b:b + 1].contiguous(),
                                        seeds[b:b + 1].contiguous(), **kw)
        assert torch.equal(wave[b], one[0]), b


@pytest.mark.cuda
def test_map_wave_draws_in_the_kernel(cuda, monkeypatch):
    """On CUDA tensors the torch engine's wave never calls
    ``prng.randint``: the kernel draws the indices."""
    from repro_torch.core import subsample as ss

    data, months, _, _ = _grid_inputs(4, 8, 512, 1, 1, 1, 120, 3, cuda)
    want = ss.map_wave(data, months, [3, 1], [7, -7], ss.NETFLIX_LOW)

    def no_randint(*args, **kwargs):
        raise AssertionError("prng.randint ran on the card's path")

    monkeypatch.setattr(prng, "randint", no_randint)
    before = ops.launch_count("subsample_grid")
    got = ss.map_wave(data, months, [3, 1], [7, -7], ss.NETFLIX_LOW)
    assert ops.launch_count("subsample_grid") == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["cpu_seeds", "int64_seeds", "sl_zero"])
def test_seeded_grid_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    data, months, rows, _ = _grid_inputs(2, 3, 64, 2, 3, 8, 16, 0, cuda)
    seeds = torch.zeros(2, dtype=torch.int32, device=cuda)
    if bad == "cpu_seeds":
        seeds = seeds.cpu()
    elif bad == "int64_seeds":
        seeds = seeds.long()
    else:
        data, months = (t[:, :, :0].contiguous() for t in (data, months))
    before = ops.launch_count("subsample_grid")
    with pytest.raises((ValueError, TypeError)):
        ops.subsample_grid_seeded(data, months, rows, seeds, draws=3,
                                  draw_size=8, grid=16,
                                  statistic="monthly_mean")
    assert ops.launch_count("subsample_grid") == before


# -- subsample_grid's two bodies, its split and its order -----------------------


def test_grid_kernel_bins_without_match_any():
    """The kernel bins into per-lane copies in a fixed order: no
    ``__match_any_sync`` and no serial leader (comments aside)."""
    code = re.sub(r"//[^\n]*", "", GRID_SOURCE.read_text())
    assert "bin_batch" in code and "__syncwarp" in code
    assert "__match_any_sync" not in code and "__ffs" not in code


# data shape, workload: the staged body where the plan takes it (a row with
# as many draws as elements) and forced where it is not; ``alod`` is never
# staged, so a staged body forced on it raises
BODY_CASES = [((3, 8, 4096), 8, 2048, 120), ((3, 8, 16384), 8, 2048, 120),
              ((2, 4, 32768), 8, 2048, 120), ((3, 8, 4096), 30, 256, 64),
              ((3, 5, 300), 9, 77, 120), ((2, 3, 1000), 8, 300, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
@pytest.mark.parametrize("case", BODY_CASES)
def test_grid_staged_body_equals_direct_body(cuda, statistic, case):
    """Forced on the same input, the two bodies add the same values in the
    same order: bit for bit, in both index forms."""
    shape, draws, ds, grid = case
    data, months, rows, _ = _grid_inputs(*shape, 3, draws, ds, grid,
                                         sum(shape), cuda)
    seeds = torch.tensor([5, -9, 77], dtype=torch.int32, device=cuda)
    idx = prng.randint(prng.PRNGKey(seeds), (draws, shape[1], ds), 0,
                       shape[2])
    kw = dict(grid=grid, statistic=statistic)
    if statistic == "alod" or not sgrid.stageable(shape[2], grid, statistic):
        assert not sgrid.stageable(shape[2], grid, statistic)
        with pytest.raises(ValueError):
            sgrid.subsample_grid(data, months, rows, idx, body="staged", **kw)
        return
    staged = sgrid.subsample_grid_seeded(data, months, rows, seeds,
                                         draws=draws, draw_size=ds,
                                         body="staged", **kw)
    direct = sgrid.subsample_grid_seeded(data, months, rows, seeds,
                                         draws=draws, draw_size=ds,
                                         body="direct", **kw)
    assert torch.equal(staged, direct)
    assert torch.equal(sgrid.subsample_grid(data, months, rows, idx,
                                            body="staged", **kw), staged)
    assert torch.equal(sgrid.subsample_grid(data, months, rows, idx,
                                            body="direct", **kw), staged)
    _assert_grid_close(staged, ref.subsample_grid_ref(data, months, rows,
                                                      idx, **kw))


@pytest.mark.cuda
def test_grid_staged_launches_from_two_threads(cuda):
    """Two threads, each on its own stream, launch the staged body at once
    on rows of two lengths (40 KB and 190 KB of dynamic shared memory):
    every launch runs and equals the same launch made alone."""
    kw = dict(draws=8, draw_size=2048, grid=120, statistic="monthly_mean",
              body="staged")
    inputs = {}
    for sl in (2048, 32768):
        data, months, rows, _ = _grid_inputs(2, 8, sl, 3, 8, 2048, 120, sl,
                                             cuda)
        seeds = torch.tensor([3, -1, 40], dtype=torch.int32, device=cuda)
        alone = sgrid.subsample_grid_seeded(data, months, rows, seeds, **kw)
        inputs[sl] = (data, months, rows, seeds, alone)
    torch.cuda.synchronize()

    def launches(sl):
        data, months, rows, seeds, alone = inputs[sl]
        stream = torch.cuda.Stream(cuda)
        with torch.cuda.stream(stream):
            outs = [sgrid.subsample_grid_seeded(data, months, rows, seeds,
                                                **kw) for _ in range(40)]
        stream.synchronize()
        return [bool(torch.equal(out, alone)) for out in outs]

    with ThreadPoolExecutor(2) as pool:
        results = list(pool.map(launches, [2048, 32768, 2048, 32768]))
    assert all(all(r) for r in results)


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
@pytest.mark.parametrize("sl", [4096, 20000])
def test_grid_task_does_not_depend_on_the_wave_at_the_split(cuda, statistic,
                                                            sl):
    """With a (task, sample) cut into several CTAs (groups 2 staged at sl
    4,096, 4 direct at 20,000 for monthly_mean; 4 for alod's 30 draws),
    each task of waves of 16 and 3 equals the task alone, bit for bit."""
    draws, ds = (8, 2048) if statistic == "monthly_mean" else (30, 256)
    data, months, rows, _ = _grid_inputs(5, 6, sl, 16, draws, ds, 120, sl,
                                         cuda)
    cut = sgrid.plan_for(data, months, draws, ds, 120, statistic)
    assert cut.groups > 1
    seeds = torch.arange(16, dtype=torch.int32, device=cuda) * 31 - 7
    kw = dict(draws=draws, draw_size=ds, grid=120, statistic=statistic)
    wave = ops.subsample_grid_seeded(data, months, rows, seeds, **kw)
    three = ops.subsample_grid_seeded(data, months, rows[4:7].contiguous(),
                                      seeds[4:7].contiguous(), **kw)
    assert torch.equal(three, wave[4:7])
    for b in range(16):
        one = ops.subsample_grid_seeded(data, months,
                                        rows[b:b + 1].contiguous(),
                                        seeds[b:b + 1].contiguous(), **kw)
        assert torch.equal(wave[b], one[0]), b


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
def test_grid_kernel_at_grid_512(cuda, statistic):
    """At the widest grid the kernel takes (one bin copy a warp, 32
    phases), against its plain version and the read form."""
    data, months, rows, idx = _grid_inputs(3, 8, 4096, 4, 8, 500, 512, 512,
                                           cuda)
    seeds = torch.arange(4, dtype=torch.int32, device=cuda)
    idx = prng.randint(prng.PRNGKey(seeds), (8, 8, 500), 0, 4096)
    kw = dict(grid=512, statistic=statistic)
    got = ops.subsample_grid_seeded(data, months, rows, seeds, draws=8,
                                    draw_size=500, **kw)
    assert torch.equal(got, ops.subsample_grid(data, months, rows, idx, **kw))
    _assert_grid_close(got, ref.subsample_grid_ref(data, months, rows, idx,
                                                   **kw))
    assert float(got[:, 1].sum()) == 4 * 8 * 8 * 500


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["alod", "monthly_mean"])
@pytest.mark.parametrize("case", _grid_order.CASES)
def test_grid_kernel_equals_its_order_emulated(cuda, statistic, case):
    """The kernel equals the CPU emulation of its summation order
    (tests/_grid_order.py) bit for bit, in each body it can take."""
    arrays = _grid_order.inputs(*case, seed=sum(case))
    grid = case[-1]
    want = _grid_order.emulate(*arrays, grid=grid, statistic=statistic)
    data, months, rows, idx = (torch.from_numpy(a).to(cuda) for a in arrays)
    bodies = (("direct", "staged")
              if sgrid.stageable(case[2], grid, statistic) else ("direct",))
    for body in bodies:
        got = sgrid.subsample_grid(data, months, rows, idx, grid=grid,
                                   statistic=statistic, body=body)
        assert torch.equal(got.cpu(), torch.from_numpy(want)), body


# -- the platform's data plane and recovery on the card


def _platform_job(engine):
    from repro_torch.core import subsample as ss
    from repro_torch.data import NetflixSpec, netflix_dataset
    from repro_torch.platform import MOMENTS

    samples, months = netflix_dataset(NetflixSpec(n_movies=96,
                                                  mean_ratings=400))
    mean = float(np.mean([a.nbytes for a in samples.values()]))
    return samples, months, (MOMENTS if engine == "kernel"
                             else ss.NETFLIX_LOW), 8 * mean


def _platform_spec(knee, **kw):
    from repro_torch.platform import PlatformSpec, WaveOptions

    return PlatformSpec(platform="BTS", n_workers=2, knee_bytes=knee,
                        waves=WaveOptions(wave="on", max_wave=4), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_job_with_a_store_equals_the_job_without_on_the_card(cuda, engine):
    """A datastore with balanced scheduling, prefetch and the block cache
    models the data plane only: the job's result on the card is the
    plain job's bit for bit."""
    from repro_torch.core.blockcache import CacheOptions
    from repro_torch.core.datastore import ReplicatedDataStore
    from repro_torch.platform import Platform, ScheduleOptions

    samples, months, wl, knee = _platform_job(engine)
    plain = Platform(_platform_spec(knee)).run(samples, months, wl)
    store = ReplicatedDataStore(n_initial=3)
    rep = Platform(_platform_spec(
        knee, schedule=ScheduleOptions(balanced="on", prefetch="on"),
        cache=CacheOptions(capacity_bytes=1 << 24)),
        datastore=store).run(samples, months, wl)
    assert rep.engine == engine
    for key in plain.result:
        assert np.array_equal(np.asarray(plain.result[key]),
                              np.asarray(rep.result[key])), key
    assert sum(store.fetch_counts().values()) > 0
    assert rep.prefetch_stats is not None and rep.cache_stats is not None


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_resume_is_bitwise_on_the_card(cuda, engine, tmp_path):
    """A job checkpointed and crashed at its second save resumes on the
    card to the uninterrupted result bit for bit, launching only for the
    missing tasks."""
    from repro_torch.platform import FaultOptions, Platform
    from repro_torch.platform.driver import JobCheckpointer
    from repro_torch.platform.faults import (FaultEvent, FaultInjector,
                                             FaultPlan, InjectedCrash)

    samples, months, wl, knee = _platform_job(engine)
    plain = Platform(_platform_spec(knee)).run(samples, months, wl)
    d = str(tmp_path / "ck")
    inj = FaultInjector(FaultPlan((FaultEvent("checkpoint_crash",
                                              at_saves=2),)))
    with pytest.raises(InjectedCrash):
        Platform(_platform_spec(knee, faults=FaultOptions(
            checkpoint_dir=d, checkpoint_every=2)),
            fault_injector=inj).run(samples, months, wl)
    restored, n_tasks = JobCheckpointer.load(d)
    assert n_tasks == plain.n_tasks and 0 < len(restored) < n_tasks
    rep = Platform(_platform_spec(knee)).run(samples, months, wl,
                                             resume_from=d)
    for key in plain.result:
        assert np.array_equal(np.asarray(plain.result[key]),
                              np.asarray(rep.result[key])), key
    assert rep.tasks_restored == len(restored)
    assert sum(rep.wave_sizes) == plain.n_tasks - len(restored)


# -- the multi-tenant service on the card


@pytest.mark.cuda
def test_service_fused_waves_equal_jobs_alone_on_the_card(cuda):
    """Two ``moments`` jobs and two NETFLIX_LOW jobs submitted together
    ride fused waves (one launch carrying tasks of several jobs, each
    drawing from its own job's seed), and each equals the same job
    submitted alone to the same service bit for bit; the kernels launch
    once a dispatch."""
    from repro_torch.core import subsample as ss
    from repro_torch.platform import MOMENTS, PlatformService, PlatformSpec
    from repro_torch.platform import WaveOptions

    samples, months, _, knee = _platform_job("kernel")
    # one worker and waves wider than a job: the first claim of each
    # query class fills its job's run of tasks with the peer's
    spec = PlatformSpec(platform="BTS", n_workers=1, knee_bytes=knee,
                        waves=WaveOptions(wave="on", max_wave=16))
    jobs = [(wl, seed) for wl in (MOMENTS, ss.NETFLIX_LOW) for seed in (1, 2)]
    kernels = ("subsample_stats", "subsample_grid")
    with PlatformService(spec) as svc:
        handle = svc.register_dataset(samples, months)
        alone = {(wl.name, seed): svc.submit(handle, wl, seed=seed).result(
            timeout=300) for wl, seed in jobs}
        before = svc.stats()
        launched = sum(ops.launch_count(k) for k in kernels)
        with svc._pool._cond:       # every job queued before the first claim
            tickets = {(wl.name, seed): svc.submit(handle, wl, seed=seed)
                       for wl, seed in jobs}
        got = {key: t.result(timeout=300) for key, t in tickets.items()}
        torch.cuda.synchronize()
        after = svc.stats()
        launched = sum(ops.launch_count(k) for k in kernels) - launched
    assert after["fused_dispatches"] - before["fused_dispatches"] >= 2
    assert launched == after["device_dispatches"] - before["device_dispatches"]
    for key, result in got.items():
        for name in result:
            assert np.array_equal(np.asarray(alone[key][name]),
                                  np.asarray(result[name])), (key, name)


# -- sharded waves on the card


def _sharded_arenas(engine, n_entries=4):
    """A job's plan packed twice on the card: plainly, and over a wave
    mesh of ``n_entries`` streams on one card."""
    from repro_torch.launch.mesh import WaveMesh
    from repro_torch.platform import compute as pc
    from repro_torch.platform.driver import plan_job

    samples, months, wl, knee = _platform_job(engine)
    plan = plan_job(samples, months, wl, sizing="kneepoint", engine=engine,
                    n_exec=2, knee_bytes=knee, device="cuda")
    with_months = engine == "torch"
    plain = pc.BlockArena.pack(plan.tasks, plan.task_shape, plan.build_block,
                               with_months=with_months, device="cuda")
    mesh = WaveMesh((torch.device("cuda", 0),) * n_entries)
    sharded = pc.ShardedBlockArena.pack(plan.tasks, plan.task_shape,
                                        plan.build_block, mesh,
                                        with_months=with_months)
    by_key = {}
    for task in plan.tasks:
        by_key.setdefault(plan.task_shape(task), []).append(task)
    waves = [group[i:i + 8] for group in by_key.values()
             for i in range(0, len(group), 8)]
    return plain, sharded, waves, wl


def _assert_partials_equal(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for key in w:
            assert np.array_equal(np.asarray(w[key]), np.asarray(g[key])), key


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_sharded_waves_on_four_streams_equal_unsharded(cuda, engine):
    """Every wave of a job's plan over a mesh of four streams on one card
    equals the unsharded wave bit for bit, launching once an occupied
    entry."""
    from repro_torch.platform import compute as pc

    plain, sharded, waves, wl = _sharded_arenas(engine)
    kernel = "subsample_stats" if engine == "kernel" else "subsample_grid"
    for k, wave in enumerate(waves):
        seeds = np.arange(len(wave), dtype=np.int32) + 7 * k
        want = pc.run_map_wave(plain, wave, seeds, wl, engine)
        before = ops.launch_count(kernel)
        got = pc.run_map_wave(sharded, wave, seeds, wl, engine)
        occupied = len(set(sharded.dev_slots(wave)[1].tolist()))
        assert ops.launch_count(kernel) - before == occupied
        _assert_partials_equal(want, got)


@pytest.mark.cuda
def test_sharded_waves_from_two_threads(cuda):
    """Two threads dispatching sharded waves at once on one mesh (its
    streams shared between them) each get their waves' results, bit for
    bit those of the same waves dispatched alone."""
    from repro_torch.platform import compute as pc

    _, sharded, waves, wl = _sharded_arenas("kernel")
    seeded = [(wave, np.arange(len(wave), dtype=np.int32) + 3 * k)
              for k, wave in enumerate(waves)]
    alone = [pc.run_map_wave(sharded, w, s, wl, "kernel") for w, s in seeded]

    def dispatch(start):
        return [pc.run_map_wave(sharded, w, s, wl, "kernel")
                for w, s in seeded[start:] + seeded[:start]]

    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(dispatch, start)
                for start in (0, len(seeded) // 2)]
        results = [run.result(timeout=300) for run in runs]
    n = len(seeded)
    for start, got in zip((0, n // 2), results):
        for k, partials in enumerate(got):
            _assert_partials_equal(alone[(start + k) % n], partials)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_platform_mesh_1_equals_unsharded_on_the_card(cuda, engine):
    """``Platform.run`` with ``mesh_devices=1`` on the card: the unsharded
    job's result bit for bit, with the same dispatches (one worker: two
    may cut a job's tail into waves differently from run to run); a mesh
    larger than the machine's cards raises."""
    from repro_torch.platform import Platform, PlatformSpec, WaveOptions

    samples, months, wl, knee = _platform_job(engine)

    def run(mesh):
        return Platform(PlatformSpec(
            platform="BTS", n_workers=1, knee_bytes=knee,
            waves=WaveOptions(wave="on", max_wave=4,
                              mesh_devices=mesh))).run(samples, months, wl)

    plain, sharded = run(None), run(1)
    assert sharded.device_dispatches == plain.device_dispatches
    for key in plain.result:
        assert np.array_equal(np.asarray(plain.result[key]),
                              np.asarray(sharded.result[key])), key
    with pytest.raises(ValueError, match="device"):
        run(torch.cuda.device_count() + 1)


# -- flash_attention's backward and training ---------------------------------

# flash_attention_bwd against its plain version, both fed the kernel's own
# output and log-sum-exp: fp32 sums in other orders (~1e-5 of the
# gradients' scale); bf16 gradients are one rounding of those, so they may
# part by one bf16 step (2^-8 relative) plus the fp32 difference near zero
FA_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,hd,causal,group,dtype", [
    (6, 300, 300, 64, True, 1, torch.bfloat16),       # musicgen's HD, ragged
    (12, 200, 257, 128, False, 6, torch.float32),     # group 6, Sq < Skv
    # bf16 at HD 64 and 128: the tensor-core body
    (4, 2048, 2048, 64, True, 1, torch.bfloat16),     # musicgen's lengths
    (2, 4064, 4064, 128, True, 1, torch.bfloat16),    # deepseek-7b's
    (12, 577, 577, 128, True, 6, torch.bfloat16),     # group 6, off 64
    (16, 300, 300, 128, True, 8, torch.bfloat16),     # group 8
    (12, 200, 257, 64, False, 6, torch.bfloat16),     # Sq < Skv, not causal
    (6, 1, 1000, 128, False, 1, torch.bfloat16),      # Sq = 1
    (6, 1, 1, 64, True, 1, torch.bfloat16),           # one token
    (4, 300, 40, 128, False, 2, torch.bfloat16),      # Skv < 64
    (4, 100, 40, 64, True, 1, torch.bfloat16),        # Skv < 64, causal
    (4, 130, 130, 64, True, 2, torch.bfloat16),       # a row past 128
    (6, 500, 300, 32, True, 2, torch.bfloat16),       # HD 32 on that body
    # bf16 at HD 256: the split dK/dV and its partial sum
    (4, 129, 129, 256, True, 2, torch.bfloat16),      # a row past 128
    (10, 1000, 1000, 256, True, 10, torch.bfloat16),  # group 10, ragged
    (6, 200, 77, 256, False, 3, torch.bfloat16),      # Skv < 128, Sq > Skv
    (4, 300, 300, 256, True, 1, torch.float32),       # fp32 stays on cores
])
def test_flash_bwd_kernel_matches_plain_version(cuda, bh, sq, skv, hd, causal,
                                                group, dtype):
    q, k, v = _attn_inputs(bh, sq, skv, hd, group, dtype, bh + sq, cuda)
    dout = torch.randn_like(q.float()).to(dtype)
    out, lse = fa.flash_attention(q, k, v, causal=causal, window=0,
                                  group=group, with_lse=True)
    before = ops.launch_count("flash_attention_bwd")
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                  group=group)
    torch.cuda.synchronize()
    assert ops.launch_count("flash_attention_bwd") == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, group=group)
    rtol, atol = FA_BWD_TOL[dtype]
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
    again = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                    group=group)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_flash_bwd_body_sends_bf16_to_the_tensor_cores(cuda):
    """``BODY`` sends bf16 to ``wgmma`` and fp32 to the CUDA cores, and a
    launch runs the kernels of the body it names (by the names the
    profiler records): at HD 256 on the tensor cores the split dK/dV and
    its partial sum."""
    from torch.profiler import ProfilerActivity, profile

    assert fab.BODY[(torch.bfloat16, 64)] == "wgmma"
    assert fab.BODY[(torch.bfloat16, 128)] == "wgmma"
    assert fab.BODY[(torch.bfloat16, 256)] == "wgmma"
    assert fab.BODY[(torch.float32, 128)] == "cuda_cores"
    kernels = {"wgmma": {"flash_bwd_rows_kernel", "flash_bwd_dkdv_wgmma_kernel",
                         "flash_bwd_dq_wgmma_kernel"},
               "wgmma256": {"flash_bwd_rows_kernel",
                            "flash_bwd_dkdv_split_wgmma_kernel",
                            "flash_bwd_dkdv_sum_kernel",
                            "flash_bwd_dq_wgmma_kernel"},
               "cuda_cores": {"flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                              "flash_bwd_dq_kernel"}}
    for (dtype, hd), body in sorted(fab.BODY.items(), key=str):
        q, k, v = _attn_inputs(2, 100, 100, hd, 1, dtype, hd, cuda)
        dout = torch.randn_like(q.float()).to(dtype)
        out, lse = fa.flash_attention(q, k, v, causal=True, window=0,
                                      group=1, with_lse=True)
        ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        ran = {kernel for kernel in set().union(*kernels.values())
               if any(kernel in name for name in names)}
        want = "wgmma256" if body == "wgmma" and hd == 256 else body
        assert ran == kernels[want], (dtype, hd, names)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k", "dout"])
def test_flash_bwd_kernel_takes_bf16_views_that_are_not_16_byte_aligned(
        cuda, which):
    """A contiguous bf16 view one element into its storage: the wrapper
    hands the tensor-core body's TMA an aligned copy."""
    q, k, v = _attn_inputs(12, 333, 333, 128, 6, torch.bfloat16, 11, cuda)
    dout = torch.randn_like(q.float()).to(torch.bfloat16)
    out, lse = fa.flash_attention(q, k, v, causal=True, window=0, group=6,
                                  with_lse=True)
    x = {"q": q, "k": k, "dout": dout}[which]
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    args = {"q": q, "k": k, "v": v, "out": out, "lse": lse, "dout": dout}
    args[which] = shifted
    got = ops.flash_attention_bwd(*(args[n] for n in (
        "q", "k", "v", "out", "lse", "dout")), causal=True, group=6)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=True,
                                       group=6)
    rtol, atol = FA_BWD_TOL[torch.bfloat16]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_lse_matches_plain_lse(cuda, dtype):
    q, k, v = _attn_inputs(8, 333, 333, 64, 2, dtype, 5, cuda)
    out, lse = fa.flash_attention(q, k, v, causal=True, window=0, group=2,
                                  with_lse=True)
    plain = fa.flash_attention(q, k, v, causal=True, window=0, group=2)
    assert torch.equal(out, plain)              # the lse changes no output
    want = ref.flash_attention_lse_ref(q, k, causal=True, group=2)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_attention_launches_no_lse_when_grad_is_off(cuda, monkeypatch):
    q, k, v = _attn_inputs(4, 128, 128, 64, 1, torch.bfloat16, 6, cuda)
    asked = []
    launch = fa.flash_attention

    def spy(*args, **kwargs):
        asked.append(kwargs.get("with_lse", False))
        return launch(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", spy)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        ops.flash_attention(*leaves)
    ops.flash_attention(q, k, v)
    assert asked == [False, False]
    ops.reset_launch_count()
    out = ops.flash_attention(*leaves)
    out.float().square().sum().backward()
    assert asked == [False, False, True]
    assert ops.launch_count("flash_attention_bwd") == 1
    assert all(float(t.grad.float().abs().sum()) > 0 for t in leaves)


@pytest.mark.cuda
def test_quantize_int8_on_the_card_equals_the_cpu(cuda):
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((33, 257)) * 1e-3).astype(np.float32)
    q_cpu, s_cpu = compression.quantize_int8(torch.from_numpy(x))
    q_gpu, s_gpu = compression.quantize_int8(torch.from_numpy(x).to(cuda))
    assert torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)
    for log_space in (False, True):
        m_cpu = adamw._quantize(torch.from_numpy(np.abs(x)), log_space)
        m_gpu = adamw._quantize(torch.from_numpy(np.abs(x)).to(cuda),
                                log_space)
        assert torch.equal(m_gpu.q.cpu(), m_cpu.q)


@pytest.mark.cuda
def test_training_step_on_the_card_matches_the_cpu(cuda):
    """One step of a 2-layer ``musicgen-medium`` (width cut to 256) in fp32
    on the card and on the CPU from the same state: the losses agree to
    1e-4, each on its own path (kernels, plain versions)."""
    from repro_torch.config import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.config import TrainConfig
    from repro_torch.train import loop
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("musicgen-medium"), num_layers=2,
                              d_model=256, d_ff=512, num_heads=4,
                              num_kv_heads=4, dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 128, 2),
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    train=TrainConfig(learning_rate=1e-2, warmup_steps=1))
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 128)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 128))}
    cpu_model = Model(cfg, device="cpu")
    state = loop.init_state(cpu_model, run)._replace(
        step=torch.ones((), dtype=torch.int32))
    losses = []
    for model, st in ((cpu_model, state),
                      (Model(cfg), tree_map(lambda t: t.to(cuda), state))):
        ops.reset_launch_count()
        _, metrics = loop.make_train_step(model, run)(
            st, loop.to_device(batch, model.device))
        losses.append(float(metrics["loss"]))
    assert ops.launch_count("flash_attention") == 4     # 2 layers, remat
    assert ops.launch_count("flash_attention_bwd") == 2
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


# -- the recurrences' backward kernels ---------------------------------------

# rwkv6_chunked_bwd against its plain version on the forward kernel's own
# states: fp32 gradients within RW_BWD_TOL of each leaf's largest entry
# (products in other orders, each pairwise decay one ex2.approx); a bf16
# gradient is one rounding of such a value, one bf16 step more at most
RW_BWD_TOL = 1e-4


def _held(got, want, tol):
    g, w = got.double(), want.double()
    scale = float(w.abs().max())
    step = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(((g - w).abs() <= tol * scale + step * w.abs()).all()), (
        float((g - w).abs().max()), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,hd,chunk,dtype,logw_dtype,span", [
    (1, 4, 512, 64, 64, torch.bfloat16, torch.float32, 2.45),  # the model's
    (2, 3, 96, 32, 16, torch.bfloat16, torch.float32, 2.45),   # hd 32, C 16
    (2, 2, 128, 64, 64, torch.float32, torch.float32, 39.95),  # extreme decay
    (1, 2, 40, 64, 8, torch.float32, torch.bfloat16, 2.45),    # bf16 decays
    (3, 1, 21, 32, 7, torch.bfloat16, torch.bfloat16, 2.45),   # odd chunk
    (1, 3, 13, 64, 13, torch.float32, torch.float32, 2.45),    # one chunk
    (1, 8, 160, 64, 40, torch.bfloat16, torch.float32, 2.45),  # C not of 16
    # B·H = 67: pass A's 134 CTAs (two of 32 rows a head) pass an H100's
    # 132 SMs, where the training shape's 128 fit
    (1, 67, 128, 64, 64, torch.bfloat16, torch.float32, 2.45),
])
def test_rwkv6_bwd_kernel_matches_plain_version(cuda, b, h, s, hd, chunk,
                                                dtype, logw_dtype, span):
    from repro_torch.kernels import rwkv6_scan

    x = _rwkv_inputs(b, h, s, hd, dtype, logw_dtype, b + s, cuda, span=span)
    _, state_out, states = rwkv6_scan.rwkv6_chunked(*x, chunk,
                                                    with_states=True)
    rng = np.random.default_rng(s)
    dout = torch.from_numpy(rng.standard_normal((b, h, s, hd)).astype(
        np.float32)).to(cuda)
    dstate = torch.from_numpy(rng.standard_normal((b, h, hd, hd)).astype(
        np.float32)).to(cuda)
    args = (*x, states, state_out, dout, dstate)
    before = ops.launch_count("rwkv6_chunked_bwd")
    got = ops.rwkv6_chunked_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launch_count("rwkv6_chunked_bwd") == before + 1
    want = ref.rwkv6_chunked_bwd_ref(*args, chunk)
    for g, w in zip(got, want):
        _held(g, w, RW_BWD_TOL)
    again = ops.rwkv6_chunked_bwd(*args, chunk=chunk)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.cuda
def test_rwkv6_function_backward_launches_the_kernel(cuda):
    r, k, v, logw, u, state = _rwkv_inputs(1, 2, 64, 64, torch.bfloat16,
                                           torch.float32, 5, cuda)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, logw, u, state)]
    ops.reset_launch_count()
    out, state_out = ops.rwkv6_chunked(*leaves[:5], chunk=16,
                                       state=leaves[5])
    (out.square().sum() + state_out.sum()).backward()
    assert ops.launch_count("rwkv6_chunked") == 1
    assert ops.launch_count("rwkv6_chunked_bwd") == 1
    assert all(float(t.grad.float().abs().sum()) > 0 for t in leaves)


# rglru_scan_bwd: the read form and the gated form's du and dh0 take the
# plain version's operations one by one, bit for bit; the gate vectors'
# sums add in another order than torch.sum's (the kernel's, which
# ref.rglru_gated_scan_bwd_kernel_order_ref repeats bit for bit)
RG_SUM_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", [(2, 300, 200), (1, 1, 7), (3, 70, 2563),
                                   (1, 4096, 2560)])
def test_rglru_bwd_kernel_read_form_equals_plain_version(cuda, b, s, w):
    g = torch.Generator(device=cuda).manual_seed(s + w)
    a = 0.2 + 0.79 * torch.rand((b, s, w), generator=g, device=cuda)
    x, dh = (torch.randn((b, s, w), generator=g, device=cuda)
             for _ in range(2))
    h0 = torch.randn((b, w), generator=g, device=cuda)
    h = ops.rglru_scan(a, x, h0)
    before = ops.launch_count("rglru_scan_bwd")
    got = ops.rglru_scan_bwd(a, h, h0, dh)
    torch.cuda.synchronize()
    assert ops.launch_count("rglru_scan_bwd") == before + 1
    for p, q in zip(got, ref.rglru_scan_bwd_ref(a, h, h0, dh)):
        assert torch.equal(p, q)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w,dtype,lam", [
    (1, 4096, 2560, torch.bfloat16, 1.0),      # the model's path
    (2, 1, 100, torch.bfloat16, 1.0),          # S = 1
    (3, 70, 2563, torch.bfloat16, 1.0),        # W off the channel block
    (2, 70, 100, torch.bfloat16, 1.0),         # W off it, a short chunk
    (2, 130, 48, torch.float32, -20.0),        # the clamp binds
])
def test_rglru_bwd_kernel_gated_form_matches_plain_version(cuda, b, s, w,
                                                           dtype, lam):
    g = torch.Generator(device=cuda).manual_seed(s + w)
    u = (2.0 * torch.randn((b, s, w), generator=g, device=cuda)).to(dtype)
    gates = [(m + 0.3 * torch.randn((w,), generator=g, device=cuda)).to(dtype)
             for m in (1.0, 0.0, 1.0, 0.0)]
    sp = torch.nn.functional.softplus(
        lam + 0.3 * torch.randn((w,), generator=g, device=cuda))
    h0 = torch.randn((b, w), generator=g, device=cuda)
    dh = torch.randn((b, s, w), generator=g, device=cuda)
    h = ops.rglru_gated_scan(u, *gates, sp, h0)
    args = (u, *gates, sp, h0, h, dh)
    got = ops.rglru_gated_scan_bwd(*args)
    want = ref.rglru_gated_scan_bwd_ref(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[6], want[6])
    for p, q in zip(got[1:6], want[1:6]):
        _held(p, q, RG_SUM_TOL)
        assert p.dtype == q.dtype
    # the sums in the kernel's documented order: bit for bit
    ordered = ref.rglru_gated_scan_bwd_kernel_order_ref(*args)
    assert all(torch.equal(p, q) for p, q in zip(got, ordered))
    again = ops.rglru_gated_scan_bwd(*args)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.cuda
def test_rglru_function_backward_launches_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    u = torch.randn((2, 50, 40), generator=g, device=cuda).to(torch.bfloat16)
    gates = [torch.randn((40,), generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(4)]
    lam = torch.randn((40,), generator=g, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (u, *gates, lam)]
    h0 = torch.zeros((2, 40), device=cuda)
    ops.reset_launch_count()
    out = ops.rglru_gated_scan(*leaves[:5],
                               torch.nn.functional.softplus(leaves[5]), h0)
    out.square().sum().backward()
    assert ops.launch_count("rglru_scan") == 1
    assert ops.launch_count("rglru_scan_bwd") == 1
    assert all(float(t.grad.float().abs().sum()) > 0 for t in leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,hd,causal,window,group,dtype", [
    (10, 600, 600, 256, True, 128, 10, torch.bfloat16),   # the local layer
    (20, 2048, 2048, 256, True, 512, 10, torch.bfloat16),  # splits of 2 heads
    (10, 1000, 1000, 256, True, 300, 10, torch.bfloat16),  # ragged Sq
    (4, 300, 500, 256, False, 100, 2, torch.bfloat16),    # not causal
    (8, 700, 700, 64, True, 128, 1, torch.bfloat16),      # tensor cores
    (12, 577, 577, 128, True, 100, 2, torch.bfloat16),    # ragged, group 2
    (4, 300, 300, 64, True, 1, 1, torch.bfloat16),        # window 1
    (6, 200, 257, 64, False, 50, 2, torch.bfloat16),      # not causal
    (6, 400, 400, 64, True, 64, 3, torch.float32),        # fp32
])
def test_windowed_flash_bwd_kernel_matches_plain_version(
        cuda, bh, sq, skv, hd, causal, window, group, dtype):
    q, k, v = _attn_inputs(bh, sq, skv, hd, group, dtype, bh + sq, cuda)
    dout = torch.randn_like(q.float()).to(dtype)
    kw = dict(causal=causal, window=window, group=group)
    out, lse = fa.flash_attention(q, k, v, with_lse=True, **kw)
    got = ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    rtol, atol = FA_BWD_TOL[dtype]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
    again = ops.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(64, torch.bfloat16),
                                      (256, torch.bfloat16),
                                      (128, torch.float32)])
def test_windowed_flash_bwd_past_s_is_the_causal_backward(cuda, hd, dtype):
    q, k, v = _attn_inputs(4, 300, 300, hd, 2, dtype, hd, cuda)
    dout = torch.randn_like(q.float()).to(dtype)
    out, lse = fa.flash_attention(q, k, v, causal=True, window=0, group=2,
                                  with_lse=True)
    causal = ops.flash_attention_bwd(q, k, v, out, lse, dout, group=2)
    for window in (300, 1000):
        got = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                      window=window, group=2)
        assert all(torch.equal(a, b) for a, b in zip(got, causal))


# -- the mixture-of-experts layer on the card


def _moe_layer(cfg, seed, device):
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import init_params
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params = init_params(moe.moe_defs(cfg), torch.float32,
                         torch.device("cpu"), gen)
    return {k: (v.to(device) if torch.is_tensor(v)
                else {n: t.to(device) for n, t in v.items()})
            for k, v in params.items()}


@pytest.mark.cuda
def test_moe_top_k_ties_go_to_the_lower_index_on_the_card(cuda):
    """Router columns equal in fours (4j .. 4j + 3), bf16: every token's
    probabilities tie in fours, the top 6 takes part of a four, and there
    the lower indices; with every column equal, the top k is 0 .. k - 1
    for every token."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), d_model=256)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1024, cfg.d_model), generator=g).to(cuda,
                                                          torch.bfloat16)
    cols = torch.randn((cfg.d_model, cfg.num_experts // 4),
                       generator=g).to(cuda)
    router = cols.repeat_interleave(4, dim=1).to(torch.bfloat16)
    idx, _, _, probs = moe._route(cfg, {"router": router}, x)
    fours = probs.view(-1, cfg.num_experts // 4, 4)
    assert torch.equal(fours, fours[..., :1].expand_as(fours))
    chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, idx, True)
    chosen = chosen.view(-1, cfg.num_experts // 4, 4).int()
    partial = (chosen.sum(-1) % 4) != 0
    assert bool(partial.any(-1).all())           # a tie at the cut, a token
    assert bool((chosen[..., 1:] <= chosen[..., :-1]).all())
    same = torch.ones((cfg.d_model, cfg.num_experts), device=cuda,
                      dtype=torch.bfloat16) * cols[:, :1].to(torch.bfloat16)
    idx, _, _, _ = moe._route(cfg, {"router": same}, x)
    assert torch.equal(idx, torch.arange(cfg.moe_top_k, device=cuda)
                       .expand_as(idx))


def _bf16_layer(params, device):
    return {k: (v.to(device, torch.bfloat16) if torch.is_tensor(v)
                else _bf16_layer(v, device)) for k, v in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [4, 3000])
def test_dropless_moe_on_the_card_waits_for_nothing(cuda, tokens):
    """DeepSeek-V2-Lite's MoE (64 experts, top 6, 2 shared) at width 256
    in bf16, for a decode step's 4 tokens and a prefill's 3,000: the
    grouped products over the pairs sorted by expert give one product an
    expert's output (to bf16's rounding: the library may order a sum
    otherwise for another number of rows), and the layer makes no
    blocking wait for the card (``set_sync_debug_mode("error")`` raises
    on one)."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), d_model=256,
                              moe_seq_chunk=0)
    params = _bf16_layer(_moe_layer(cfg, 11, "cpu"), cuda)
    x = torch.randn((1, tokens, cfg.d_model),
                    generator=torch.Generator().manual_seed(12)).to(
                        cuda, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = moe.moe_apply(cfg, params, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    xf = x[0]
    idx, gate, _, _ = moe._route(cfg, params, xf)
    want = torch.zeros(xf.shape, dtype=torch.float32, device=cuda)
    for e in range(cfg.num_experts):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        part = xf[tok]
        y = ((part @ params["we_i"][e]) * torch.nn.functional.silu(
            part @ params["we_g"][e])) @ params["we_d"][e]
        want.index_add_(0, tok, y.float() * gate[tok, choice][:, None])
    want = (want.to(torch.bfloat16) + moe._shared_ffn(params, xf))[None]
    torch.testing.assert_close(got, want, rtol=1.6e-2,
                               atol=1e-2 * float(want.abs().max()))


@pytest.mark.cuda
def test_latent_decode_step_on_the_card_waits_for_nothing(cuda):
    """A two-layer DeepSeek-V2-Lite (one dense layer, one dropless MoE
    layer) at width 256: after prefill, a decode step through the latent
    cache makes no blocking wait for the card, and its logits equal the
    CPU's to bf16's rounding."""
    from repro_torch.serving.kvcache import grow_caches
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), num_layers=2,
                              d_model=256, num_heads=2, num_kv_heads=2,
                              vocab_size=512, first_dense_d_ff=512)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(13))
    from repro_torch.tree import tree_map
    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(cpu_model.generator(0))
    got = {}
    for dev in ("cpu", cuda):
        model = Model(cfg, device=dev)
        params = tree_map(lambda t: t.to(dev), cpu_params)
        with torch.inference_mode():
            _, caches = model.prefill(params,
                                      {"tokens": tokens[:, :39].to(dev)})
            caches = model.prefill_to_decode(grow_caches(caches, 48))
            last = tokens[:, 39:].to(dev)    # an upload waits: not the step's
            if dev != "cpu":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                logits, _ = model.decode_step(params, last, caches, 39)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        got[dev] = logits.float().cpu()
    torch.testing.assert_close(got[cuda], got["cpu"], rtol=5e-2,
                               atol=5e-2 * float(got["cpu"].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["einsum", "scatter"])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, mode):
    """A ``deepseek-moe-16b`` MoE layer at width 256 (64 experts, top 6,
    two shared), fp32 with TF32 off, x [2, 512, 256] (T = 1,024): the
    expert indices equal wherever the k-th/(k+1)-th probability margin
    exceeds 1e-5, the output within 1e-4 of its largest value on the rows
    routed alike, and two launches equal bit for bit."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), d_model=256,
                              moe_d_ff=128)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.randn((2, 512, cfg.d_model),
                        generator=torch.Generator().manual_seed(5))
        outs, idxs = [], []
        for device in ("cpu", cuda):
            params = _moe_layer(cfg, 6, device)
            xd = x.to(device)
            idx, _, _, probs = moe._route(cfg, params, xd.reshape(-1, 256))
            y, aux = moe.moe_apply(cfg, params, xd, dispatch=mode)
            if device != "cpu":
                again, _ = moe.moe_apply(cfg, params, xd, dispatch=mode)
                assert torch.equal(y, again)
            outs.append(y.cpu())
            idxs.append((idx.cpu(), probs.cpu()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (i_cpu, p_cpu), (i_card, _) = idxs
    top = torch.sort(p_cpu, dim=-1, descending=True).values
    margin = top[:, cfg.moe_top_k - 1] - top[:, cfg.moe_top_k]
    clear = margin > 1e-5
    assert torch.equal(i_card[clear], i_cpu[clear])
    alike = (i_card == i_cpu).all(-1)
    scale = float(outs[0].abs().max())
    diff = (outs[1] - outs[0]).reshape(-1, cfg.d_model)[alike].abs().max()
    assert float(diff) <= 1e-4 * scale


@pytest.mark.cuda
def test_collectives_on_four_streams_equal_the_cpu_mesh(cuda):
    """``ring_all_reduce``, ``reduce_scatter`` and ``compressed_psum`` over
    four streams of one card, each shard made on its entry's stream, equal
    the same collectives over four CPU entries bit for bit (the same fp32
    adds in the same order; the int8 payload's division by a tensor)."""
    from repro_torch.launch.mesh import WaveMesh
    from repro_torch.parallel.collectives import (compressed_psum,
                                                  reduce_scatter,
                                                  ring_all_reduce)

    mesh = WaveMesh((cuda,) * 4)
    streams = [mesh.stream(i) for i in range(4)]
    rng = np.random.default_rng(34)
    host = [torch.from_numpy(rng.standard_normal((4096, 256)).astype(
        np.float32)) for _ in range(4)]
    shards = []
    for x, st in zip(host, streams):
        with torch.cuda.stream(st):
            shards.append(x.to(cuda))
    for fn in (ring_all_reduce, reduce_scatter, compressed_psum):
        want = fn(host)
        got = fn(shards, streams)
        torch.cuda.synchronize()
        for w, g in zip(want, got):
            assert torch.equal(w, g.cpu()), fn.__name__
