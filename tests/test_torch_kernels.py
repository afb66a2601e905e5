"""The port's ``subsample_stats`` against the reference Pallas kernel.

Inputs are made with numpy from a seed and handed to both packages.  The
reference runs its Pallas kernel in interpret mode (its default off-TPU);
the port's wrapper, given CPU tensors, runs the kernel's plain PyTorch
version (the CUDA kernel itself is held against that version on the card
by ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``).

Tolerance: ``rtol=1e-5, atol=1e-4``.  Both sides sum the same fp32 rows,
but in different orders inside each 8-row group, so results agree to a
few ulps of the sums, not bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops

RTOL, ATOL = 1e-5, 1e-4


def _inputs(b, n, d, t, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((b, n, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, t)).astype(np.int32)
    return data, idx


@pytest.mark.parametrize("b", (1, 3))
@pytest.mark.parametrize("t", (13, 64))
@pytest.mark.parametrize("d", (96, 128))
def test_subsample_stats_matches_reference(b, t, d):
    data, idx = _inputs(b, 40, d, t, seed=b * 1000 + t + d)
    want = np.asarray(ref_ops.subsample_stats(jnp.asarray(data),
                                              jnp.asarray(idx)))
    got = ops.subsample_stats(torch.from_numpy(data), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 2, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_subsample_stats_matches_float64_sums():
    """An order-free check: the plain version against float64 numpy sums
    of the gathered rows (tolerance as above)."""
    data, idx = _inputs(2, 16, 32, 21, seed=3)
    rows = np.stack([data[i][idx[i]] for i in range(2)]).astype(np.float64)
    want = np.stack([rows.sum(1), (rows * rows).sum(1)], axis=1)
    got = ops.subsample_stats(torch.from_numpy(data), torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", (13, 64))
def test_wave_equals_single_task_launches_bitwise(t):
    """A task's order of summation does not depend on B: a wave of B
    tasks equals B waves of one, bit for bit."""
    data, idx = _inputs(5, 24, 64, t, seed=t)
    wave = ops.subsample_stats(torch.from_numpy(data), torch.from_numpy(idx))
    for i in range(5):
        one = ops.subsample_stats(torch.from_numpy(data[i:i + 1]),
                                  torch.from_numpy(idx[i:i + 1]))
        assert torch.equal(wave[i:i + 1], one)


def test_padded_tail_is_masked():
    """Rows past T in the last 8-row group must not count: T=9 equals
    T=16 with the last 7 indices pointing at an all-zero row."""
    data, idx = _inputs(1, 8, 16, 9, seed=5)
    data[0, 7] = 0.0
    idx = np.minimum(idx, 6)
    padded = np.concatenate([idx, np.full((1, 7), 7, np.int32)], axis=1)
    a = ops.subsample_stats(torch.from_numpy(data), torch.from_numpy(idx))
    b = ops.subsample_stats(torch.from_numpy(data), torch.from_numpy(padded))
    assert torch.equal(a, b)


def test_cpu_tensors_do_not_count_as_launches():
    before = ops.launch_count()
    data, idx = _inputs(1, 8, 16, 8)
    ops.subsample_stats(torch.from_numpy(data), torch.from_numpy(idx))
    assert ops.launch_count() == before


@pytest.mark.parametrize("case", ["dtype", "idx_dtype", "shape", "batch",
                                  "rows_per_step", "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    data = torch.zeros((2, 8, 16), dtype=torch.float32)
    idx = torch.zeros((2, 8), dtype=torch.int32)
    kw = {}
    if case == "dtype":
        data = data.to(torch.float16)
    elif case == "idx_dtype":
        idx = idx.to(torch.int64)
    elif case == "shape":
        data = data[0]
    elif case == "batch":
        idx = idx[:1]
    elif case == "rows_per_step":
        kw = {"rows_per_step": 0}
    else:
        data = data.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        ops.subsample_stats(data, idx, **kw)
