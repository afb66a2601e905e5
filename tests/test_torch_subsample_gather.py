"""The port's ``subsample_gather`` against the reference Pallas kernel.

Inputs are made with numpy from a seed and handed to both packages.  The
reference runs its Pallas kernel in interpret mode (its default off-TPU);
the port's op, given CPU tensors, runs the kernel's plain PyTorch version
(the CUDA kernel itself is held against that version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``).

Tolerances.  The gathered rows are copies: exactly equal.  Both sides add
the same rows one after another in t order into fp32, so the sums
(``stats[0]``) are equal bit for bit.  The reference, compiled by XLA on
the CPU, fuses ``acc + row * row`` into one multiply-add, where the port
rounds the square first (as its kernel does), so in fp32 the sums of
squares agree to rounding only: ``rtol = atol = 1e-5``.  A bf16 value's
square is exact in fp32, so in bf16 both rows of the stats are equal bit
for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import subsample_gather as ref_sg
from repro_torch.kernels import ops, ref
from tests._hypothesis_compat import given, settings, st

RTOL = ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, d, t, seed, dtype="float32"):
    """The same data and indices for both packages (bf16: one rounding of
    the same fp32 values on each side)."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, t).astype(np.int32)
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(data).astype(jdt), jnp.asarray(idx)),
            (torch.from_numpy(data).to(tdt), torch.from_numpy(idx)))


def _assert_matches(want, got, dtype="float32"):
    g_want, s_want = (np.asarray(a, np.float32) for a in want)
    g_got, s_got = got
    assert g_got.dtype == DTYPES[dtype][1] and s_got.dtype == torch.float32
    np.testing.assert_array_equal(g_got.float().numpy(), g_want)
    s_got = s_got.numpy()
    np.testing.assert_array_equal(s_got[0], s_want[0])
    if dtype == "bfloat16":
        np.testing.assert_array_equal(s_got[1], s_want[1])
    else:
        np.testing.assert_allclose(s_got[1], s_want[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d,t", [(64, 128, 32), (256, 64, 128),
                                   (32, 256, 8)])
def test_subsample_gather_matches_reference(n, d, t, dtype):
    (jx, jidx), (tx, tidx) = _inputs(n, d, t, n + d + t, dtype)
    want = ref_ops.subsample_gather(jx, jidx)
    got = ops.subsample_gather(tx, tidx)
    assert tuple(got[0].shape) == (t, d) and tuple(got[1].shape) == (2, d)
    _assert_matches(want, got, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shift", ["zero", "one", "T-3", "T", "T+5"])
def test_masked_tail_matches_reference_kernel(shift, dtype):
    """The TPU kernel's contract: every row is gathered, only the rows
    t < n_valid count in the stats."""
    t = 13
    n_valid = {"zero": 0, "one": 1, "T-3": t - 3, "T": t, "T+5": t + 5}[shift]
    (jx, jidx), (tx, tidx) = _inputs(24, 40, t, 7, dtype)
    want = ref_sg.subsample_gather(jx, jidx, jnp.full((1,), n_valid,
                                                      jnp.int32),
                                   interpret=True)
    got = ops._subsample_gather_padded(
        tx, tidx, torch.full((1,), n_valid, dtype=torch.int32))
    _assert_matches(want, got, dtype)
    assert torch.equal(got[0], tx[tidx.long()])
    # the stats are those of the first min(n_valid, T) rows alone
    head = ops.subsample_gather(tx, tidx[:min(n_valid, t)])[1]
    assert torch.equal(got[1], head)
    assert bool(got[1].any()) == (n_valid > 0)


@pytest.mark.parametrize("t", (1, 5, 7, 8, 13))
def test_unpadded_lengths_match_reference(t):
    """The reference pads T to a power of two and slices back; the port
    launches at T itself.  Same shapes, same values."""
    (jx, jidx), (tx, tidx) = _inputs(32, 8, t, t)
    want = ref_ops.subsample_gather(jx, jidx)
    got = ops.subsample_gather(tx, tidx)
    assert tuple(got[0].shape) == (t, 8) == tuple(want[0].shape)
    _assert_matches(want, got)


@given(st.integers(min_value=1, max_value=64),
       st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_subsample_gather_property(t, seed):
    (jx, jidx), (tx, tidx) = _inputs(32, 16, t, seed)
    _assert_matches(ref_ops.subsample_gather(jx, jidx),
                    ops.subsample_gather(tx, tidx))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_is_a_sequential_fp32_loop(dtype):
    """``ref.subsample_gather_ref`` adds row after row into fp32, the
    square rounded first: a numpy float32 loop gives the same bits."""
    _, (tx, tidx) = _inputs(16, 33, 21, 11, dtype)
    n_valid = 17
    _, stats = ref.subsample_gather_ref(
        tx, tidx, torch.tensor([n_valid], dtype=torch.int32))
    rows = tx.float().numpy()[tidx.numpy()]
    acc = np.zeros(33, np.float32)
    acc2 = np.zeros(33, np.float32)
    for r in rows[:n_valid]:
        acc = acc + r
        sq = r * r
        acc2 = acc2 + sq
    np.testing.assert_array_equal(stats.numpy(), np.stack([acc, acc2]))


def test_cpu_tensors_do_not_count_as_launches():
    before = ops.launch_count("subsample_gather")
    _, (tx, tidx) = _inputs(8, 16, 8, 0)
    ops.subsample_gather(tx, tidx)
    assert ops.launch_count("subsample_gather") == before


@pytest.mark.parametrize("case", ["data3d", "idx2d", "idx_int64", "fp16",
                                  "devices", "n_valid_shape",
                                  "n_valid_int64", "strided", "no_rows"])
def test_op_rejects_what_the_kernel_does_not_take(case):
    data = torch.zeros((8, 16), dtype=torch.float32)
    idx = torch.zeros(8, dtype=torch.int32)
    n_valid = torch.full((1,), 8, dtype=torch.int32)
    if case == "data3d":
        data = data[None]
    elif case == "idx2d":
        idx = idx[None]
    elif case == "idx_int64":
        idx = idx.to(torch.int64)
    elif case == "fp16":
        data = data.to(torch.float16)
    elif case == "devices":
        idx = idx.to("meta")
    elif case == "n_valid_shape":
        n_valid = n_valid.reshape(())
    elif case == "n_valid_int64":
        n_valid = n_valid.to(torch.int64)
    elif case == "strided":
        data = torch.zeros((8, 32))[:, ::2]
    else:
        data = data[:0]
    with pytest.raises((TypeError, ValueError)):
        ops._subsample_gather_padded(data, idx, n_valid)
    if case not in ("n_valid_shape", "n_valid_int64"):
        with pytest.raises((TypeError, ValueError)):
            ops.subsample_gather(data, idx)
