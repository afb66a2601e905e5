"""The port's threefry PRNG against ``jax.random``: exact int32 equality.

The reference draws each task's row indices with
``jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, ns, int32)``
(vmapped over a wave's seeds); ``repro_torch.prng`` must give the same
integers, so that the two packages gather the same rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

SEEDS = (0, 1, 7, 12345, 2**31 - 1)


def _jax_randint(seed, shape, lo, hi):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi, dtype=jnp.int32))


def test_prngkey_matches_jax():
    for seed in SEEDS:
        np.testing.assert_array_equal(
            prng.PRNGKey(seed).numpy(),
            np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))
    assert prng.PRNGKey(7).tolist() == [0, 7]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", (1, 64, 512, 4096))
def test_randint_matches_jax(seed, n):
    for hi in (1, 3, 16, 64, 1000):
        got = prng.randint(prng.PRNGKey(seed), (n,), 0, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_randint(seed, (n,), 0, hi),
                                      err_msg=f"seed={seed} n={n} hi={hi}")


@pytest.mark.parametrize("lo,hi", [(0, 70_000), (0, 2**31 - 1), (-5, 37),
                                   (10, 10), (2**31 - 8, 2**31 - 1)])
def test_randint_wide_and_degenerate_ranges(lo, hi):
    """Spans above 2**16 exercise the reference's uint32 wrap in the
    multiplier; an empty range returns ``lo`` as jax does."""
    for seed in (0, 12345):
        np.testing.assert_array_equal(
            prng.randint(prng.PRNGKey(seed), (257,), lo, hi).numpy(),
            _jax_randint(seed, (257,), lo, hi))


def test_randint_multidim_shape():
    shape = (3, 5, 7)       # (draws, ns, draw_size) as map_task draws
    np.testing.assert_array_equal(
        prng.randint(prng.PRNGKey(11), shape, 0, 96).numpy(),
        _jax_randint(11, shape, 0, 96))


def test_batched_seeds_match_reference_vmap():
    """The wave form: one key per task from int32 seeds, as in the
    reference's vmapped index derivation of the moments wave."""
    seeds = np.asarray([0, 1, 7, 12345, 2**31 - 1, 42, 5, 5], np.int32)
    n, ns = 64, 96
    ref = np.asarray(jax.vmap(
        lambda s: jax.random.randint(jax.random.PRNGKey(s), (n,), 0, ns,
                                     dtype=jnp.int32))(jnp.asarray(seeds)))
    got = prng.randint(prng.PRNGKey(torch.from_numpy(seeds)), (n,), 0, ns)
    assert tuple(got.shape) == (len(seeds), n)
    np.testing.assert_array_equal(got.numpy(), ref)
