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


# -- draws at chosen counters: what one thread of the CUDA kernels computes ---

# the (draws, ns, draw_size) of EAGLET, NETFLIX_HIGH and NETFLIX_LOW over the
# lengths their blocks are padded to, and spans that are not powers of two
# (65,537 has a multiplier of 0 all the same; 77, 1,000 and 3 do not)
WORKLOAD_SHAPES = [((30, 64, 256), 2 ** 21), ((8, 64, 2048), 2 ** 15),
                   ((8, 64, 32), 2 ** 14)]
ODD_SPANS = [((8, 4, 300), 77), ((8, 4, 300), 1000), ((8, 4, 300), 65537),
             ((8, 4, 300), 3)]


@pytest.mark.parametrize("shape,hi", WORKLOAD_SHAPES + ODD_SPANS)
@pytest.mark.parametrize("seed", [-1, -2**31, 2**31 - 1, 5])
def test_randint_at_random_counters_matches_flat_jax(shape, hi, seed):
    want = _jax_randint(seed, shape, 0, hi).reshape(-1)
    rng = np.random.default_rng(seed & 0xFFFF)
    counters = np.concatenate([rng.integers(0, want.size, 500),
                               [0, want.size - 1]])
    got = prng.randint_at(prng.PRNGKey(seed), torch.from_numpy(counters),
                          0, hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == counters.shape
    np.testing.assert_array_equal(got.numpy(), want[counters])


def test_randint_at_takes_a_batch_of_keys_and_any_counter_shape():
    seeds = torch.tensor([-3, 0, 9], dtype=torch.int32)
    counters = torch.tensor([[4, 0], [11, 7]])
    got = prng.randint_at(prng.PRNGKey(seeds), counters, -5, 37)
    assert tuple(got.shape) == (3, 2, 2)
    for b, seed in enumerate(seeds.tolist()):
        flat = _jax_randint(seed, (12,), -5, 37)
        np.testing.assert_array_equal(got[b].numpy(), flat[counters.numpy()])


def test_randint_is_randint_at_over_every_position():
    keys = prng.PRNGKey(torch.tensor([1, -7], dtype=torch.int32))
    assert torch.equal(
        prng.randint(keys, (3, 4, 5), 0, 1000),
        prng.randint_at(keys, torch.arange(60), 0, 1000).reshape(2, 3, 4, 5))


def test_multiplier_is_zero_for_every_power_of_two_span():
    for k in range(31):
        assert prng._randint_multiplier(0, 2 ** k) == (2 ** k, 0), k
    # 2**31 is no int32 bound; that span starts from a negative lo
    assert prng._randint_multiplier(-2 ** 30, 2 ** 30) == (2 ** 31, 0)
    assert prng._randint_multiplier(0, 65537)[1] == 0       # above 2**16
    assert [prng._randint_multiplier(0, s)[1] for s in (3, 77, 1000)] == \
        [1, 4, 296]


@pytest.mark.parametrize("span", [2, 64, 2048, 2 ** 15, 2 ** 16, 65537,
                                  2 ** 21, 2 ** 30])
def test_skipping_the_higher_draw_changes_no_bit(span):
    """Where the multiplier is 0, jax's full remainder combination over
    both draws gives the bits of the second draw alone."""
    keys = prng.PRNGKey(torch.tensor([0, -1, 2**31 - 1], dtype=torch.int32))
    counters = torch.arange(4096)
    _, multiplier = prng._randint_multiplier(0, span)
    assert multiplier == 0
    k1, k2 = prng.split(keys)
    higher, lower = prng._bits_at(k1, counters), prng._bits_at(k2, counters)
    full = ((((higher % span) * multiplier) & 0xFFFFFFFF)
            + (lower % span)) % span
    assert torch.equal(prng.randint_at(keys, counters, 0, span),
                       full.to(torch.int32))
