"""The port's collectives over a mesh's entries
(``repro_torch.parallel.collectives``) on the CPU, against numpy and the
reference's collectives under ``shard_map``.

``ring_all_reduce`` and ``reduce_scatter`` run at 1 to 8 CPU entries (the
port's emulated mesh, repeated ``cpu`` entries); each must be ``allclose``
to the numpy sum (rtol 1e-5, atol 1e-5: fp32 sums of 8 standard normals
in another order) and equal, bit for bit, a numpy emulation of the
reference's ring written from its chunk indices
(``src/repro/parallel/collectives.py:45-56``): the same fp32 additions
in the same order.  At one entry each equals the reference's under
``shard_map`` on the local device, as the reference's own tests run it
(a forced multi-device jax would need a child process).
``compressed_psum`` must stay within the reference's bound: half of
each entry's largest row scale, summed over the entries (one
quantization step an entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.parallel import collectives as ref_col
from repro.parallel.compression import quantize_int8 as ref_quantize
from repro_torch.launch.mesh import make_wave_mesh
from repro_torch.parallel.collectives import (compressed_psum,
                                              reduce_scatter,
                                              ring_all_reduce)
from repro_torch.parallel.compression import quantize_int8

ENTRIES = tuple(range(1, 9))

try:
    from jax import shard_map
except ImportError:           # renamed from jax.experimental < 0.7
    from jax.experimental.shard_map import shard_map


def _local_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1), ("data",))


def _shards(n, rows_per_entry=3, cols=5, seed=0):
    rng = np.random.default_rng(seed + n)
    return [rng.normal(size=(n * rows_per_entry, cols)).astype(np.float32)
            for _ in range(n)]


def _ring_emulation(xs, shift=0, gather=True):
    """The reference's ring in numpy: at reduce-scatter step k device j
    adds to its chunk (j − k − 1 + shift) % n what device j − 1 holds
    there; at all-gather step k it takes chunk (j − k) % n from j − 1.
    Every device's receive is read before any write of the step."""
    n = len(xs)
    chunks = [list(np.split(x.copy(), n)) for x in xs]
    for k in range(n - 1):
        idx = [(j - k - 1 + shift) % n for j in range(n)]
        recv = [chunks[(j - 1) % n][idx[j]].copy() for j in range(n)]
        for j in range(n):
            chunks[j][idx[j]] = chunks[j][idx[j]] + recv[j]
    if not gather:
        return chunks
    for k in range(n - 1):
        idx = [(j - k) % n for j in range(n)]
        recv = [chunks[(j - 1) % n][idx[j]].copy() for j in range(n)]
        for j in range(n):
            chunks[j][idx[j]] = recv[j]
    return [np.concatenate(c) for c in chunks]


def _on_mesh(xs):
    mesh = make_wave_mesh(len(xs), "cpu")
    return [torch.from_numpy(x).to(d) for x, d in zip(xs, mesh.devices)]


@pytest.mark.parametrize("n", ENTRIES)
def test_ring_all_reduce_is_the_references_ring(n):
    xs = _shards(n)
    before = [x.copy() for x in xs]
    out = ring_all_reduce(_on_mesh(xs))
    total = np.sum(np.stack(xs).astype(np.float64), axis=0)
    want = _ring_emulation(xs)
    assert len(out) == n
    for i, got in enumerate(out):
        np.testing.assert_allclose(got.numpy(), total, rtol=1e-5, atol=1e-5)
        assert np.array_equal(got.numpy(), want[i]), f"entry {i}"
        assert np.array_equal(got.numpy(), out[0].numpy())
    for x, b in zip(xs, before):
        assert np.array_equal(x, b), "a shard was changed"


@pytest.mark.parametrize("n", ENTRIES)
def test_reduce_scatter_gives_each_entry_its_slice(n):
    xs = _shards(n)
    out = reduce_scatter(_on_mesh(xs))
    total = np.sum(np.stack(xs).astype(np.float64), axis=0)
    want = _ring_emulation(xs, shift=-1, gather=False)
    rows = xs[0].shape[0] // n
    for i, got in enumerate(out):
        np.testing.assert_allclose(got.numpy(),
                                   total[i * rows:(i + 1) * rows],
                                   rtol=1e-5, atol=1e-5)
        assert np.array_equal(got.numpy(), want[i][i]), f"entry {i}"


def test_ring_all_reduce_matches_psum_single_device():
    """The reference's own test, and the port's one entry against the
    reference's ring under ``shard_map``."""
    mesh = _local_mesh()
    x = jnp.arange(16.0).reshape(4, 4)
    f = shard_map(lambda v: ref_col.ring_all_reduce(v, "data"), mesh=mesh,
                  in_specs=P("data"), out_specs=P("data"))
    ref = np.asarray(f(x))
    np.testing.assert_allclose(ref, np.asarray(x))
    (got,) = ring_all_reduce([torch.arange(16.0).reshape(4, 4)])
    assert np.array_equal(got.numpy(), ref)


def test_reduce_scatter_single_device_equals_the_references():
    mesh = _local_mesh()
    x = _shards(1, rows_per_entry=4)[0]
    f = shard_map(lambda v: ref_col.reduce_scatter(v, "data"), mesh=mesh,
                  in_specs=P(), out_specs=P("data"))
    (got,) = reduce_scatter([torch.from_numpy(x)])
    assert np.array_equal(got.numpy(), np.asarray(f(jnp.asarray(x))))


def test_compressed_psum_error_bounded():
    """The reference's test at one device, and the port's one entry equal
    to the reference's result."""
    mesh = _local_mesh()
    x = jax.random.normal(jax.random.PRNGKey(0), (8, 32))
    f = shard_map(lambda v: ref_col.compressed_psum(v, "data"), mesh=mesh,
                  in_specs=P(), out_specs=P())
    out = f(x)
    _, scale = ref_quantize(x)
    bound = float(jnp.max(scale)) / 2 + 1e-7
    assert float(jnp.max(jnp.abs(out - x))) <= bound
    (got,) = compressed_psum([torch.from_numpy(np.asarray(x))])
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n", ENTRIES)
def test_compressed_psum_within_one_step_an_entry(n):
    xs = _shards(n, rows_per_entry=2, cols=32, seed=3)
    out = compressed_psum(_on_mesh(xs))
    total = np.sum(np.stack(xs).astype(np.float64), axis=0)
    bound = sum(float(quantize_int8(torch.from_numpy(x))[1].max()) / 2
                for x in xs) + 1e-6 * n
    for got in out:
        assert np.max(np.abs(got.numpy() - total)) <= bound
        assert np.array_equal(got.numpy(), out[0].numpy())


def test_a_leading_axis_that_does_not_split_raises():
    with pytest.raises(ValueError, match="does not split"):
        ring_all_reduce([torch.zeros(3, 2), torch.zeros(3, 2)])
