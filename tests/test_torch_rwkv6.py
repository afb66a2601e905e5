"""The port's RWKV6 pieces against the reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
reference runs its Pallas kernel ``rwkv6_chunked`` in interpret mode (its
default off-TPU) and its pure-jnp oracles; the port runs the kernel's
plain versions (the CUDA kernel itself is held against them on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances:
- plain versions against the reference kernel and oracle: the reference's
  own (``tests/test_kernels.py``): 2e-3 in fp32, where the chunked closed
  form and the sequential scan add in different orders, and 5e-2 with
  bf16 inputs;
- the chunk form with a carried state against the reference's
  ``chunk_body``: 1e-4, as the reference holds its kernel to it;
- the kernel's two-pass arithmetic (``ref.rwkv6_two_pass_ref``) against
  the chunk form: 1e-4; both form the same log-decay sums, and only the
  factored sub-chunk blocks and the order of the sums differ;
- the model's modules in float32 against the reference's: 1e-4 relative
  and absolute; both sides compute the same fp32 formulas on the CPU, but
  their products and sums (einsums, matmuls) add in other orders, on
  values up to about 10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import rwkv6 as RWJ
from repro.parallel.sharding import is_param_def
from repro_torch.kernels import ops, ref
from repro_torch.models import rwkv6 as RW
from tests.conftest import reduced

KERNEL_SHAPES = [(1, 2, 64, 16, 16), (2, 1, 128, 32, 32), (1, 4, 64, 64, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODULE_TOL = 1e-4


def _kernel_inputs(b, h, s, hd, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, hd)).astype(np.float32)
               for _ in range(3))
    # realistic decays: logw in [-2.5, -0.05]
    logw = (-0.05 - 2.45 * rng.random((b, h, s, hd))).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, hd))).astype(np.float32)
    return r, k, v, logw, u


def _both(arrays, dtype):
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@functools.lru_cache(maxsize=None)
def _reference_outputs(shape, dtype):
    """The reference kernel (interpret mode) and its sequential oracle."""
    *bhsd, chunk = shape
    jx, _ = _both(_kernel_inputs(*bhsd, seed=sum(shape)), dtype)
    kernel = ref_ops.rwkv6_chunked(*jx, chunk=chunk)
    oracle = ref_ref.rwkv6_chunked_ref(*jx)
    return np.asarray(kernel), np.asarray(oracle)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("form", ["sequential", "chunk_form", "ops",
                                  "two_pass"])
def test_plain_versions_match_reference(form, shape, dtype):
    *bhsd, chunk = shape
    b, h, _, hd = bhsd
    _, tx = _both(_kernel_inputs(*bhsd, seed=sum(shape)), dtype)
    zero = torch.zeros((b, h, hd, hd))
    if form == "sequential":
        got = ref.rwkv6_chunked_ref(*tx)
    elif form == "chunk_form":
        got, _ = ref.rwkv6_chunk_form_ref(*tx, zero, chunk)
    elif form == "two_pass":
        got, _ = ref.rwkv6_two_pass_ref(*tx, zero, chunk)
    else:
        got, _ = ops.rwkv6_chunked(*tx, chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(bhsd)
    tol = 5e-2 if dtype == "bfloat16" else 2e-3
    for want in _reference_outputs(shape, dtype):
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def _chunk_body_chain(jx, state, chunk):
    """The reference's ``chunk_body`` chunk after chunk from ``state``."""
    outs = []
    for c0 in range(0, jx[0].shape[2], chunk):
        part = [t[:, :, c0:c0 + chunk] for t in jx[:4]]
        out, state = RWJ.chunk_body(*part, jx[4], state)
        outs.append(out)
    return np.concatenate([np.asarray(o) for o in outs], 2), np.asarray(state)


@pytest.mark.parametrize("s,chunk", [(64, 64), (64, 16), (40, 8), (13, 13)])
def test_chunk_form_with_state_matches_reference_chunk_body(s, chunk):
    b, h, hd = 2, 2, 32
    arrays = _kernel_inputs(b, h, s, hd, seed=s + chunk)
    state = (0.5 * np.random.default_rng(s).standard_normal(
        (b, h, hd, hd))).astype(np.float32)
    jx, tx = _both(arrays, "float32")
    want_out, want_state = _chunk_body_chain(jx, jnp.asarray(state), chunk)
    for got_out, got_state in (
            ref.rwkv6_chunk_form_ref(*tx, torch.from_numpy(state), chunk),
            ops.rwkv6_chunked(*tx, chunk=chunk,
                              state=torch.from_numpy(state))):
        np.testing.assert_allclose(got_out.numpy(), want_out, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got_state.numpy(), want_state,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(64, 64), (64, 16), (40, 8), (13, 13)])
def test_two_pass_with_state_matches_reference_chunk_body(s, chunk):
    b, h, hd = 2, 2, 32
    arrays = _kernel_inputs(b, h, s, hd, seed=s + chunk + 1)
    state = (0.5 * np.random.default_rng(s + 1).standard_normal(
        (b, h, hd, hd))).astype(np.float32)
    jx, tx = _both(arrays, "float32")
    want_out, want_state = _chunk_body_chain(jx, jnp.asarray(state), chunk)
    got_out, got_state = ref.rwkv6_two_pass_ref(*tx, torch.from_numpy(state),
                                                chunk)
    np.testing.assert_allclose(got_out.numpy(), want_out, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_state.numpy(), want_state, rtol=1e-4,
                               atol=1e-4)


def _with_state(b, h, s, hd, seed, dtype="float32", span=2.45):
    """Kernel inputs with decays in [-0.05 - span, -0.05] and a carried
    state, as torch tensors."""
    r, k, v, logw, u = _kernel_inputs(b, h, s, hd, seed)
    rng = np.random.default_rng(seed + 1)
    logw = (-0.05 - span * rng.random((b, h, s, hd))).astype(np.float32)
    state = (0.5 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    _, tx = _both((r, k, v, logw, u), dtype)
    return tx + [torch.from_numpy(state)]


# chunks of 13 and 7 leave a ragged sub-chunk; sub-chunks of 4 and 6 put
# factored blocks beside ragged ones
@pytest.mark.parametrize("chunk,sub", [(64, 16), (16, 16), (13, 16), (7, 16),
                                       (13, 4), (7, 6), (64, 8)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_two_pass_matches_chunk_form(chunk, sub, dtype):
    x = _with_state(2, 2, 4 * chunk, 32, seed=chunk + sub, dtype=dtype)
    want_out, want_state = ref.rwkv6_chunk_form_ref(*x, chunk)
    got_out, got_state = ref.rwkv6_two_pass_ref(*x, chunk, sub=sub)
    torch.testing.assert_close(got_out, want_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_state, want_state, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [64, 13])
def test_two_pass_at_extreme_decays_is_finite_and_matches_chunk_form(chunk):
    """logw down to -40 a token: the log-decay sums reach -2,560 over a
    chunk of 64 and most factors underflow; no exponent may overflow."""
    x = _with_state(2, 2, 3 * chunk, 32, seed=chunk, span=39.95)
    want_out, want_state = ref.rwkv6_chunk_form_ref(*x, chunk)
    got_out, got_state = ref.rwkv6_two_pass_ref(*x, chunk)
    for t in (got_out, got_state, want_out, want_state):
        assert bool(torch.isfinite(t).all())
    torch.testing.assert_close(got_out, want_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got_state, want_state, rtol=1e-4, atol=1e-4)


def test_chunk_body_matches_reference_chunk_body():
    arrays = _kernel_inputs(1, 2, 16, 16, seed=11)
    state = np.random.default_rng(1).standard_normal(
        (1, 2, 16, 16)).astype(np.float32)
    jx, tx = _both(arrays, "float32")
    want = RWJ.chunk_body(*jx, jnp.asarray(state))
    got = ref.chunk_body(*tx, torch.from_numpy(state))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_chunk_form_from_zero_equals_sequential_recurrence():
    _, tx = _both(_kernel_inputs(2, 3, 48, 16, seed=5), "float32")
    chunked, final = ref.rwkv6_chunk_form_ref(
        *tx, torch.zeros((2, 3, 16, 16)), 16)
    np.testing.assert_allclose(chunked.numpy(),
                               ref.rwkv6_chunked_ref(*tx).numpy(),
                               rtol=2e-3, atol=2e-3)
    # the final state carries on: two halves equal the whole
    first, mid = ref.rwkv6_chunk_form_ref(
        *[t[:, :, :32] for t in tx[:4]], tx[4], torch.zeros((2, 3, 16, 16)),
        16)
    second, end = ref.rwkv6_chunk_form_ref(
        *[t[:, :, 32:] for t in tx[:4]], tx[4], mid, 16)
    np.testing.assert_allclose(torch.cat([first, second], 2).numpy(),
                               chunked.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(end.numpy(), final.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bad", ["chunk", "u_shape", "dtype_mix", "state"])
def test_wrapper_rejects_inputs_it_cannot_take(bad):
    _, (r, k, v, logw, u) = _both(_kernel_inputs(1, 2, 24, 16, seed=0),
                                  "float32")
    kwargs = {"chunk": 8}
    if bad == "chunk":
        kwargs["chunk"] = 7                     # does not divide S = 24
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    else:
        kwargs["state"] = torch.zeros((1, 2, 16, 16), dtype=torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        ops.rwkv6_chunked(r, k, v, logw, u, **kwargs)


def test_cpu_tensors_do_not_count_as_launches():
    ops.reset_launch_count()
    _, tx = _both(_kernel_inputs(1, 1, 8, 16, seed=0), "float32")
    ops.rwkv6_chunked(*tx, chunk=8)
    assert ops.launch_count("rwkv6_chunked") == 0
    assert ops.launch_count() == ops.launch_count("subsample_stats") == 0


# -- the model's RWKV6 modules ---------------------------------------------


def _module_cfg():
    return reduced("rwkv6-7b", rwkv_head_dim=16, dtype="float32")


def _numpy_tree(defs, seed):
    """Random numpy leaves for a reference ParamDef tree, every leaf away
    from its degenerate init (mixes in (0, 1), a decay bias below 0,
    norms near 1) so that each formula is exercised."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = jax.tree_util.keystr(path)
        if "mix" in name and p.init == "zeros":
            a = rng.random(p.shape)
        elif "decay_bias" in name:
            a = -1.0 + 0.5 * rng.standard_normal(p.shape)
        elif p.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:                       # matrices: 1 / sqrt(fan-in)
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, defs, is_leaf=is_param_def)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _assert_trees_close(got, want, tol=MODULE_TOL):
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w, np.float32), rtol=tol, atol=tol,
            err_msg=jax.tree_util.keystr(path))


def _state(cfg, b, seed):
    return _numpy_tree(RWJ.state_defs(cfg, b), seed)


@pytest.mark.parametrize("s", [32, 13, 5])
def test_time_mix_apply_matches_reference(s):
    cfg = _module_cfg()
    params = _numpy_tree(RWJ.time_mix_defs(cfg), seed=s)
    state = _state(cfg, 2, seed=s + 1)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want = RWJ.time_mix_apply(cfg, _to_jax(params), jnp.asarray(x),
                              _to_jax(state))
    got = RW.time_mix_apply(cfg, _to_torch(params), torch.from_numpy(x),
                            _to_torch(state))
    _assert_trees_close([got[0].numpy(), {k: t.numpy()
                                          for k, t in got[1].items()}],
                        [want[0], want[1]])


def test_time_mix_decode_matches_reference():
    cfg = _module_cfg()
    params = _numpy_tree(RWJ.time_mix_defs(cfg), seed=3)
    state = _state(cfg, 3, seed=4)
    x = np.random.default_rng(5).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    want = RWJ.time_mix_decode(cfg, _to_jax(params), jnp.asarray(x),
                               _to_jax(state))
    got = RW.time_mix_decode(cfg, _to_torch(params), torch.from_numpy(x),
                             _to_torch(state))
    _assert_trees_close([got[0].numpy(), {k: t.numpy()
                                          for k, t in got[1].items()}],
                        [want[0], want[1]])


@pytest.mark.parametrize("decode", [False, True])
def test_channel_mix_apply_matches_reference(decode):
    cfg = _module_cfg()
    params = _numpy_tree(RWJ.channel_mix_defs(cfg), seed=6)
    state = _state(cfg, 2, seed=7)
    s = 1 if decode else 11
    x = np.random.default_rng(8).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want = RWJ.channel_mix_apply(cfg, _to_jax(params), jnp.asarray(x),
                                 _to_jax(state), decode)
    got = RW.channel_mix_apply(cfg, _to_torch(params), torch.from_numpy(x),
                               _to_torch(state), decode)
    _assert_trees_close([got[0].numpy(), {k: t.numpy()
                                          for k, t in got[1].items()}],
                        [want[0], want[1]])
