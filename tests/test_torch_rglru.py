"""The port's RG-LRU pieces against the reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
reference runs its Pallas kernel ``rglru_scan`` in interpret mode (its
default off-TPU) and its associative-scan oracle ``ref.linear_scan_ref``;
the port runs the kernel's plain version (the CUDA kernel itself is held
against that version on the card, exactly, by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``).

Tolerances:
- the scan against the reference's, alone or after the gates (the gated
  form): 1e-5 relative and absolute, the reference's own for its kernel
  (``tests/test_kernels.py``).  The plain version steps through S one
  rounded multiply and one rounded add at a time; the associative scan
  multiplies and adds in another association order, the Pallas kernel may
  fuse the multiply-add, and the two packages' exp, sigmoid and softplus
  may differ in the last place, so they agree to a few ulps of values of
  order 1, not bit for bit;
- the block in float32 against the reference's: 1e-4 relative and
  absolute; both compute the same fp32 formulas, but their matmuls add in
  other orders on values up to about 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import rglru_scan as ref_rglru
from repro.models import rglru as RGJ
from repro.parallel.sharding import is_param_def
from repro_torch.kernels import ops, ref
from repro_torch.models import rglru as RG
from tests.conftest import reduced

SCAN_TOL = 1e-5
MODULE_TOL = 1e-4


def _scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.99, (b, s, w)).astype(np.float32)
    bb = (0.5 * rng.standard_normal((b, s, w))).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("b,s,w,chunk,wb", [
    (2, 64, 128, 16, 64),
    (1, 128, 256, 64, 256),
    (3, 32, 64, 32, 32),
])
@pytest.mark.parametrize("form", ["plain", "ops"])
def test_scan_matches_reference_kernel_and_oracle(form, b, s, w, chunk, wb):
    arrays = _scan_inputs(b, s, w, seed=b + s + w)
    jx = [jnp.asarray(x) for x in arrays]
    tx = [torch.from_numpy(x) for x in arrays]
    if form == "plain":
        got = ref.linear_scan_ref(*tx)
    else:
        got = ops.rglru_scan(*tx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, w)
    kernel = ref_ops.rglru_scan(*jx, chunk=chunk, width_block=wb)
    oracle = ref_ref.linear_scan_ref(*jx)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)


@pytest.mark.parametrize("s,w", [(13, 100), (1, 7), (5, 64)])
def test_scan_takes_any_length_and_width(s, w):
    """The Pallas kernel needs S % chunk == 0 and W % width_block == 0;
    the port's takes any S >= 1 and any W (held against the oracle)."""
    arrays = _scan_inputs(2, s, w, seed=s * w)
    got = ops.rglru_scan(*[torch.from_numpy(x) for x in arrays])
    want = ref_ref.linear_scan_ref(*[jnp.asarray(x) for x in arrays])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_plain_scan_is_the_sequential_recurrence_bitwise():
    """Each step rounds a·h, then adds b: the same float32 operations as
    numpy step by step, so the two agree exactly (as the kernel must)."""
    a, bb, h0 = _scan_inputs(2, 17, 9, seed=4)
    got = ref.linear_scan_ref(*[torch.from_numpy(x) for x in (a, bb, h0)])
    h = h0.copy()
    for t in range(17):
        h = (a[:, t] * h).astype(np.float32) + bb[:, t]
        np.testing.assert_array_equal(got[:, t].numpy(), h)


@pytest.mark.parametrize("bad", ["shape", "h0_shape", "dtype", "strided",
                                 "empty"])
def test_scan_wrapper_rejects_inputs_it_cannot_take(bad):
    a, bb, h0 = (torch.from_numpy(x) for x in _scan_inputs(2, 8, 16, 0))
    if bad == "shape":
        bb = bb[:, :4]
    elif bad == "h0_shape":
        h0 = h0[:1]
    elif bad == "dtype":
        a = a.to(torch.bfloat16)
    elif bad == "strided":
        a = torch.cat([a, a], dim=-1)[..., :16]
    else:
        a, bb = a[:, :0], bb[:, :0]
    with pytest.raises((ValueError, TypeError)):
        ops.rglru_scan(a, bb, h0)


def test_cpu_scan_counts_no_launch():
    ops.reset_launch_count()
    ops.rglru_scan(*(torch.from_numpy(x) for x in _scan_inputs(1, 4, 8, 0)))
    assert all(ops.launch_count(name) == 0 for name in ops.KERNELS)


# -- the gated form: the gates and the scan in one op -------------------------


def _gated_inputs(b, s, w, u_dtype, gate_dtype, seed, lam_mean=1.0):
    """numpy u, the four gate vectors, Λ and h0, away from the degenerate
    inits (Λ far below 0 makes softplus(Λ) tiny, a round to 1 and the clamp
    of 1 − a² bind), with torch tensors of them in the given types."""
    rng = np.random.default_rng(seed)
    arrays = {
        "u": 2.0 * rng.standard_normal((b, s, w)),
        "gate_a_w": 1.0 + 0.3 * rng.standard_normal(w),
        "gate_a_b": 0.2 * rng.standard_normal(w),
        "gate_x_w": 1.0 + 0.3 * rng.standard_normal(w),
        "gate_x_b": 0.2 * rng.standard_normal(w),
        "lam": lam_mean + 0.3 * rng.standard_normal(w),
        "h0": rng.standard_normal((b, w)),
    }
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    dtypes = {"u": u_dtype, "lam": torch.float32, "h0": torch.float32}
    tx = {k: torch.from_numpy(v).to(dtypes.get(k, gate_dtype))
          for k, v in arrays.items()}
    return arrays, tx


def _gated_args(tx):
    sp = torch.nn.functional.softplus(tx["lam"].float())
    return (tx["u"], tx["gate_a_w"], tx["gate_a_b"], tx["gate_x_w"],
            tx["gate_x_b"], sp, tx["h0"])


GATED_SHAPES = [(1, 1, 7), (2, 5, 64), (2, 13, 100), (1, 64, 100),
                (2, 64, 7)]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("b,s,w", GATED_SHAPES)
@pytest.mark.parametrize("u_dtype", ["fp32", "bf16"])
def test_gated_scan_is_the_models_gates_then_the_scan_bitwise(u_dtype, b, s,
                                                              w):
    """On CPU tensors the op runs its plain version: the model's ``_gates``
    as torch ops, then ``ops.rglru_scan``, bit for bit (the card's kernel
    is held to the same ops on the card by ``tests/test_torch_cuda.py``)."""
    dtype = DTYPES[u_dtype]
    _, tx = _gated_inputs(b, s, w, dtype, dtype, seed=b * s * w)
    params = {k: v for k, v in tx.items() if k not in ("u", "h0")}
    a, gated = RG._gates(params, tx["u"])
    want = ops.rglru_scan(a, gated, tx["h0"])
    got = ops.rglru_gated_scan(*_gated_args(tx))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,s,w,lam_mean", [(b, s, w, 1.0)
                                            for b, s, w in GATED_SHAPES]
                         + [(2, 13, 100, -20.0)])
@pytest.mark.parametrize("u_dtype", ["fp32", "bf16"])
def test_gated_scan_matches_reference_gates_and_kernel(u_dtype, b, s, w,
                                                       lam_mean):
    """The reference's ``_gates`` (jnp) then its Pallas ``rglru_scan`` in
    interpret mode (one chunk of S and one width block of W, shapes it
    takes), on the same numpy inputs: allclose at ``SCAN_TOL``.  The two
    packages' exp, sigmoid and softplus may differ in the last place, and
    the Pallas kernel may fuse the scan's multiply-add."""
    dtype = DTYPES[u_dtype]
    arrays, tx = _gated_inputs(b, s, w, dtype, dtype, seed=s + w,
                               lam_mean=lam_mean)
    jdtype = jnp.bfloat16 if u_dtype == "bf16" else jnp.float32
    jparams = {k: jnp.asarray(v, jdtype) for k, v in arrays.items()
               if k.startswith("gate_")}
    jparams["lam"] = jnp.asarray(arrays["lam"])
    a, gated = RGJ._gates(jparams, jnp.asarray(arrays["u"], jdtype))
    want = ref_rglru.rglru_scan(a, gated, jnp.asarray(arrays["h0"]),
                                chunk=s, width_block=w, interpret=True)
    got = ops.rglru_gated_scan(*_gated_args(tx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


@pytest.mark.parametrize("bad", ["u_shape", "gate_shape", "h0_shape",
                                 "u_dtype", "gate_dtypes", "sp_dtype",
                                 "h0_dtype", "strided", "empty", "device"])
def test_gated_scan_rejects_inputs_it_cannot_take(bad):
    _, tx = _gated_inputs(2, 8, 16, torch.bfloat16, torch.bfloat16, 0)
    args = list(_gated_args(tx))
    if bad == "u_shape":
        args[0] = args[0][0]
    elif bad == "gate_shape":
        args[1] = args[1][:8]
    elif bad == "h0_shape":
        args[6] = args[6][:1]
    elif bad == "u_dtype":
        args[0] = args[0].to(torch.float16)
    elif bad == "gate_dtypes":
        args[3] = args[3].float()
    elif bad == "sp_dtype":
        args[5] = args[5].to(torch.bfloat16)
    elif bad == "h0_dtype":
        args[6] = args[6].double()
    elif bad == "strided":
        args[0] = torch.cat([args[0], args[0]], dim=-1)[..., :16]
    elif bad == "empty":
        args[0] = args[0][:, :0]
    else:
        args[6] = args[6].to("meta")
    with pytest.raises((ValueError, TypeError)):
        ops.rglru_gated_scan(*args)


def test_cpu_gated_scan_counts_no_launch():
    _, tx = _gated_inputs(1, 4, 8, torch.float32, torch.float32, 0)
    ops.reset_launch_count()
    ops.rglru_gated_scan(*_gated_args(tx))
    assert all(ops.launch_count(name) == 0 for name in ops.KERNELS)


# -- the RG-LRU block ---------------------------------------------------------


def _cfg():
    return reduced("recurrentgemma-2b", dtype="float32")


def _numpy_tree(defs, seed):
    """Random numpy leaves for a reference ParamDef tree, away from the
    degenerate inits: gate weights and Λ near 1, biases and the conv bias
    small, matrices and conv taps scaled by their fan-in."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        if p.init == "ones":
            a = 1.0 + 0.3 * rng.standard_normal(p.shape)
        elif p.init == "zeros":
            a = 0.2 * rng.standard_normal(p.shape)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, defs, is_leaf=is_param_def)


def _check(got, want):
    out, state = got
    want_out, want_state = want
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    assert sorted(state) == sorted(want_state)
    for key in state:
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(want_state[key]),
                                   rtol=MODULE_TOL, atol=MODULE_TOL,
                                   err_msg=key)


def _block_inputs(cfg, b, s, seed):
    params = _numpy_tree(RGJ.rglru_defs(cfg), seed)
    state = _numpy_tree(RGJ.rglru_state_defs(cfg, b), seed + 1)
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    to_jax = lambda t: jax.tree.map(jnp.asarray, t)
    to_torch = lambda t: jax.tree.map(torch.from_numpy, t)
    return ((to_jax(params), jnp.asarray(x), to_jax(state)),
            (to_torch(params), torch.from_numpy(x), to_torch(state)))


@pytest.mark.parametrize("s", [16, 13, 5])
def test_rglru_apply_matches_reference(s):
    cfg = _cfg()
    jx, tx = _block_inputs(cfg, 2, s, seed=s)
    _check(RG.rglru_apply(cfg, *tx), RGJ.rglru_apply(cfg, *jx))


def test_rglru_decode_matches_reference():
    cfg = _cfg()
    jx, tx = _block_inputs(cfg, 3, 1, seed=7)
    _check(RG.rglru_decode(cfg, *tx), RGJ.rglru_decode(cfg, *jx))


def test_rglru_decode_continues_the_prefill():
    """The state a prefill hands on carries the recurrence and the conv
    window: prefill(S) then one decode step equals prefill(S + 1)'s last
    position and state."""
    cfg = _cfg()
    _, (params, x, state) = _block_inputs(cfg, 2, 12, seed=9)
    whole, whole_state = RG.rglru_apply(cfg, params, x, state)
    _, mid = RG.rglru_apply(cfg, params, x[:, :11], state)
    step, step_state = RG.rglru_decode(cfg, params, x[:, 11:], mid)
    np.testing.assert_allclose(step.numpy(), whole[:, 11:].numpy(),
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    for key in whole_state:
        np.testing.assert_allclose(step_state[key].numpy(),
                                   whole_state[key].numpy(),
                                   rtol=MODULE_TOL, atol=MODULE_TOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    got = RG._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf).max() > 1e-4
