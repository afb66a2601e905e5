"""Training the recurrent models on the CPU: the plain backwards of
``rwkv6_chunked``, ``rglru_scan`` and ``rglru_gated_scan``, the ``ops``
Functions that take them, and ``rwkv6-7b`` and ``recurrentgemma-2b``
trained against the JAX reference.  Inputs are made with numpy from a seed
and handed to both sides.  Tolerances:

* ``rwkv6_chunked_bwd_ref`` against autograd through
  ``rwkv6_chunk_form_ref`` (the same fp32 log-decay sums feed both): 1e-5
  of each leaf's largest entry, fp32 inputs, decays to −2 and to −40 a
  token; bf16 inputs give bf16 gradients, each one rounding of an fp32
  value within 1e-5 of autograd's on the widened inputs: within one bf16
  step of it (at most 2^-7 of the entry).
* the same against ``jax.vjp`` of a ``lax.scan`` of the reference's
  ``chunk_body``: 1e-5 of each leaf's largest, in fp32 at decays to −2; at
  decays to −40 both sides run in float64.  In fp32 the log-decay sums of
  a chunk reach −40 C, and their rounding (ulps of up to 320 at C = 8)
  moves a pairwise decay e^{logP_i − logP_{j+1}} near 1 by ~1e-5: at C =
  8 dk parts from the fp32 reference by 1.2e-5 of its largest entry, so
  it is not dlogw alone that needs float64 to hold 1e-5.
* ``rglru_scan_bwd_ref`` and ``rglru_gated_scan_bwd_ref`` against autograd
  through their forwards and against ``jax.vjp`` of the reference's
  associative scan (and ``_gates``): 1e-5.
* the ``ops`` Functions' CPU backwards against the plain backwards: bit for
  bit (the same function on the same tensors).
* three ``train()`` steps of reduced ``rwkv6-7b`` and ``recurrentgemma-2b``
  against the reference: losses within 1e-4, as the dense model's.
* ``Model.loss`` and every gradient leaf of both against
  ``jax.value_and_grad`` at remat full, dots and none are in
  ``tests/test_torch_train.py::test_loss_and_gradients_match_reference``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.models.model import Model as RefModel
from repro.train import loop as ref_loop
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models.convert import train_state_from_jax
from repro_torch.train import loop
from tests.test_torch_train import TOL, _cfg, _pipe, _runs

BWD_TOL = 1e-5


def _rel_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).double())
    want = np.asarray(torch.as_tensor(want).double())
    scale = max(float(np.max(np.abs(want))), 1e-30)
    return float(np.max(np.abs(got - want))) / scale


def _close(got, want, what, dtype=torch.float32):
    """Within BWD_TOL of the leaf's largest entry; a bf16 gradient also
    within one bf16 step of each entry (at most 2^-7 of it)."""
    err = _rel_err(got, want)
    if dtype == torch.bfloat16:
        g, w = (torch.as_tensor(t).double() for t in (got, want))
        scale = float(w.abs().max())
        bad = (g - w).abs() > BWD_TOL * scale + 2.0 ** -7 * w.abs()
        assert not bool(bad.any()), f"{what}: {int(bad.sum())} entries off"
    else:
        assert err <= BWD_TOL, f"{what}: relative error {err} > {BWD_TOL}"


# ---------------------------------------------------------------------------
# rwkv6_chunked
# ---------------------------------------------------------------------------


def _rwkv6_numpy(b, h, s, hd, span, seed):
    """r, k, v, logw, u, state0, dout, dstate_out (float32 numpy), log
    decays in (−span, 0]."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, hd)).astype(np.float32)
               for _ in range(3))
    logw = (-span * rng.random((b, h, s, hd))).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    state0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    dout = rng.standard_normal((b, h, s, hd)).astype(np.float32)
    dstate = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, state0, dout, dstate


def _rwkv6_bwd(arrays, chunk, dtype):
    """The plain backward on the forward's own states."""
    r, k, v, logw, u, state0, dout, dstate = (torch.from_numpy(a)
                                              for a in arrays)
    r, k, v, u = (t.to(dtype) for t in (r, k, v, u))
    _, state_out, states = ref.rwkv6_chunk_form_ref(
        r, k, v, logw, u, state0, chunk, with_states=True)
    return ref.rwkv6_chunked_bwd_ref(r, k, v, logw, u, state0, states,
                                     state_out, dout, dstate, chunk)


RW_CASES = [  # chunk, dtype, span
    (4, torch.float32, 2.0), (8, torch.float32, 2.0),
    (4, torch.float32, 40.0), (8, torch.float32, 40.0),
    (8, torch.bfloat16, 2.0), (4, torch.bfloat16, 40.0),
]
RW_NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")


@pytest.mark.parametrize("chunk,dtype,span", RW_CASES)
def test_rwkv6_bwd_ref_matches_autograd(chunk, dtype, span):
    arrays = _rwkv6_numpy(2, 3, 24, 8, span, seed=chunk + int(span))
    got = _rwkv6_bwd(arrays, chunk, dtype)
    r, k, v, logw, u, state0, dout, dstate = (torch.from_numpy(a)
                                              for a in arrays)
    # autograd on the widened values: with bf16 leaves it would round u's
    # gradient to bf16 once a chunk and add those roundings
    leaves = [t.to(dtype).float().requires_grad_() for t in (r, k, v)] + [
        logw.requires_grad_(), u.to(dtype).float().requires_grad_(),
        state0.requires_grad_()]
    out, state_out = ref.rwkv6_chunk_form_ref(*leaves, chunk)
    want = torch.autograd.grad((out, state_out), leaves, (dout, dstate))
    for name, g, w in zip(RW_NAMES, got, want):
        assert g.dtype == (dtype if name in ("dr", "dk", "dv", "du")
                           else torch.float32)
        assert g.shape == w.shape
        _close(g, w, f"{name} at chunk {chunk}, {dtype}, span {span}",
               g.dtype)
        assert float(w.abs().max()) > 0


def _jax_chunked(r, k, v, logw, u, state0, chunk):
    """The reference's recurrence: ``chunk_body`` under ``lax.scan``."""
    b, h, s, hd = r.shape
    n = s // chunk

    def chunks(t):      # [B, H, S, hd] -> [n, B, H, C, hd]
        return jnp.moveaxis(t.reshape(b, h, n, chunk, hd), 2, 0)

    def body(state, xs):
        out, state = jrwkv6.chunk_body(*xs, u, state)
        return state, out

    final, outs = jax.lax.scan(body, state0, tuple(chunks(t) for t in
                                                   (r, k, v, logw)))
    return jnp.moveaxis(outs, 0, 2).reshape(b, h, s, hd), final


@pytest.mark.parametrize("chunk,span", [(4, 2.0), (8, 2.0), (4, 40.0),
                                        (8, 40.0)])
def test_rwkv6_bwd_ref_matches_jax_grad(chunk, span):
    arrays = _rwkv6_numpy(2, 2, 16, 8, span, seed=10 + chunk)
    wide = span > 2.0                    # see the module's docstring
    np_dtype = np.float64 if wide else np.float32
    with jax.enable_x64(wide):
        jin = [jnp.asarray(a.astype(np_dtype)) for a in arrays]
        _, vjp = jax.vjp(lambda *a: _jax_chunked(*a, chunk), *jin[:6])
        want = vjp((jin[6], jin[7]))
        want = [np.asarray(w) for w in want]
    torch_in = [torch.from_numpy(a.astype(np_dtype)) for a in arrays]
    r, k, v, logw, u, state0, dout, dstate = torch_in
    if wide:
        # the forward's states in float64 too, chunk by chunk
        states, st = [], state0
        for c0 in range(0, r.shape[2], chunk):
            if c0:
                states.append(st)
            part = slice(c0, c0 + chunk)
            st = _chunk_state_f64(k[:, :, part], v[:, :, part],
                                  logw[:, :, part], st)
        states = torch.stack(states, dim=2)
        got = ref.rwkv6_chunked_bwd_ref(r, k, v, logw, u, state0, states, st,
                                        dout, dstate, chunk)
    else:
        got = _rwkv6_bwd(arrays, chunk, torch.float32)
    for name, g, w in zip(RW_NAMES, got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, f"{name} at chunk {chunk}, span {span}")


def _chunk_state_f64(k, v, logw, state):
    """The state leaving a chunk, in float64: ``e^{logP_C} ⊙ S + (k ⊙
    e^{logP_C − logP_{j+1}})ᵀ v``."""
    lq = torch.cumsum(logw, dim=2)
    total = lq[:, :, -1]
    kdec = k * torch.exp(total[:, :, None] - lq)
    return (torch.exp(total)[..., None] * state
            + torch.einsum("bhjd,bhje->bhde", kdec, v))


def test_rwkv6_function_backward_is_the_plain_backward():
    """``ops.rwkv6_chunked`` with grad on takes its Function on the CPU:
    the forward's own states in, the plain backward out, no launch."""
    arrays = _rwkv6_numpy(1, 2, 16, 8, 2.0, seed=3)
    r, k, v, logw, u, state0, dout, dstate = (torch.from_numpy(a)
                                              for a in arrays)
    leaves = [t.clone().requires_grad_() for t in (r, k, v, logw, u, state0)]
    ops.reset_launch_count()
    out, state_out = ops.rwkv6_chunked(*leaves[:5], chunk=8, state=leaves[5])
    got = torch.autograd.grad((out, state_out), leaves, (dout, dstate))
    want = _rwkv6_bwd(arrays, 8, torch.float32)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(ops.launch_count(n) == 0 for n in ops.KERNELS)
    with torch.no_grad():
        plain = ops.rwkv6_chunked(*leaves[:5], chunk=8, state=leaves[5])
    assert torch.equal(plain[0], out) and torch.equal(plain[1], state_out)


# ---------------------------------------------------------------------------
# the RG-LRU scan
# ---------------------------------------------------------------------------


def _rglru_numpy(b, s, w, seed):
    rng = np.random.default_rng(seed)
    u = (2.0 * rng.standard_normal((b, s, w))).astype(np.float32)
    gates = [(1.0 + 0.5 * rng.standard_normal(w)).astype(np.float32),
             (0.3 * rng.standard_normal(w)).astype(np.float32),
             (1.0 + 0.5 * rng.standard_normal(w)).astype(np.float32),
             (0.3 * rng.standard_normal(w)).astype(np.float32)]
    lam = rng.standard_normal(w).astype(np.float32)
    lam[0] = -30.0          # softplus ~ 1e-13: a ~ 1, the clamp binds
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    a = rng.random((b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w)).astype(np.float32)
    return u, gates, lam, h0, dh, a, bb


@pytest.mark.parametrize("b,s,w", [(2, 13, 24), (1, 1, 5), (3, 40, 16)])
def test_rglru_scan_bwd_ref_matches_autograd_and_jax(b, s, w):
    _, _, _, h0, dh, a, bb = _rglru_numpy(b, s, w, seed=s)
    ta, tb, th0, tdh = (torch.from_numpy(x) for x in (a, bb, h0, dh))
    h = ref.linear_scan_ref(ta, tb, th0)
    got = ref.rglru_scan_bwd_ref(ta, h, th0, tdh)
    leaves = [t.clone().requires_grad_() for t in (ta, tb, th0)]
    want = torch.autograd.grad(ref.linear_scan_ref(*leaves), leaves, tdh)
    _, vjp = jax.vjp(jref.linear_scan_ref, jnp.asarray(a), jnp.asarray(bb),
                     jnp.asarray(h0))
    jwant = vjp(jnp.asarray(dh))
    for name, g, w1, w2 in zip(("da", "db", "dh0"), got, want, jwant):
        _close(g, w1, f"{name} against autograd")
        _close(g, np.asarray(w2), f"{name} against jax")
    # the Function's CPU backward is the plain one
    ops.reset_launch_count()
    out = ops.rglru_scan(*leaves)
    via_op = torch.autograd.grad(out, leaves, tdh)
    assert all(torch.equal(g, w) for g, w in zip(via_op, got))
    assert all(ops.launch_count(n) == 0 for n in ops.KERNELS)


def _jax_gated(u, wa, ba, wx, bx, lam, h0):
    """The reference's RG-LRU from its post-conv input: ``_gates``, then its
    associative scan from h0."""
    params = {"gate_a_w": wa, "gate_a_b": ba, "gate_x_w": wx,
              "gate_x_b": bx, "lam": lam}
    a, gated = jrglru._gates(params, u)
    return jref.linear_scan_ref(a, gated, h0)


@pytest.mark.parametrize("b,s,w,dtype", [(2, 13, 24, torch.float32),
                                         (1, 1, 5, torch.float32),
                                         (2, 17, 20, torch.bfloat16)])
def test_rglru_gated_scan_bwd_ref_matches_autograd_and_jax(b, s, w, dtype):
    u, gates, lam, h0, dh, _, _ = _rglru_numpy(b, s, w, seed=7 + s)
    tu = torch.from_numpy(u).to(dtype)
    tg = [torch.from_numpy(g).to(dtype) for g in gates]
    tlam, th0, tdh = (torch.from_numpy(x) for x in (lam, h0, dh))
    sp = F.softplus(tlam)
    h = ref.rglru_gated_scan_ref(tu, *tg, sp, th0)
    got = ref.rglru_gated_scan_bwd_ref(tu, *tg, sp, th0, h, tdh)
    leaves = [t.clone().requires_grad_() for t in (tu, *tg, sp, th0)]
    want = torch.autograd.grad(ref.rglru_gated_scan_ref(*leaves), leaves,
                               tdh)
    names = ("du", "dgate_a_w", "dgate_a_b", "dgate_x_w", "dgate_x_b",
             "dsoftplus_lam", "dh0")
    for name, g, w1 in zip(names, got, want):
        assert g.dtype == w1.dtype
        _close(g, w1, f"{name} against autograd", g.dtype)
    # through the Function on the CPU (softplus by autograd) against the
    # reference in fp32, on the same (bf16-rounded) values
    jin = [jnp.asarray(t.float().numpy()) for t in (tu, *tg)] + [
        jnp.asarray(lam), jnp.asarray(h0)]
    _, vjp = jax.vjp(_jax_gated, *jin)
    jwant = vjp(jnp.asarray(dh))
    lam_leaf = tlam.clone().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (tu, *tg)] + [
        lam_leaf, th0.clone().requires_grad_()]
    ops.reset_launch_count()
    out = ops.rglru_gated_scan(*leaves[:5], F.softplus(lam_leaf), leaves[6])
    via_op = torch.autograd.grad(out, leaves, tdh)
    assert all(ops.launch_count(n) == 0 for n in ops.KERNELS)
    assert torch.equal(via_op[0], got[0])
    for name, g, w2 in zip(names[:5] + ("dlam", "dh0"), via_op, jwant):
        _close(g, np.asarray(w2), f"{name} against jax", g.dtype)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_three_train_steps_match_reference(arch):
    """``train()`` three steps of the reduced model on both sides from the
    same state on the same batches (4 microbatches of 16 tokens)."""
    cfg = _cfg(arch, microbatch_tokens_per_device=16)
    ref_run, run = _runs(cfg)
    assert run.microbatches() == ref_run.microbatches() == 4
    ref_model = RefModel(cfg)
    jstate = ref_loop.init_state(ref_model, ref_run, jax.random.PRNGKey(0))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                 "cpu")
    want = ref_loop.train(ref_model, ref_run, _pipe(cfg).batches(None), 3,
                          state=jstate, log_every=100)
    got = loop.train(Model(cfg, device="cpu"), run,
                     _pipe(cfg).batches(None), 3, state=state,
                     log_every=100)
    assert len(got.losses) == len(want.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=TOL)
    assert got.losses[-1] < got.losses[0]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_launch_train_runs_the_recurrent_models_on_the_cpu(arch):
    report = launch_train.main(["--arch", arch, "--reduced", "--device",
                                "cpu", "--steps", "3", "--batch", "2",
                                "--seq", "32"])
    assert report.steps == 3 and len(report.losses) == 3
    assert all(np.isfinite(report.losses))
