"""The arithmetic of ``rwkv6_chunked_bwd``'s tensor-core kernel, on the CPU.

``csrc/rwkv6_scan_bwd.cu`` cuts each chunk into blocks of 16 rows and
factors every pairwise decay ``e^{logP_i − logP_{j+1}}`` outside the
diagonal blocks at reference points that keep both exponents ≤ 0, so that
dr, dk and dv become matrix products; each diagonal block is cut at its
8th row, and only its two diagonal halves stay pairwise.
``ref.rwkv6_chunked_bwd_factored_ref`` repeats that arithmetic in torch.
The tests hold it within ``BWD_TOL`` (1e-5 of each leaf's largest entry;
a bf16 gradient one bf16 step more) against the plain backward
``ref.rwkv6_chunked_bwd_ref``, against autograd through the chunk form
(fp32 and bf16 leaves, decays to −2 and to −40 a token) and against
``jax.vjp`` of the reference's ``chunk_body`` under ``lax.scan``: in fp32
at decays to −2, in float64 at decays to −40 (in fp32 the log-decay sums'
own rounding moves the gradients by ~1e-5 there; see
``tests/test_torch_recurrent_train.py``).  Chunks of 16 and 64, chunks
that 16 does not divide (13, 7) and blocks smaller than 16.

The kernel takes its products as ``mma.sync`` with TF32 operands: each
fp32 operand is split into a high and a low TF32 part and a product is
three terms.  A test rounds the operands as the kernel does (masking the
mantissa) and shows that three terms stay within the card's tolerance
``RW_BWD_TOL`` of the plain backward at the training path's hd and chunk,
and one term does not.

The plain versions form the log-decay sums as a running sum in row order
in the inputs' own precision (``ref.log_decay_sums``), the card's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RW_BWD_TOL
from repro_torch.kernels import ref
from tests.test_torch_recurrent_train import (RW_NAMES, _chunk_state_f64,
                                              _close, _jax_chunked,
                                              _rwkv6_numpy)

FACTORED_CASES = [  # chunk, sub, dtype, span
    (16, 16, torch.float32, 2.0),
    (64, 16, torch.float32, 2.0),
    (13, 16, torch.float32, 2.0),
    (7, 4, torch.float32, 2.0),
    (64, 16, torch.float32, 40.0),
    (13, 16, torch.float32, 40.0),
    (16, 16, torch.float64, 40.0),
    (64, 16, torch.float64, 40.0),
    (13, 16, torch.float64, 40.0),
    (7, 4, torch.float64, 2.0),
    (64, 16, torch.bfloat16, 2.0),
    (13, 16, torch.bfloat16, 40.0),
]


def _case(chunk, dtype, span, seed):
    """The backward's arguments for two chunks of ``[2, 2, ·, 8]``, with
    the forward's own states (float64 throughout for float64)."""
    arrays = _rwkv6_numpy(2, 2, 2 * chunk, 8, span, seed)
    r, k, v, logw, u, state0, dout, dstate = (torch.from_numpy(a)
                                              for a in arrays)
    if dtype == torch.float64:
        r, k, v, logw, u, state0, dout, dstate = (
            t.double() for t in (r, k, v, logw, u, state0, dout, dstate))
        states, st = [], state0
        for c0 in range(0, r.shape[2], chunk):
            if c0:
                states.append(st)
            part = slice(c0, c0 + chunk)
            st = _chunk_state_f64(k[:, :, part], v[:, :, part],
                                  logw[:, :, part], st)
        return (r, k, v, logw, u, state0, torch.stack(states, 2), st, dout,
                dstate)
    r, k, v, u = (t.to(dtype) for t in (r, k, v, u))
    _, state_out, states = ref.rwkv6_chunk_form_ref(
        r, k, v, logw, u, state0, chunk, with_states=True)
    return (r, k, v, logw, u, state0, states, state_out, dout, dstate)


@pytest.mark.parametrize("chunk,sub,dtype,span", FACTORED_CASES)
def test_factored_bwd_matches_plain_autograd_and_jax(chunk, sub, dtype,
                                                     span):
    args = _case(chunk, dtype, span, seed=chunk + int(span))
    got = ref.rwkv6_chunked_bwd_factored_ref(*args, chunk, sub=sub)
    plain = ref.rwkv6_chunked_bwd_ref(*args, chunk)
    what = f"chunk {chunk}, sub {sub}, {dtype}, span {span}"
    for name, g, w in zip(RW_NAMES, got, plain):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, f"{name} against the plain backward at {what}", g.dtype)
    if dtype != torch.float64:
        # autograd through the chunk form on the widened leaves
        r, k, v, logw, u, state0, _, _, dout, dstate = args
        leaves = [t.float().clone().requires_grad_()
                  for t in (r, k, v, logw, u, state0)]
        out, state_out = ref.rwkv6_chunk_form_ref(*leaves, chunk)
        auto = torch.autograd.grad((out, state_out), leaves, (dout, dstate))
        for name, g, w in zip(RW_NAMES, got, auto):
            _close(g, w, f"{name} against autograd at {what}", g.dtype)
    if dtype == torch.float64 or span == 2.0:
        wide = dtype == torch.float64
        with jax.enable_x64(wide):
            jin = [jnp.asarray((t.double() if wide else t.float()).numpy())
                   for t in args]
            _, vjp = jax.vjp(lambda *a: _jax_chunked(*a, chunk), *jin[:6])
            want = vjp((jin[8], jin[9]))
        for name, g, w in zip(RW_NAMES, got, want):
            _close(g, np.asarray(w), f"{name} against jax at {what}",
                   g.dtype)


def _high_bits(x: torch.Tensor, bias: int = 0) -> torch.Tensor:
    """``x`` with the low 13 bits of its mantissa masked off (a TF32
    value), after adding ``bias`` to its bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _tensor_core_product(terms: int):
    """``a @ b`` with TF32 operands as the kernel splits them: ``hi`` is an
    operand rounded to nearest on a 10-bit mantissa (half an ulp added to
    its bits, then masked), ``lo = x − hi`` masked.  One term ``hi·hi``, or
    three ``lo·hi + hi·lo + hi·hi``, each exact in fp32 and summed in
    fp32."""
    def product(a, b):
        ah, bh = _high_bits(a, 0x1000), _high_bits(b, 0x1000)
        out = ah @ bh
        if terms == 3:
            out = _high_bits(a - ah) @ bh + ah @ _high_bits(b - bh) + out
        return out
    return product


@pytest.mark.parametrize("terms,within", [(3, True), (1, False)])
def test_three_tf32_terms_hold_the_card_tolerance(terms, within):
    """fp32 leaves (so that no operand is exact in TF32) at hd 64 and the
    training path's chunk of 64, four chunks."""
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    b, h, s, hd, chunk = 1, 2, 256, 64, 64
    r, k, v = (normal(b, h, s, hd) for _ in range(3))
    logw = torch.from_numpy(
        (-0.05 - 2.45 * rng.random((b, h, s, hd))).astype(np.float32))
    u, state0 = normal(h, hd, scale=0.3), normal(b, h, hd, hd, scale=0.5)
    dout, dstate = normal(b, h, s, hd), normal(b, h, hd, hd, scale=0.5)
    _, state_out, states = ref.rwkv6_chunk_form_ref(
        r, k, v, logw, u, state0, chunk, with_states=True)
    args = (r, k, v, logw, u, state0, states, state_out, dout, dstate)
    plain = ref.rwkv6_chunked_bwd_ref(*args, chunk)
    got = ref.rwkv6_chunked_bwd_factored_ref(
        *args, chunk, product=_tensor_core_product(terms))
    errs = {name: float((g.double() - w.double()).abs().max()
                        / w.double().abs().max())
            for name, g, w in zip(RW_NAMES, got, plain)}
    assert all(e <= RW_BWD_TOL for e in errs.values()) == within, errs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_log_decay_sums_add_in_row_order_in_the_inputs_precision(dtype):
    """Bit for bit numpy's sequential ``add.accumulate`` in the inputs'
    own type, at decays to −40 a token over 64 rows."""
    rng = np.random.default_rng(5)
    lw = (-40.0 * rng.random((2, 3, 64, 8))).astype(dtype)
    lp, lq = ref.log_decay_sums(torch.from_numpy(lw), 2)
    run = np.add.accumulate(lw, axis=2, dtype=dtype)
    assert lp.dtype == lq.dtype == torch.from_numpy(lw).dtype
    np.testing.assert_array_equal(lp.numpy(), run - lw)
    np.testing.assert_array_equal(lq.numpy(), (run - lw) + lw)
