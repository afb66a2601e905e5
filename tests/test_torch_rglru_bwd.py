"""The order the ``rglru_scan_bwd`` kernel sums in, on the CPU.

``ref.rglru_gated_scan_bwd_kernel_order_ref`` is the plain gated backward
with the gate vectors' five sums added in the kernel's documented order
(per slot of rows, per channel, per batch row; the header of
``csrc/rglru_scan_bwd.cu``).  On the card the kernel's sums equal it bit
for bit (``chip_smoke.py`` phase 3i, ``tests/test_torch_cuda.py``); here it
is held against the plain version and the JAX reference.  Inputs are made
with numpy from a seed.  Tolerances:

* du and dh0 against ``rglru_gated_scan_bwd_ref``: bit for bit (the same
  element-wise ops);
* the five sums against it: ``RG_SUM_TOL``, 1e-4 of each one's largest
  entry (and for a bf16 gradient one bf16 step of the entry more), the
  tolerance the card holds the kernel's sums to (``chip_smoke.py``
  ``_leaf_err``): B·S fp32 terms added in another order than
  ``torch.sum``'s, then rounded to the gate vectors' type;
* every leaf against ``jax.vjp`` through the reference's ``_gates`` and
  associative scan: ``BWD_TOL`` of ``tests/test_torch_recurrent_train.py``
  (1e-5 of each leaf's largest entry; a bf16 gradient also within one bf16
  step of each entry);
* the vectorised order against a scalar loop in numpy float32 that follows
  the header's words: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from tests.test_torch_recurrent_train import _close, _jax_gated

RG_SUM_TOL = 1e-4
NAMES = ("du", "dgate_a_w", "dgate_a_b", "dgate_x_w", "dgate_x_b",
         "dsoftplus_lam", "dh0")


def _inputs(b, s, w, dtype, lam_mean, seed):
    """u and the gate vectors (in ``dtype``), lam, h0 and dh (fp32) as
    torch tensors, h the plain forward's output."""
    rng = np.random.default_rng(seed)
    u = (2.0 * rng.standard_normal((b, s, w))).astype(np.float32)
    gates = [(m + 0.3 * rng.standard_normal(w)).astype(np.float32)
             for m in (1.0, 0.0, 1.0, 0.0)]
    lam = (lam_mean + 0.3 * rng.standard_normal(w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    tu = torch.from_numpy(u).to(dtype)
    tg = [torch.from_numpy(g).to(dtype) for g in gates]
    tlam, th0, tdh = (torch.from_numpy(x) for x in (lam, h0, dh))
    sp = F.softplus(tlam)
    h = ref.rglru_gated_scan_ref(tu, *tg, sp, th0)
    return tu, tg, tlam, sp, th0, h, tdh


CASES = [
    (2, 1, 100, torch.bfloat16, 1.0),     # S = 1
    (3, 70, 2563, torch.bfloat16, 1.0),   # S off the chunk, W off blocks
    (2, 70, 100, torch.float32, 1.0),     # W off the 8-channel block
    (1, 300, 40, torch.bfloat16, 1.0),    # five chunks, the last short
    (2, 200, 48, torch.float32, -20.0),   # the clamp of 1 - a^2 binds
]


def _case_id(case):
    b, s, w, dtype, lam = case
    return f"{b}x{s}x{w}-{str(dtype).split('.')[-1]}-lam{lam}"


@pytest.mark.parametrize("b,s,w,dtype,lam_mean", CASES,
                         ids=[_case_id(c) for c in CASES])
def test_kernel_order_ref_matches_plain_version(b, s, w, dtype, lam_mean):
    tu, tg, _, sp, th0, h, tdh = _inputs(b, s, w, dtype, lam_mean,
                                         seed=s + w)
    args = (tu, *tg, sp, th0, h, tdh)
    got = ref.rglru_gated_scan_bwd_kernel_order_ref(*args)
    want = ref.rglru_gated_scan_bwd_ref(*args)
    for name, g, wv in zip(NAMES, got, want):
        assert g.dtype == wv.dtype and g.shape == wv.shape, name
        if name in ("du", "dh0"):
            assert torch.equal(g, wv), name
        else:
            gd, wd = g.double(), wv.double()
            scale = max(float(wd.abs().max()), 1e-30)
            step = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
            bad = (gd - wd).abs() > RG_SUM_TOL * scale + step * wd.abs()
            assert not bool(bad.any()), (
                f"{name}: {float((gd - wd).abs().max()) / scale}")
    if lam_mean < -10:
        # the clamp binds everywhere: dlog_a is da a alone
        assert float(got[5].abs().max()) > 0


@pytest.mark.parametrize("b,s,w,dtype,lam_mean", CASES,
                         ids=[_case_id(c) for c in CASES])
def test_kernel_order_ref_matches_jax(b, s, w, dtype, lam_mean):
    tu, tg, tlam, sp, th0, h, tdh = _inputs(b, s, w, dtype, lam_mean,
                                            seed=7 + s + w)
    got = list(ref.rglru_gated_scan_bwd_kernel_order_ref(tu, *tg, sp, th0,
                                                         h, tdh))
    # the reference differentiates lam, through softplus
    got[5] = got[5] * torch.sigmoid(tlam)
    jin = [jnp.asarray(t.float().numpy()) for t in (tu, *tg, tlam, th0)]
    _, vjp = jax.vjp(_jax_gated, *jin)
    jwant = vjp(jnp.asarray(tdh.numpy()))
    for name, g, wv in zip(NAMES[:5] + ("dlam", "dh0"), got, jwant):
        _close(g, np.asarray(wv), f"{name} against jax", g.dtype)


def _documented_order(t: np.ndarray) -> np.ndarray:
    """The header's order in numpy float32 scalars: slot s of a 64-step
    chunk holds rows t0 + s + 32 j (s < 32, j < 2); a slot adds its rows to
    0 chunk by chunk from the last chunk, j in order; a channel adds its
    slots to 0 in order; the batch rows add to 0 in order."""
    b, s, w = t.shape
    total = np.zeros(w, dtype=np.float32)
    for c in range(w):
        over_b = np.float32(0.0)
        for bi in range(b):
            part = np.float32(0.0)
            for slot in range(32):
                acc = np.float32(0.0)
                for t0 in range((s - 1) // 64 * 64, -1, -64):
                    for j in range(2):
                        row = t0 + slot + 32 * j
                        if row < s:
                            acc = np.float32(acc + t[bi, row, c])
                part = np.float32(part + acc)
            over_b = np.float32(over_b + part)
        total[c] = over_b
    return total


@pytest.mark.parametrize("b,s,w", [(2, 70, 3), (1, 1, 2), (3, 130, 2)])
def test_kernel_order_sum_follows_the_documented_order(b, s, w):
    rng = np.random.default_rng(s)
    # terms of mixed magnitude, so that another order rounds otherwise
    t = (rng.standard_normal((b, s, w))
         * 10.0 ** rng.integers(-4, 5, (b, s, w))).astype(np.float32)
    got = ref._kernel_order_sum(torch.from_numpy(t)).numpy()
    want = _documented_order(t)
    assert np.array_equal(got, want)
