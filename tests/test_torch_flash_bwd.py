"""The rounding points of ``flash_attention_bwd``'s tensor-core body, on the
CPU.

``csrc/flash_attention_bwd.cu`` runs the bf16 backward on ``wgmma``:
products of bf16 operands summed in fp32, P and dS rounded to bf16 where
they enter the dV, dK and dQ products, one fp32 sum a 64-row (dK, dV) or
64-key (dQ) tile in the kernel's loop order, a KV head's dK and dV summed
over its group in head order, one final rounding to bf16.  At HD 256 the
group's query heads split into ``fab.dkdv_splits`` parts: each split sums
its heads in head order into fp32 partials, and a second launch adds the
partials in split order before the one rounding (P^T passes between the
two consumer warpgroups in fp32, which changes no value).
``_emulate`` repeats that arithmetic with torch ops, P and dS entering as
one bf16 term or as two (``hi = bf16(x)``, ``lo = bf16(x - hi)``), and
the tests hold it against the plain version ``ref.flash_attention_bwd_ref``
and against ``jax.grad`` of the reference's ``_attend_block``
(``src/repro/models/layers.py:112``) at the bf16 tolerance the card holds
the kernel to (``FA_BWD_TOL`` in ``chip_smoke.py`` and
``tests/test_torch_cuda.py``): rtol 1e-2, atol 1e-3, one bf16 rounding of
the fp32 gradients plus their fp32 difference near zero.  One term alone
errs by up to 2^-9 of each P and dS and parts from the plain version by
more than that at the main shapes; two terms keep them to about 2^-17, so
the kernel takes two.

Shapes: the main paths' lengths at a few heads (2 heads of 2,048 at HD 64,
a ``musicgen-medium`` layer's; 1 head of 4,064 at HD 128, ``deepseek-7b``'s)
and ``internlm2-20b``'s group of 6 at a ragged Sq = Skv = 577; windowed,
the card's tensor-core case (2,048 at HD 64, window 512) and a ragged
group of 2 at window 100; at HD 256, ``recurrentgemma-2b``'s local layer
(10 query heads on one KV head) at 1,024 tokens and window 256, and a
ragged group of 2 at window 100.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _attend_block
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ref

RTOL, ATOL = 1e-2, 1e-3       # FA_BWD_TOL[torch.bfloat16]
LOG2E = 1.4426950408889634

CASES = [  # bh, sq, skv, hd, causal, group, window
    (2, 2048, 2048, 64, True, 1, 0),
    (1, 4064, 4064, 128, True, 1, 0),
    (12, 577, 577, 128, True, 6, 0),
    # windowed: the card's tensor-core case (window 512) and a ragged one
    (2, 2048, 2048, 64, True, 1, 512),
    (4, 600, 600, 128, True, 2, 100),
    # HD 256: recurrentgemma-2b's local layer, and a ragged group of 2
    (10, 1024, 1024, 256, True, 10, 256),
    (4, 600, 600, 256, True, 2, 100),
]


def _inputs(bh, sq, skv, hd, group, seed=0):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    q = normal(bh, sq, hd)
    k, v = normal(bh // group, skv, hd), normal(bh // group, skv, hd)
    dout = normal(bh, sq, hd)
    return q, k, v, dout


def _forward(q, k, v, causal, group, window):
    """The forward's bf16 output and fp32 log-sum-exp, as the backward is
    fed them."""
    kw = dict(causal=causal, window=window, group=group)
    return (ref.flash_attention_ref(q, k, v, **kw),
            ref.flash_attention_lse_ref(q, k, **kw))


def _terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """``x`` as the kernel hands it to a product: one bf16 term, or the sum
    of two (exact in fp32)."""
    hi = x.to(torch.bfloat16).float()
    if terms == 1:
        return hi
    return hi + (x - hi).to(torch.bfloat16).float()


def _emulate(q, k, v, out, lse, dout, *, causal, group, window, terms,
             splits=None):
    """The tensor-core body's arithmetic: ``(dq, dk, dv)`` in bf16.  At HD
    256 dK and dV sum ``splits`` partials (by default the kernel's,
    ``fab.dkdv_splits``) in split order."""
    bh, sq, hd = q.shape
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(group, dim=0)
    vf = v.float().repeat_interleave(group, dim=0)
    delta = (out.float() * dof).sum(dim=-1)
    lse2 = torch.where(torch.isneginf(lse),
                       torch.full_like(lse, float("inf")), lse * LOG2E)
    mask = ref.attention_mask(sq, skv, causal=causal, window=window)
    s = torch.einsum("bid,bjd->bij", qf, kf)
    p = torch.where(mask[None], torch.exp2(s * scale_log2 - lse2[..., None]),
                    torch.zeros(()))
    dp = torch.einsum("bid,bjd->bij", dof, vf)
    ds = p * (dp - delta[..., None])
    p, ds = _terms(p, terms), _terms(ds, terms)
    # dK and dV: a KV head's accumulators take its query heads in order,
    # each head's 64-row tiles in order; at HD 256 one accumulator a split
    # of the heads, the splits' partials then added in split order
    if hd != 256:
        splits = 1
    elif splits is None:
        splits = fab.dkdv_splits(bh // group, skv, group)
    dk = torch.zeros((bh // group, skv, hd))
    dv = torch.zeros_like(dk)
    for part in range(splits):
        pk, pv = torch.zeros_like(dk), torch.zeros_like(dv)
        for h in range(part * group // splits, (part + 1) * group // splits):
            heads = slice(h, bh, group)
            for r0 in range(0, sq, 64):
                rows = slice(r0, r0 + 64)
                pv += torch.einsum("bij,bid->bjd", p[heads, rows],
                                   dof[heads, rows])
                pk += torch.einsum("bij,bid->bjd", ds[heads, rows],
                                   qf[heads, rows])
        dk += pk
        dv += pv
    # dQ: a row block's accumulator takes the 64-key tiles in order
    dq = torch.zeros((bh, sq, hd))
    for k0 in range(0, skv, 64):
        keys = slice(k0, k0 + 64)
        dq += torch.einsum("bij,bjd->bid", ds[:, :, keys], kf[:, keys])
    return ((dq * scale).to(torch.bfloat16), (dk * scale).to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _violations(got, want):
    """Elements of ``got`` outside rtol/atol of ``want``, in fp32."""
    g, w = got.float(), want.float()
    return int(((g - w).abs() > ATOL + RTOL * w.abs()).sum())


@pytest.mark.parametrize("case", CASES)
def test_two_bf16_terms_hold_the_plain_version(case):
    bh, sq, skv, hd, causal, group, window = case
    q, k, v, dout = _inputs(bh, sq, skv, hd, group)
    out, lse = _forward(q, k, v, causal, group, window)
    got = _emulate(q, k, v, out, lse, dout, causal=causal, group=group,
                   window=window, terms=2)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       group=group)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{name} at {case}: {m}")


@pytest.mark.parametrize("case", CASES[:2])
def test_one_bf16_term_parts_from_the_plain_version(case):
    """Why the kernel takes two terms: with one, P's and dS's rounding
    (up to 2^-9 of each) moves gradients near zero past atol at the main
    shapes."""
    bh, sq, skv, hd, causal, group, window = case
    q, k, v, dout = _inputs(bh, sq, skv, hd, group)
    out, lse = _forward(q, k, v, causal, group, window)
    got = _emulate(q, k, v, out, lse, dout, causal=causal, group=group,
                   window=window, terms=1)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       group=group)
    bad = {name: _violations(g, w)
           for name, g, w in zip(("dq", "dk", "dv"), got, want)}
    assert all(n > 0 for n in bad.values()), bad


@pytest.mark.parametrize("case", CASES)
def test_two_bf16_terms_hold_jax_grad_of_attend_block(case):
    """Against ``jax.vjp`` of the reference's attention on the same bf16
    values in fp32: q ``[1, Sq, KV, G, HD]`` (query head ``kv * G + g``), k
    and v ``[1, Skv, KV, HD]``, the causal (and window's) mask as a boolean
    ``[Sq, Skv]``.
    The emulation takes the forward's output in fp32 here, as
    ``test_flash_attention_bwd_ref_matches_jax_grad`` does: JAX's gradient
    reads its own unrounded output, and the bf16 output the kernel reads
    in training moves D by one rounding, which is the forward's, not the
    backward's."""
    bh, sq, skv, hd, causal, group, window = case
    q, k, v, dout = _inputs(bh, sq, skv, hd, group, seed=9)
    kw = dict(causal=causal, window=window, group=group)
    out = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    lse = ref.flash_attention_lse_ref(q, k, **kw)
    got = _emulate(q, k, v, out, lse, dout, terms=2, **kw)
    kv = bh // group

    def heads_last(t):   # [BH, S, HD] -> [1, S, KV, G, HD]
        return np.moveaxis(t.float().numpy().reshape(kv, group, sq, hd),
                           2, 0)[None]

    mask = jnp.asarray(ref.attention_mask(sq, skv, causal=causal,
                                          window=window).numpy())
    _, vjp = jax.vjp(
        lambda a, b, c: _attend_block(a, b, c, mask, 1.0 / math.sqrt(hd)),
        jnp.asarray(heads_last(q)),
        jnp.asarray(np.moveaxis(k.float().numpy(), 1, 0)[None]),
        jnp.asarray(np.moveaxis(v.float().numpy(), 1, 0)[None]))
    jq, jk, jv = vjp(jnp.asarray(heads_last(dout)))
    want = (
        torch.from_numpy(np.moveaxis(np.asarray(jq)[0], 0, 2).reshape(
            bh, sq, hd).copy()),
        torch.from_numpy(np.moveaxis(np.asarray(jk)[0], 0, 1).copy()),
        torch.from_numpy(np.moveaxis(np.asarray(jv)[0], 0, 1).copy()))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{name} at {case}: {m}")


@pytest.mark.parametrize("splits", [1, 2, 5, 10])
def test_any_head_split_holds_the_plain_version(splits):
    """At HD 256 the kernel adds a split's heads in head order and the
    splits' fp32 partials in split order; the split count follows the
    shape (``fab.dkdv_splits``: five of two heads at ``recurrentgemma-2b``'s
    4,096 keys, ten of one at 1,024).  Every split of a group of 10 holds
    the plain version, so the count may follow the card's fill."""
    bh, sq, skv, hd, causal, group, window = 10, 1024, 1024, 256, True, 10, 256
    q, k, v, dout = _inputs(bh, sq, skv, hd, group, seed=3)
    out, lse = _forward(q, k, v, causal, group, window)
    got = _emulate(q, k, v, out, lse, dout, causal=causal, group=group,
                   window=window, terms=2, splits=splits)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window,
                                       group=group)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{name}, {splits}: {m}")


@pytest.mark.parametrize("kv_heads,skv,group,splits", [
    (1, 4096, 10, 5),     # recurrentgemma-2b's local layer: 320 CTAs
    (1, 1024, 10, 10),    # too few keys for 256 CTAs: every head its own
    (2, 600, 2, 2),
    (4, 4096, 10, 1),     # four KV heads of 64 blocks fill it alone
    (1, 8192, 10, 2),
    (3, 100, 7, 7),
])
def test_dkdv_splits_follow_the_shape(kv_heads, skv, group, splits):
    got = fab.dkdv_splits(kv_heads, skv, group)
    assert got == splits and group % got == 0
    blocks = kv_heads * -(-skv // 64)
    assert blocks * got >= fab.SPLIT_CTAS or got == group


# -- the dispatch and the kernels' names, without a card ---------------------


@pytest.mark.parametrize("dtype,hd,body", [
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
])
def test_body_is_chosen_by_type_and_head_size(dtype, hd, body):
    assert fab.BODY[(dtype, hd)] == body


def test_kernel_names_keep_the_profilers_split():
    """``chip_smoke.py`` files device time under ``flash_attention_bwd``
    when a kernel's name holds ``flash_bwd`` and under the forward when it
    holds ``flash_attention``: every ``__global__`` of the backward's source
    must hold the first and not the second."""
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                       r"(\w+)\s*\(", fab.SOURCE.read_text())
    assert {"flash_bwd_rows_kernel", "flash_bwd_dkdv_wgmma_kernel",
            "flash_bwd_dkdv_split_wgmma_kernel", "flash_bwd_dkdv_sum_kernel",
            "flash_bwd_dq_wgmma_kernel", "flash_bwd_delta_kernel",
            "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"} == set(names)
    assert all("flash_bwd" in n and "flash_attention" not in n
               for n in names)
