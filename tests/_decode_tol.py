"""The tolerance of ``attention_decode_int8``'s output against its plain
version (``kernels.ref.attention_decode_int8_ref``): a budget of its own
for each output.

Both read the same dequantized values (int8 times scale, rounded to bf16)
and compute the scores and the probabilities p in fp32.  The plain version
rounds p to bf16 before the product with v: up to 2^-8 of each weight
(bf16's unit roundoff), so up to 2^-8 * sum_j p_j |v_j| on an output.
Each side rounds its fp32 output to bf16 once, up to 2^-8 of it: 2^-7 of
|want| between the two.  fp32's own rounding of the scores and sums lies
far below both terms.  So an output may part from the plain version's by

    2^-8 * sum_j p_j |v_j| + 2^-7 * |want| + 2^-126

with p the plain version's fp32 probabilities and v its dequantized
values; the last term, the smallest normal fp32 and bf16, covers the
roundings of values below it, which are absolute rather than relative.
A kernel that rounds its scores to bf16 or its probabilities to fp8
fails it (``emulate`` builds both; ``tests/test_torch_attention_decode_int8.py``
holds them to it).

Used by ``tests/test_torch_cuda.py``, the CPU tests and ``chip_smoke.py``
phase 3j, imported as ``_decode_tol`` from this directory.
"""

import math

import torch

P_ROUND = 2.0 ** -8    # the plain version's bf16 probabilities
OUT_ROUND = 2.0 ** -7  # one bf16 rounding of the output on each side
TINY = 2.0 ** -126     # below it roundings are absolute


def _dequantized(cache, name):
    return (cache[name].float() * cache[name + "_scale"]).to(
        torch.bfloat16).float()


def probabilities(q, new_cache, pos, window=0, scores_dtype=None):
    """The plain version's fp32 probabilities ``[B, KV, G, S_max]`` over
    the cache it returned (the new token written), 0 on masked slots;
    with ``scores_dtype`` the scores are rounded to it first."""
    s_max = new_cache["k"].shape[1]
    write_at = pos % window if window else pos
    ck = _dequantized(new_cache, "k")
    scores = torch.einsum("bikgd,bjkd->bkgj", q.float(), ck)
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if scores_dtype is not None:
        scores = scores.to(scores_dtype).float()
    slot = torch.arange(s_max, device=q.device)
    valid = ((slot <= write_at) | (pos >= window)) if window else slot <= pos
    scores = torch.where(valid[None, None, None], scores,
                         torch.full_like(scores, -1e30))
    return torch.softmax(scores, dim=-1)


def budget(q, new_cache, pos, window, want):
    """Each output's budget, ``[B, KV, G, HD]`` fp32 (see the module)."""
    p = probabilities(q, new_cache, pos, window)
    weighted = torch.einsum("bkgj,bjkd->bkgd", p,
                            _dequantized(new_cache, "v").abs())
    return P_ROUND * weighted + OUT_ROUND * want.float().abs() + TINY


def share(got, want, bound):
    """The largest share of its budget that an output's gap takes: above
    1 fails."""
    return float(((got.float() - want.float()).abs() / bound).max())


def emulate(q, new_cache, pos, window=0, *, scores_dtype=None,
            probs_dtype=None):
    """The kernel's arithmetic in torch ops on the cache the plain version
    returned: fp32 scores and probabilities, the fp32 sum rounded to bf16
    once.  ``scores_dtype`` rounds the scores and ``probs_dtype`` the
    probabilities to a narrower type, as a wrong kernel would."""
    p = probabilities(q, new_cache, pos, window, scores_dtype)
    if probs_dtype is not None:
        p = p.to(probs_dtype).float()
    out = torch.einsum("bkgj,bjkd->bkgd", p, _dequantized(new_cache, "v"))
    return out.to(torch.bfloat16)
