"""The least time of latent attention's prefill product at the model's
own widths, one layer: q and k of ``qk`` (nope + rope) and v and the
output of ``v`` a head, causal, bf16.  q, k and v read once and the
output written once over the card's bandwidth, against 2 · (qk + v)
operations for every (query, key) pair the mask leaves over the bf16
tensor-core rate.  The ``flash_attention`` kernel runs this padded to its
head size of 256, so its share of this bound shows what the padding
costs."""

from h100bench import peaks


def pairs(s: int) -> int:
    """Causal pairs of a query and a key at or before it."""
    return s * (s + 1) // 2


def bound_s(bh: int, s: int, qk: int, v: int, esize: int = 2) -> float:
    nbytes = bh * s * (2 * qk + 2 * v) * esize
    ops = 2.0 * (qk + v) * pairs(s) * bh
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.PEAK_FLOPS_BF16)
