"""The least time of one ``flash_attention`` forward call, counted from
its shapes (frozen from ``chip_smoke.py``'s ``_flash_bound``): q, k and v
read once and the output written once, over the card's bandwidth,
against 4·HD operations for every (query, key) pair the mask leaves (two
products of HD multiply-adds) over the bf16 tensor-core rate."""

from h100bench import peaks


def pairs(sq, skv, causal=True, window=0) -> int:
    """Pairs of a query and a key the mask leaves, the queries aligned to
    the last keys."""
    off = skv - sq
    total = 0
    for i in range(sq):
        hi = i + off if causal else skv - 1
        lo = max(0, hi - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def bound_s(bh, sq, skv, hd, group=1, causal=True, window=0,
            esize=2) -> float:
    nbytes = (2 * bh * sq * hd + 2 * (bh // group) * skv * hd) * esize
    ops = 4.0 * hd * pairs(sq, skv, causal, window) * bh
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.PEAK_FLOPS_BF16)
