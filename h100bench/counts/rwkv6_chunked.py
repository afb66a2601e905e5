"""The least time of one ``rwkv6_chunked`` call, counted from its shapes
(frozen from ``chip_smoke.py``'s ``_rwkv6_bound``): r, k, v, u, logw and
the starting state read once, the output and the final state written
once, over the card's bandwidth, against the chunk form's operations over
the TF32 tensor-core rate (its products run as 3xTF32).  Per (b, h) and
chunk of C: 2·C·hd² for the inter-chunk product, hd·C(C+1) for A v over
j <= i, 2·C·hd² for the state, the pairwise decays of A (5 per pair and
column below the diagonal, 3 on it) and about 10·C·hd + 3·hd²
elementwise operations."""

from h100bench import peaks


def bound_s(b, h, s, hd, chunk, esize=2, wsize=4) -> float:
    nbytes = (3 * b * h * s * hd * esize + b * h * s * hd * wsize
              + h * hd * esize + 2 * b * h * hd * hd * 4 + b * h * s * hd * 4)
    c = chunk
    per_chunk = (4 * c * hd * hd + hd * c * (c + 1)
                 + 5 * hd * c * (c - 1) // 2 + 3 * c * hd
                 + 10 * c * hd + 3 * hd * hd)
    flops = per_chunk * b * h * (s // c)
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.PEAK_FLOPS_TF32)
