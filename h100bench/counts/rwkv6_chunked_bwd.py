"""The least time of one ``rwkv6_chunked_bwd`` call, counted from its
shapes (frozen from ``chip_smoke.py``'s ``_rwkv6_bwd_bound``): r, k, v,
u, logw and dout read once, the forward's states (the starting state, the
states entering every chunk but the first, the final state) and
dstate_out read once, dr, dk, dv, du, dlogw and dstate0 written once,
over the card's bandwidth, against the gradient's chunk-form products
over the TF32 rate: per (b, h) and chunk of C, 8·C·hd² and 6·C²·hd (the
pairwise exponentials left out)."""

from h100bench import peaks


def bound_s(b, h, s, hd, chunk, esize=2, wsize=4) -> float:
    n = s // chunk
    elems = b * h * s * hd
    nbytes = (elems * (6 * esize + 2 * wsize + 4) + 2 * h * hd * esize
              + b * h * (n + 3) * hd * hd * 4)
    flops = (8 * chunk * hd * hd + 6 * chunk * chunk * hd) * b * h * n
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.PEAK_FLOPS_TF32)
