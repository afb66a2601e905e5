"""A CPU emulation of ``subsample_grid``'s fixed summation order, for the
tests only.

``emulate`` recomputes ``ops.subsample_grid``'s ``[B, 2, grid]`` from the
same indices with numpy float32 scalars, one IEEE fp32 operation at a time,
in the order ``csrc/subsample_grid.cu`` adds (its header lists it), cut as
``kernels/subsample_grid.py::plan`` cuts the shape:

* ``monthly_mean``: a (task, sample)'s ``draws * ds`` elements ``e = d * ds
  + j`` as rows of 32 (``e = 32 t + lane``); group ``g`` takes rows
  ``[g, g + 1) * per_group``, warp ``w`` of it ``[w, w + 1) * per_warp``;
* ``alod``: warp ``w`` of group ``g`` takes draw ``d = 8 g + w``, lane
  ``lane`` its elements ``j = lane + 32 i``; the row's mean and sum of
  squared deviations are each lane's sum in ``i`` order, then the xor
  shuffle tree;
* a warp adds in batches of 8 rows (or 8 ``i``); in a batch, the lanes of
  bin copy ``lane % copies`` in lane order, each its elements in order;
* a CTA adds each warp's copies in copy order, then the warps in order;
* a task adds ``(s, g)`` for ``s = w, w + 32, ...`` and ``g`` in order for
  each ``w`` of 32, then the 32 sums in ``w`` order.

Imports neither JAX nor the reference package, so the card tests use it
too.
"""

import numpy as np

from repro_torch.kernels import subsample_grid as sg

F32 = np.float32
SUM_WARPS = 32   # kSumWarps in the source

# Shapes that take each branch of the kernel's order: groups above 1
# (monthly_mean rows of 20,000 take the direct body's 4,096-element CTAs), a
# draw size that is no multiple of 32 and one past 256 (alod draws again),
# grids of 8 (32 bin copies), 64, 120 and 512 (one copy, 32 phases), ns past
# the sum kernel's 32 warps.  n_slots, ns, sl, B, draws, ds, grid:
CASES = [(3, 5, 300, 2, 9, 77, 120), (3, 3, 4096, 2, 8, 600, 64),
         (2, 2, 20000, 1, 8, 2048, 120), (2, 2, 1000, 2, 3, 50, 512),
         (2, 3, 64, 2, 3, 1, 8), (2, 40, 64, 1, 2, 20, 16)]


def inputs(n_slots, ns, sl, b, draws, ds, grid, seed):
    """numpy data, months reaching past [0, grid) on both sides, rows and
    indices for one case."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n_slots, ns, sl)).astype(F32)
    months = rng.integers(-3, grid + 4, (n_slots, ns, sl)).astype(np.int32)
    rows = rng.integers(0, n_slots, b).astype(np.int32)
    idx = rng.integers(0, sl, (b, draws, ns, ds)).astype(np.int32)
    return data, months, rows, idx


def _warp_sum(lanes):
    v = np.asarray(lanes, dtype=F32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ off]
    return v[0]


def _cta(block, months, idx_bs, s, g, cut, ds, grid, statistic):
    """One CTA's ``[2, grid]`` partial: block ``[ns, sl]``, ``idx_bs``
    ``[draws, ds]`` (task b's indices of sample s)."""
    draws = idx_bs.shape[0]
    sl = block.shape[1]
    copies, warps = cut.copies, sg.WARPS
    bins = np.zeros((warps, grid, copies, 2), dtype=F32)
    for w in range(warps):
        if statistic == "alod":
            d = g * warps + w
            if d >= draws:
                continue
            n_i = (ds + 31) // 32
            x = {(lane, i): F32(block[s, idx_bs[d, lane + 32 * i]])
                 for lane in range(32) for i in range(n_i)
                 if lane + 32 * i < ds}
            acc = [F32(0)] * 32
            for (lane, i) in sorted(x, key=lambda li: (li[1], li[0])):
                acc[lane] = F32(acc[lane] + x[lane, i])
            mean = F32(_warp_sum(acc) / F32(ds))
            sq = [F32(0)] * 32
            for (lane, i) in sorted(x, key=lambda li: (li[1], li[0])):
                dev = F32(x[lane, i] - mean)
                sq[lane] = F32(sq[lane] + F32(dev * dev))
            sd = F32(F32(np.sqrt(F32(_warp_sum(sq) / F32(ds)))) + F32(1e-6))
            batches = range(0, n_i, sg.BATCH)

            def element(lane, i0, k):
                i = i0 + k
                if i >= n_i or (lane, i) not in x:
                    return None
                ix = idx_bs[d, lane + 32 * i]
                pos = F32(F32(ix) / F32(sl))
                cell = min(max(int(F32(pos * F32(grid))), 0), grid - 1)
                return cell, F32(abs(F32(F32(x[lane, i] - mean) / sd)))
        else:
            n_e = draws * ds
            n_t = (n_e + 31) // 32
            per_group = -(-n_t // cut.groups)
            per_warp = -(-per_group // warps)
            g_end = min(n_t, (g + 1) * per_group)
            t_begin = min(g_end, g * per_group + w * per_warp)
            t_end = min(g_end, t_begin + per_warp)
            batches = range(t_begin, t_end, sg.BATCH)

            def element(lane, t0, k):
                t = t0 + k
                e = 32 * t + lane
                if t >= t_end or e >= n_e:
                    return None
                ix = idx_bs[e // ds, e % ds]
                cell = min(max(int(months[s, ix]), 0), grid - 1)
                return cell, F32(block[s, ix])
        for b0 in batches:
            for lane in range(32):        # phase order, then lane order
                copy = lane % copies      # == lane order within a copy
                for k in range(sg.BATCH):
                    got = element(lane, b0, k)
                    if got is None:
                        break
                    cell, v = got
                    bins[w, cell, copy, 0] = F32(bins[w, cell, copy, 0] + v)
                    bins[w, cell, copy, 1] = F32(bins[w, cell, copy, 1] + 1)
    out = np.zeros((2, grid), dtype=F32)
    for c in range(grid):
        for r in range(2):
            acc = F32(0)
            for w in range(warps):
                per_warp_sum = F32(0)
                for k in range(copies):
                    per_warp_sum = F32(per_warp_sum + bins[w, c, k, r])
                acc = F32(acc + per_warp_sum)
            out[r, c] = acc
    return out


def emulate(data, months, rows, idx, *, grid, statistic):
    """``subsample_grid``'s result in its own order: numpy ``data
    [n_slots, ns, sl]`` fp32, ``months`` int32, ``rows [B]`` and ``idx
    [B, draws, ns, ds]`` → ``[B, 2, grid]`` fp32."""
    bsz, draws, ns, ds = idx.shape
    sl = data.shape[2]
    cut = sg.plan(sl, draws, ds, grid, statistic)
    out = np.zeros((bsz, 2, grid), dtype=F32)
    for b in range(bsz):
        block, mo = data[rows[b]], months[rows[b]]
        part = np.stack([
            np.stack([_cta(block, mo, idx[b, :, s, :], s, g, cut, ds, grid,
                           statistic) for g in range(cut.groups)])
            for s in range(ns)])                       # [ns, groups, 2, grid]
        for r in range(2):
            for c in range(grid):
                total = F32(0)
                for w in range(SUM_WARPS):
                    acc = F32(0)
                    for s in range(w, ns, SUM_WARPS):
                        for g in range(cut.groups):
                            acc = F32(acc + part[s, g, r, c])
                    total = F32(total + acc)
                out[b, r, c] = total
    return out
