"""Plain PyTorch versions of the port's kernels (the allclose targets).

Each function here computes what its hand-written kernel computes, in
the same order of floating-point operations where that is cheap to say
in tensor code, so that on the card the two agree to rounding and on
the CPU the wrapper can run this version instead.
"""

from __future__ import annotations

import torch


def subsample_stats_ref(data: torch.Tensor, indices: torch.Tensor, *,
                        rows_per_step: int = 8) -> torch.Tensor:
    """``data [B, N, D]`` fp32 + ``indices [B, T]`` int → ``[B, 2, D]`` fp32
    holding each task's ``(Σ_t row, Σ_t row²)`` over ``data[b, indices[b, t]]``.

    The order of summation is the kernel's: ``T`` is rounded up to a
    multiple of ``rows_per_step`` with the padded tail masked to zero; the
    rows of each group are added one after another into a group sum, and
    the group sums are added in index order into the accumulator.  Every
    square is rounded before it is added (no fused multiply-add)."""
    bsz, _, d = data.shape
    t = indices.shape[1]
    steps = -(-t // rows_per_step)
    t_pad = steps * rows_per_step
    idx = torch.zeros((bsz, t_pad), dtype=torch.int64, device=data.device)
    idx[:, :t] = indices.to(torch.int64)
    rows = data[torch.arange(bsz, device=data.device)[:, None], idx]
    valid = torch.arange(t_pad, device=data.device) < t
    rows = torch.where(valid[None, :, None], rows, torch.zeros_like(rows))
    groups = rows.view(bsz, steps, rows_per_step, d)
    gsum = torch.zeros((bsz, steps, d), dtype=torch.float32,
                       device=data.device)
    gsq = torch.zeros_like(gsum)
    for j in range(rows_per_step):
        r = groups[:, :, j]
        gsum = gsum + r
        gsq = gsq + r * r
    acc = torch.zeros((bsz, d), dtype=torch.float32, device=data.device)
    acc2 = torch.zeros_like(acc)
    for s in range(steps):
        acc = acc + gsum[:, s]
        acc2 = acc2 + gsq[:, s]
    return torch.stack([acc, acc2], dim=1)
