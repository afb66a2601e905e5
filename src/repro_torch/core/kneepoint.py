"""Task-sizing kneepoint algorithm (thesis §3.2.1, Fig 3).

The paper sizes tasks at the *smallest kneepoint* of the task-size →
cache-miss-rate curve: the largest task size **before the first increase in
the miss-rate growth rate**.  The offline phase measures the curve on a
benchmarking node; the online phase packs samples into equal
kneepoint-sized tasks.

Hardware adaptation (DESIGN.md §2): this container has no perf counters, so
the "miss rate" is a *cost-per-byte* proxy — either measured wall time per
sample (for real callables) or an analytic AMAT model
``t = t_hit + miss_rate(ws) · penalty`` over the HBM→VMEM (or RAM→L2)
hierarchy.  The kneepoint rule itself is the paper's, unchanged.

The same detector tunes the framework's other tiny-task knobs: microbatch
token counts, recurrence chunk lengths, and Pallas block shapes (working-set
bytes vs per-task overhead).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CurvePoint:
    task_size: float          # working-set bytes (or samples)
    cost: float               # misses/instruction proxy: cost per unit work


@dataclasses.dataclass(frozen=True)
class KneepointResult:
    task_size: float          # chosen task size (bytes or samples)
    index: int                # index into the measured curve
    curve: Tuple[CurvePoint, ...]
    growth_rates: Tuple[float, ...]
    reason: str


def find_kneepoint(
    curve: Sequence[CurvePoint],
    *,
    tolerance: float = 0.10,
) -> KneepointResult:
    """Paper's rule (Fig 3): walk the curve from the tiniest task upward,
    tracking the growth rate ``(cost[i+1]-cost[i]) / (size[i+1]-size[i])``;
    stop at the first point whose growth rate exceeds the initial growth
    rate (beyond ``tolerance``), and return the task size *before* it.

    ``tolerance`` absorbs measurement noise — the thesis §4.2.1 shows
    kneepoint selection is insensitive to small errors.
    """
    assert len(curve) >= 2, "need at least two curve points"
    pts = sorted(curve, key=lambda p: p.task_size)
    # The thesis' curve (misses/instruction) is nondecreasing; a wall-time
    # proxy additionally has a *falling* amortization region at tiny sizes.
    # Detection starts at the curve's floor so per-task-overhead noise on
    # the left cannot poison the baseline growth rate.
    all_pts = pts
    floor = min(range(len(pts)), key=lambda i: pts[i].cost)
    if floor >= len(pts) - 1:
        floor = max(0, len(pts) - 2)
    pts = pts[floor:]
    # noise floor: a rate only counts as "an increase" if it exceeds the
    # running maximum by tolerance × the curve's overall slope scale
    span_c = max(p.cost for p in pts) - min(p.cost for p in pts)
    span_s = pts[-1].task_size - pts[0].task_size
    scale_rate = span_c / span_s if span_s else 0.0
    rates: List[float] = []
    # if an amortization region was trimmed, the baseline growth at the
    # floor is zero (§1.1.1: "largest task size before the first increase
    # in the cache-miss rate"); otherwise the first segment seeds it
    max_rate: Optional[float] = 0.0 if floor > 0 else None
    knee_idx = len(pts) - 1
    reason = "no growth-rate increase observed; largest size is the knee"
    for i in range(len(pts) - 1):
        ds = pts[i + 1].task_size - pts[i].task_size
        dc = pts[i + 1].cost - pts[i].cost
        rate = dc / ds if ds else 0.0
        rates.append(rate)
        if max_rate is None:
            max_rate = rate
            continue
        threshold = max_rate + tolerance * max(abs(max_rate), scale_rate)
        if rate > threshold and rate > 0:
            knee_idx = i
            reason = (f"growth rate {rate:.3g} exceeded initial "
                      f"{max_rate:.3g} at size {pts[i + 1].task_size:.3g}")
            break
        max_rate = max(max_rate, rate)
    return KneepointResult(
        task_size=pts[knee_idx].task_size,
        index=knee_idx + floor,
        curve=tuple(all_pts),
        growth_rates=tuple(rates),
        reason=reason,
    )


def measure_curve(
    exec_task: Callable[[int], float],
    sizes: Sequence[int],
    *,
    repeats: int = 3,
) -> List[CurvePoint]:
    """Offline phase: run ``exec_task(n_samples)`` at each size, record the
    median per-sample cost.  ``exec_task`` returns its own cost metric, or
    use :func:`timed_task` to wrap a callable with wall-clock timing.
    """
    out = []
    for n in sizes:
        costs = sorted(exec_task(n) for _ in range(repeats))
        out.append(CurvePoint(task_size=float(n),
                              cost=costs[len(costs) // 2]))
    return out


def timed_task(fn: Callable[[int], None]) -> Callable[[int], float]:
    """Wrap ``fn(n_samples)`` → per-sample wall-clock seconds."""
    def run(n: int) -> float:
        t0 = time.perf_counter()
        fn(n)
        return (time.perf_counter() - t0) / max(n, 1)
    return run


# ---------------------------------------------------------------------------
# Analytic AMAT model — used where measurement is impossible (e.g. picking
# Pallas block shapes for a TPU target from a CPU container).  Mirrors the
# thesis' AMAT discussion (§3.2): t = t_hit + miss_rate(ws) · penalty.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemLevel:
    name: str
    capacity_bytes: float
    penalty: float            # extra cost per access on miss (normalized)


# TPU v5e-flavoured hierarchy: VMEM ≈ 16 MiB on-chip, then HBM.
TPU_V5E_HIERARCHY = (
    MemLevel("vmem", 16 * 2**20, 40.0),
    MemLevel("hbm", 16 * 2**30, 400.0),
)

# The thesis' Sandy Bridge node: 1.5 MB L2, 15 MB L3 (§3.2).
SANDY_BRIDGE_HIERARCHY = (
    MemLevel("l2", 1.5 * 2**20, 8.0),
    MemLevel("l3", 15 * 2**20, 63.0),
)


def amat_curve(
    working_sets: Sequence[float],
    hierarchy: Sequence[MemLevel] = SANDY_BRIDGE_HIERARCHY,
    *,
    reuse_fraction: float = 0.7,
    t_hit: float = 1.0,
) -> List[CurvePoint]:
    """Random subsampling over a working set of ``ws`` bytes: accesses that
    fall outside a level's capacity miss with probability
    ``max(0, 1 - cap/ws)`` scaled by the workload's reuse fraction
    (stack-distance argument, thesis §3.2)."""
    out = []
    for ws in working_sets:
        t = t_hit
        for level in hierarchy:
            miss = max(0.0, 1.0 - level.capacity_bytes / ws)
            t += reuse_fraction * miss * level.penalty
        out.append(CurvePoint(task_size=float(ws), cost=t))
    return out


def pack_tasks(sample_sizes: Sequence[int], knee_size: float,
               ) -> List[List[int]]:
    """Online phase: pack sample indices into tasks of ≈ knee_size bytes
    each (first-fit in input order; outliers larger than the knee become
    singleton tasks)."""
    tasks: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0.0
    for idx, sz in enumerate(sample_sizes):
        if cur and cur_bytes + sz > knee_size:
            tasks.append(cur)
            cur, cur_bytes = [], 0.0
        cur.append(idx)
        cur_bytes += sz
    if cur:
        tasks.append(cur)
    return tasks


def pack_tasks_by_count(sample_sizes: Sequence[int], knee_size: float,
                        ) -> List[List[int]]:
    """Thesis §3.2.1 packing: "the same number of samples in each task,
    assuming samples are roughly the same size" — the count is the knee
    size divided by the mean sample size.  Equal counts also keep task
    shapes uniform (one compiled kernel serves every task)."""
    n = len(sample_sizes)
    if not n:
        return []
    mean = max(1.0, float(np.mean(sample_sizes)))
    count = max(1, int(round(knee_size / mean)))
    return [list(range(i, min(i + count, n)))
            for i in range(0, n, count)]
