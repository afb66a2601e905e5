"""SLO-driven elastic scaling (thesis §4.2.3, Fig 12/13).

"Managers should scale out until additional cores provide diminishing
returns and no further": given a throughput(cores) profile and a fixed
running-time bound, pick the configuration with the highest data processed
within the bound — small jobs under tight SLOs prefer *fewer* cores because
startup costs dominate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    cores: int
    expected_throughput: float
    data_within_slo: float
    reason: str


def choose_cores(
    core_options: Sequence[int],
    throughput: Callable[[int], float],     # bytes/s at steady state
    startup: Callable[[int], float],        # job startup seconds
    slo_seconds: float,
    *,
    diminishing_threshold: float = 0.10,
) -> ScaleDecision:
    """Maximize data processed within the SLO window; refuse scale-ups that
    improve it by < diminishing_threshold (Fig 12's flat regions)."""
    best: Tuple[float, int, float] = (-1.0, 0, 0.0)
    ranked = sorted(core_options)
    for c in ranked:
        usable = max(0.0, slo_seconds - startup(c))
        data = usable * throughput(c)
        if data > best[0] * (1.0 + diminishing_threshold):
            best = (data, c, throughput(c))
    data, cores, tp = best
    return ScaleDecision(
        cores=cores, expected_throughput=tp, data_within_slo=data,
        reason=(f"{cores} cores maximize data within {slo_seconds}s SLO "
                f"(startup-adjusted); larger configs gave "
                f"<{diminishing_threshold:.0%} improvement"))


def pow2_ladder(max_value: int) -> List[int]:
    """1, 2, 4, … up to (and always including) ``max_value``."""
    out = [1 << i for i in range((max(max_value, 1)).bit_length())
           if (1 << i) <= max_value]
    if max_value not in out:
        out.append(max_value)
    return out


def choose_workers(
    max_workers: int,
    *,
    bytes_per_second_per_worker: float,
    startup_seconds: float,
    slo_seconds: float,
    diminishing_threshold: float = 0.10,
) -> ScaleDecision:
    """Pool-sizing hint for the platform driver/service: apply
    :func:`choose_cores` over a power-of-two worker ladder with a
    linear-scaling throughput model calibrated from the kneepoint
    measurement (seconds/sample at the knee → bytes/s per worker).
    Small jobs under tight SLOs land on *fewer* workers because the
    startup tax dominates (thesis Fig 12/13)."""
    return choose_cores(
        pow2_ladder(max_workers),
        lambda c: c * bytes_per_second_per_worker,
        lambda c: startup_seconds,
        slo_seconds,
        diminishing_threshold=diminishing_threshold)


def elastic_schedule(
    job_sizes: Sequence[float],
    core_options: Sequence[int],
    throughput: Callable[[int, float], float],   # (cores, job_size) → B/s
    startup: Callable[[int], float],
    slo_seconds: float,
) -> List[ScaleDecision]:
    """Per-job scaling decisions for a stream of jobs (elastic cluster)."""
    out = []
    for size in job_sizes:
        out.append(choose_cores(
            core_options, lambda c: throughput(c, size), startup,
            slo_seconds))
    return out
