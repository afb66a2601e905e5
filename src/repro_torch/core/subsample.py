"""The paper's subsampling statistics in PyTorch (thesis §3.1, Fig 1).

Samples are keyed blocks of observations (a *family's* SNP sequence for the
EAGLET workload; a *movie's* ratings for the Netflix workload).  A map task
takes a block of samples, draws ``draws`` random subsamples per sample, and
computes a statistic from each draw; reduce combines the per-task partials
into the job result (the ALOD curve / per-month rating means).

:func:`map_task` is the statistic as plain torch ops on whatever device its
tensors lie on; it is also the plain version of the hand-written CUDA
kernel behind :func:`repro_torch.kernels.ops.subsample_grid`.
:func:`map_wave` is the device pipeline the platform runs: one kernel
launch for the whole wave, which draws each task's indices from its seed
(jax's exact draws, as :mod:`repro_torch.prng` gives them) and reads the
block arena through the wave's slot vector.  The kernel adds in a fixed
order, so a task's partial does not depend on the wave it ran in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.device import check_device
from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class SubsampleWorkload:
    name: str                 # "eaglet" | "netflix_high" | "netflix_low"
    statistic: str            # "alod" | "monthly_mean"
    draws: int                # subsamples per sample (EAGLET: 30)
    draw_size: int            # observations per subsample
    grid: int = 64            # output curve resolution (ALOD grid / months)


EAGLET = SubsampleWorkload("eaglet", "alod", draws=30, draw_size=256,
                           grid=64)
# High confidence: two orders of magnitude more ratings than low (§4.1.1.2)
NETFLIX_HIGH = SubsampleWorkload("netflix_high", "monthly_mean", draws=8,
                                 draw_size=2048, grid=120)
NETFLIX_LOW = SubsampleWorkload("netflix_low", "monthly_mean", draws=8,
                                draw_size=32, grid=120)

WORKLOADS = {w.name: w for w in (EAGLET, NETFLIX_HIGH, NETFLIX_LOW)}


# ---------------------------------------------------------------------------
# Map task
# ---------------------------------------------------------------------------


def draw_indices(keys: torch.Tensor, ns: int, sl: int, *, draws: int,
                 draw_size: int) -> torch.Tensor:
    """A task's subsample positions, ``jax.random.randint(key, (draws, ns,
    draw_size), 0, sl)`` bit for bit: int32 ``[draws, ns, draw_size]`` for
    one key ``[2]``, ``[B, draws, ns, draw_size]`` for keys ``[B, 2]``."""
    return prng.randint(keys, (draws, ns, draw_size), 0, sl)


def map_task(data: torch.Tensor, months: torch.Tensor, key: torch.Tensor,
             *, draws: int, draw_size: int, grid: int,
             statistic: str) -> Dict[str, torch.Tensor]:
    """Subsample each sample ``draws`` times and compute the statistic.

    ``data [n_samples, sample_len]`` float32 and ``months`` of the same
    shape (int32; read by ``monthly_mean`` only) lie on one device, with
    ``key`` a :func:`repro_torch.prng.PRNGKey`.  Returns partials suitable
    for tree reduction:
      alod:          {"sum_curve": [grid], "hits": [grid], "count": []}
      monthly_mean:  {"sum": [grid], "count": [grid]}
    """
    ns, sl = data.shape
    idx = draw_indices(key.to(data.device), ns, sl, draws=draws,
                       draw_size=draw_size)
    out = ref.grid_partial(data, months, idx, grid=grid, statistic=statistic)
    if statistic == "alod":
        return {"sum_curve": out[0], "hits": out[1],
                "count": torch.tensor(float(ns * draws),
                                      device=data.device)}
    return {"sum": out[0], "count": out[1]}


def map_wave(data: torch.Tensor, months: torch.Tensor,
             rows: Sequence[int], seeds: Sequence[int],
             wl: SubsampleWorkload) -> torch.Tensor:
    """One wave on the device: ``data [n_slots, ns, sl]`` fp32 and
    ``months`` of the same shape, int32 (read by ``monthly_mean`` only),
    are the resident arena bucket; task ``b`` is slot ``rows[b]`` with seed
    ``seeds[b]``.  One ``subsample_grid_seeded`` launch, which draws each
    task's indices from its seed (jax's exact draws) → ``[B, 2, grid]``
    fp32 on the device."""
    device = data.device
    rows_t = torch.from_numpy(np.asarray(rows, np.int32)).to(device)
    seeds_t = torch.from_numpy(np.asarray(seeds, np.int32)).to(device)
    return ops.subsample_grid_seeded(data, months, rows_t, seeds_t,
                                     draws=wl.draws, draw_size=wl.draw_size,
                                     grid=wl.grid, statistic=wl.statistic)


def split_partials(stats: np.ndarray, wl: SubsampleWorkload,
                   ns: int) -> List[Dict[str, np.ndarray]]:
    """``[B, 2, grid]`` kernel output on the host → per-task reduce-tree
    partials with the reference's keys."""
    if wl.statistic == "alod":
        count = np.asarray(float(ns * wl.draws), np.float32)
        return [{"sum_curve": s[0], "hits": s[1], "count": count}
                for s in stats]
    return [{"sum": s[0], "count": s[1]} for s in stats]


def run_map_task_np(data: np.ndarray, months: np.ndarray, seed: int,
                    wl: SubsampleWorkload, *,
                    device="cuda") -> Dict[str, np.ndarray]:
    """One task as a wave of one through :func:`map_wave` on ``device``;
    returns numpy partials."""
    dev = check_device(device)
    block = torch.from_numpy(np.ascontiguousarray(data, np.float32))
    mo = torch.from_numpy(np.ascontiguousarray(months, np.int32))
    stats = map_wave(block.to(dev)[None], mo.to(dev)[None], [0], [seed], wl)
    return split_partials(stats.cpu().numpy(), wl, data.shape[0])[0]


def reduce_stats(partials: Sequence[Dict[str, np.ndarray]],
                 statistic: str) -> Dict[str, np.ndarray]:
    """Combine per-task partials (the reduce stage)."""
    acc = {key: np.asarray(partials[0][key]) for key in partials[0]}
    for part in partials[1:]:
        acc = {key: acc[key] + np.asarray(part[key]) for key in acc}
    if statistic == "alod":
        curve = acc["sum_curve"] / np.maximum(acc["hits"], 1.0)
        return {"alod": curve, "n": float(acc["count"])}
    mean = acc["sum"] / np.maximum(acc["count"], 1.0)
    return {"monthly_mean": mean, "count": acc["count"]}


# ---------------------------------------------------------------------------
# Exhaustive references (accuracy-vs-speed tradeoff measurements)
# ---------------------------------------------------------------------------


def exhaustive_monthly_mean(data: np.ndarray, months: np.ndarray,
                            grid: int) -> np.ndarray:
    sums = np.zeros(grid)
    cnts = np.zeros(grid)
    m = np.clip(months, 0, grid - 1)
    np.add.at(sums, m.reshape(-1), data.reshape(-1))
    np.add.at(cnts, m.reshape(-1), 1.0)
    return sums / np.maximum(cnts, 1.0)
