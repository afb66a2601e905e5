"""Public wrappers around the port's kernels.

A wrapper launches its hand-written kernel when its tensors lie on the
card and runs the kernel's plain PyTorch version (``kernels.ref``) when
they lie on the CPU.  It never falls back from one to the other: a CUDA
tensor that the kernel cannot take, or a build or launch that fails,
raises.  Each wrapper counts its kernel launches, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import subsample_gather as _sg

_count_lock = threading.Lock()
_launches = 0            # subsample_stats kernel launches since the reset


def launch_count() -> int:
    """Kernel launches of :func:`subsample_stats` since the last reset."""
    with _count_lock:
        return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def _check_subsample_stats(data: torch.Tensor, indices: torch.Tensor,
                           rows_per_step: int) -> None:
    if data.dim() != 3 or indices.dim() != 2:
        raise ValueError(
            "subsample_stats takes data [B, N, D] and indices [B, T]; got "
            f"{tuple(data.shape)} and {tuple(indices.shape)}")
    if data.shape[0] != indices.shape[0]:
        raise ValueError(f"batch mismatch: data has {data.shape[0]} tasks, "
                         f"indices {indices.shape[0]}")
    if data.dtype != torch.float32:
        raise TypeError(f"subsample_stats takes fp32 data, got {data.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(
            f"subsample_stats takes int32 indices, got {indices.dtype}")
    if data.device != indices.device:
        raise ValueError(f"data on {data.device}, indices on "
                         f"{indices.device}")
    if not (data.is_contiguous() and indices.is_contiguous()):
        raise ValueError("subsample_stats takes contiguous tensors")
    if not 1 <= rows_per_step <= _sg.MAX_ROWS_PER_STEP:
        raise ValueError(f"rows_per_step must lie in [1, "
                         f"{_sg.MAX_ROWS_PER_STEP}], got {rows_per_step}")


def subsample_stats(data: torch.Tensor, indices: torch.Tensor, *,
                    rows_per_step: int = 8) -> torch.Tensor:
    """Stats-only wave gather: ``data [B, N, D]`` fp32 + ``indices [B, T]``
    int32 → ``stats [B, 2, D]`` fp32, each task's (Σ row, Σ row²) over its
    gathered rows; no gathered array is written.  One launch per wave.
    Every index must lie in ``[0, N)``."""
    global _launches
    _check_subsample_stats(data, indices, rows_per_step)
    if not data.is_cuda:
        return ref.subsample_stats_ref(data, indices,
                                       rows_per_step=rows_per_step)
    out = _sg.subsample_stats_wave(data, indices,
                                   rows_per_step=rows_per_step)
    with _count_lock:
        _launches += 1
    return out
