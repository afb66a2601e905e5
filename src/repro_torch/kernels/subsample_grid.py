"""The ``subsample_grid`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/subsample_grid.cu`` (its header
says what it computes, what bounds it and how its sums keep one order).
``kernels._build`` compiles it with ``nvcc`` at first use; this module
declares its C interface and launches it on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsample_grid.cu"
MAX_GRID = 512                   # kMaxGrid in the source
STATISTICS = {"alod": 0, "monthly_mean": 1}


def _declare(lib: ctypes.CDLL) -> None:
    lib.subsample_grid_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.subsample_grid_launch.restype = ctypes.c_int
    lib.subsample_grid_error_string.argtypes = [ctypes.c_int]
    lib.subsample_grid_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)


def subsample_grid(data: torch.Tensor, months: torch.Tensor,
                   rows: torch.Tensor, idx: torch.Tensor, *, grid: int,
                   statistic: str) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by
    ``ops.subsample_grid``: ``data [n_slots, ns, sl]`` fp32, ``months`` of
    the same shape int32, ``rows [B]`` and ``idx [B, draws, ns, ds]``
    int32.  Returns ``[B, 2, grid]`` fp32 allocated here,
    with its per-sample scratch, on PyTorch's current stream, without
    synchronising."""
    lib = LIBRARY.load()
    _, ns, sl = data.shape
    bsz, draws, _, ds = idx.shape
    out = torch.empty((bsz, 2, grid), dtype=torch.float32, device=data.device)
    scratch = torch.empty((bsz, ns, 2, grid), dtype=torch.float32,
                          device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        code = lib.subsample_grid_launch(
            data.data_ptr(), months.data_ptr(), rows.data_ptr(),
            idx.data_ptr(), scratch.data_ptr(), out.data_ptr(), bsz, ns, sl,
            draws, ds, grid, STATISTICS[statistic], stream)
    if code != 0:
        raise RuntimeError(
            "subsample_grid launch failed: "
            f"{lib.subsample_grid_error_string(code).decode()} "
            f"(B={bsz}, ns={ns}, sl={sl}, draws={draws}, ds={ds}, "
            f"grid={grid}, statistic={statistic})")
    return out
