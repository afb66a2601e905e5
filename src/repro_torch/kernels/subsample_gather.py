"""The ``subsample_stats`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/subsample_stats.cu`` (its header
says what it replaces, what bounds it and how it is laid out).
``kernels._build`` compiles it with ``nvcc`` at first use; this module
declares its C interface and launches it on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsample_stats.cu"
MAX_ROWS_PER_STEP = 256          # kStage in the source


def _declare(lib: ctypes.CDLL) -> None:
    lib.subsample_stats_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.subsample_stats_launch.restype = ctypes.c_int
    lib.subsample_stats_error_string.argtypes = [ctypes.c_int]
    lib.subsample_stats_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def subsample_stats_wave(data: torch.Tensor, indices: torch.Tensor, *,
                         rows_per_step: int = 8) -> torch.Tensor:
    """Launch the kernel on CUDA tensors ``data [B, N, D]`` fp32 and
    ``indices [B, T]`` int32 (already checked by ``ops.subsample_stats``);
    returns ``stats [B, 2, D]`` fp32 allocated here, on PyTorch's current
    stream, without synchronising."""
    lib = library()
    bsz, n, d = data.shape
    t = indices.shape[1]
    stats = torch.empty((bsz, 2, d), dtype=torch.float32, device=data.device)
    vec = 4 if d % 4 == 0 and data.data_ptr() % 16 == 0 else 1
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        code = lib.subsample_stats_launch(
            data.data_ptr(), indices.data_ptr(), stats.data_ptr(),
            bsz, n, d, t, int(rows_per_step), vec, stream)
    if code != 0:
        raise RuntimeError(
            "subsample_stats launch failed: "
            f"{lib.subsample_stats_error_string(code).decode()} "
            f"(B={bsz}, N={n}, D={d}, T={t}, rows_per_step={rows_per_step})")
    return stats
