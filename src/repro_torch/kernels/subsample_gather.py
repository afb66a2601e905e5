"""The ``subsample_stats`` and ``subsample_gather`` Hopper kernels:
build, load and launch.

The kernels themselves are CUDA C++ in ``csrc/subsample_stats.cu`` and
``csrc/subsample_gather.cu`` (each header says what it replaces, what
bounds it and how it is laid out).  ``kernels._build`` compiles each with
``nvcc`` at first use; this module declares their C interfaces and
launches them on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsample_stats.cu"
GATHER_SOURCE = SOURCE.with_name("subsample_gather.cu")
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


def _declare_gather(lib: ctypes.CDLL) -> None:
    lib.subsample_gather_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.subsample_gather_launch.restype = ctypes.c_int
    lib.subsample_gather_error_string.argtypes = [ctypes.c_int]
    lib.subsample_gather_error_string.restype = ctypes.c_char_p


GATHER_LIBRARY = KernelLibrary(GATHER_SOURCE, _declare_gather)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def subsample_gather(data: torch.Tensor, indices: torch.Tensor,
                     n_valid: torch.Tensor):
    """Launch the kernel on CUDA tensors already checked by
    ``ops._subsample_gather_padded``: ``data [N, D]`` fp32 or bf16,
    ``indices [T]`` and ``n_valid [1]`` int32.  Returns ``(gathered [T,
    D]`` in the data's type``, stats [2, D]`` fp32``)`` allocated here, on
    PyTorch's current stream, without synchronising."""
    lib = GATHER_LIBRARY.load()
    n, d = data.shape
    t = indices.shape[0]
    gathered = torch.empty((t, d), dtype=data.dtype, device=data.device)
    stats = torch.empty((2, d), dtype=torch.float32, device=data.device)
    vec = 4 if d % 4 == 0 and data.data_ptr() % 16 == 0 else 1
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        code = lib.subsample_gather_launch(
            data.data_ptr(), indices.data_ptr(), n_valid.data_ptr(),
            gathered.data_ptr(), stats.data_ptr(), n, d, t,
            _DTYPE_CODES[data.dtype], vec, stream)
    if code != 0:
        raise RuntimeError(
            "subsample_gather launch failed: "
            f"{lib.subsample_gather_error_string(code).decode()} "
            f"(N={n}, D={d}, T={t}, dtype={data.dtype})")
    return gathered, stats
