"""The ``subsample_stats`` and ``subsample_gather`` Hopper kernels:
build, load and launch.

The kernels themselves are CUDA C++ in ``csrc/subsample_stats.cu`` and
``csrc/subsample_gather.cu`` (each header says what it replaces, what
bounds it and how it is laid out); ``subsample_stats.cu`` draws jax's
indices with ``csrc/threefry.cuh``.  ``kernels._build`` compiles each
with ``nvcc`` at first use; this module declares their C interfaces and
launches them on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import prng
from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsample_stats.cu"
GATHER_SOURCE = SOURCE.with_name("subsample_gather.cu")
MAX_ROWS_PER_STEP = 256          # kMaxRowsPerStep in the source


def _declare(lib: ctypes.CDLL) -> None:
    lib.subsample_stats_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4
        + [ctypes.c_int, ctypes.c_void_p])
    lib.subsample_stats_seeded_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4
        + [ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p])
    for entry in (lib.subsample_stats_launch,
                  lib.subsample_stats_seeded_launch):
        entry.restype = ctypes.c_int
    lib.subsample_stats_tile_cols.argtypes = (
        [ctypes.c_int64] * 3 + [ctypes.c_void_p])
    lib.subsample_stats_tile_cols.restype = ctypes.c_int64
    lib.subsample_stats_error_string.argtypes = [ctypes.c_int]
    lib.subsample_stats_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)
library = LIBRARY.load
build_info = LIBRARY.info


def _stats_call(entry: str, data: torch.Tensor, ptrs, bsz: int, t: int,
                rows_per_step: int, extra=()) -> torch.Tensor:
    """Launch ``entry`` (read or seeded) on ``data [S, N, D]`` with the
    pointers ``ptrs`` (indices, or slots and seeds) and return ``stats
    [bsz, 2, D]`` fp32, allocated here."""
    lib = library()
    _, n, d = data.shape
    stats = torch.empty((bsz, 2, d), dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        code = getattr(lib, entry)(
            data.data_ptr(), *ptrs, stats.data_ptr(), bsz, n, d, t,
            int(rows_per_step), *extra, stream)
    if code != 0:
        raise RuntimeError(
            f"{entry} failed: {lib.subsample_stats_error_string(code).decode()}"
            f" (B={bsz}, N={n}, D={d}, T={t}, rows_per_step={rows_per_step})")
    return stats


def subsample_stats_wave(data: torch.Tensor, indices: torch.Tensor, *,
                         rows_per_step: int = 8) -> torch.Tensor:
    """Launch the read form on CUDA tensors ``data [B, N, D]`` fp32 and
    ``indices [B, T]`` int32 (already checked by ``ops.subsample_stats``);
    returns ``stats [B, 2, D]`` fp32 allocated here, on PyTorch's current
    stream, without synchronising."""
    bsz, t = indices.shape
    return _stats_call("subsample_stats_launch", data, [indices.data_ptr()],
                       bsz, t, rows_per_step)


def subsample_stats_seeded(arena: torch.Tensor, rows: torch.Tensor,
                           seeds: torch.Tensor, *, n_idx: int,
                           rows_per_step: int = 8) -> torch.Tensor:
    """Launch the draw form: task ``b`` reads ``arena[rows[b]]`` of the
    CUDA ``arena [S, N, D]`` fp32 in place, its ``n_idx`` indices
    ``jax.random.randint(PRNGKey(seeds[b]), (n_idx,), 0, N)`` drawn in the
    kernel; ``rows``, ``seeds [B]`` int32, checked by
    ``ops.subsample_stats_seeded``.  Returns ``stats [B, 2, D]`` fp32."""
    _, multiplier = prng._randint_multiplier(0, arena.shape[1])
    return _stats_call("subsample_stats_seeded_launch", arena,
                       [rows.data_ptr(), seeds.data_ptr()], rows.shape[0],
                       n_idx, rows_per_step, (multiplier,))


def tile_cols(data: torch.Tensor, t: int) -> int:
    """The staged body's tile width for the blocks of CUDA ``data [S, N,
    D]`` and ``t`` indices a task, or 0 where a launch takes the global
    body (the source's own rule)."""
    _, n, d = data.shape
    return int(library().subsample_stats_tile_cols(n, d, t, data.data_ptr()))


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
