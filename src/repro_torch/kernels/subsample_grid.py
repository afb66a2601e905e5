"""The ``subsample_grid`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/subsample_grid.cu`` (its header
says what it computes, what bounds it and how its sums keep one order),
with jax's threefry draws in ``csrc/threefry.cuh``.  ``kernels._build``
compiles it with ``nvcc`` at first use; this module declares its three C
entries (indices read, indices drawn from seeds, and the draws alone)
and launches them on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import prng
from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsample_grid.cu"
MAX_GRID = 512                   # kMaxGrid in the source
STATISTICS = {"alod": 0, "monthly_mean": 1}


def _declare(lib: ctypes.CDLL) -> None:
    lib.subsample_grid_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.subsample_grid_seeded_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_uint32, ctypes.c_void_p])
    lib.threefry_randint_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
        + [ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p])
    for entry in (lib.subsample_grid_launch, lib.subsample_grid_seeded_launch,
                  lib.threefry_randint_launch):
        entry.restype = ctypes.c_int
    lib.subsample_grid_error_string.argtypes = [ctypes.c_int]
    lib.subsample_grid_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary(SOURCE, _declare)


def _raise_on(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.subsample_grid_error_string(code).decode()}")


def _grid_call(entry, data, months, rows, src, draws, ds, grid, statistic,
               *extra):
    """Launch ``entry`` (read or seeded) with ``src`` (idx or seeds) and
    return ``[B, 2, grid]`` fp32 with its per-sample scratch."""
    lib = LIBRARY.load()
    _, ns, sl = data.shape
    bsz = rows.shape[0]
    out = torch.empty((bsz, 2, grid), dtype=torch.float32, device=data.device)
    scratch = torch.empty((bsz, ns, 2, grid), dtype=torch.float32,
                          device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        code = getattr(lib, entry)(
            data.data_ptr(), months.data_ptr(), rows.data_ptr(),
            src.data_ptr(), scratch.data_ptr(), out.data_ptr(), bsz, ns, sl,
            draws, ds, grid, STATISTICS[statistic], *extra, stream)
    _raise_on(lib, code, f"{entry} (B={bsz}, ns={ns}, sl={sl}, "
              f"draws={draws}, ds={ds}, grid={grid}, statistic={statistic})")
    return out


def subsample_grid(data: torch.Tensor, months: torch.Tensor,
                   rows: torch.Tensor, idx: torch.Tensor, *, grid: int,
                   statistic: str) -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by
    ``ops.subsample_grid``: ``data [n_slots, ns, sl]`` fp32, ``months`` of
    the same shape int32, ``rows [B]`` and ``idx [B, draws, ns, ds]``
    int32.  Returns ``[B, 2, grid]`` fp32 allocated here,
    with its per-sample scratch, on PyTorch's current stream, without
    synchronising."""
    _, draws, _, ds = idx.shape
    return _grid_call("subsample_grid_launch", data, months, rows, idx,
                      draws, ds, grid, statistic)


def subsample_grid_seeded(data: torch.Tensor, months: torch.Tensor,
                          rows: torch.Tensor, seeds: torch.Tensor, *,
                          draws: int, draw_size: int, grid: int,
                          statistic: str) -> torch.Tensor:
    """The same with task ``b``'s indices drawn in the kernel:
    ``jax.random.randint(PRNGKey(seeds[b]), (draws, ns, draw_size), 0,
    sl)`` for ``seeds [B]`` int32, checked by
    ``ops.subsample_grid_seeded``.  Returns ``[B, 2, grid]`` fp32."""
    _, multiplier = prng._randint_multiplier(0, data.shape[2])
    return _grid_call("subsample_grid_seeded_launch", data, months, rows,
                      seeds, draws, draw_size, grid, statistic, multiplier)


def threefry_randint(seeds: torch.Tensor, n: int, lo: int,
                     hi: int) -> torch.Tensor:
    """``jax.random.randint(PRNGKey(seed), (n,), lo, hi, int32)`` for each
    of the CUDA ``seeds [B]`` int32 (checked by ``ops.randint``) →
    ``[B, n]`` int32, drawn by the kernel's own threefry."""
    lib = LIBRARY.load()
    span, multiplier = prng._randint_multiplier(lo, hi)
    bsz = seeds.shape[0]
    out = torch.empty((bsz, n), dtype=torch.int32, device=seeds.device)
    stream = torch.cuda.current_stream(seeds.device).cuda_stream
    with torch.cuda.device(seeds.device):
        code = lib.threefry_randint_launch(
            seeds.data_ptr(), out.data_ptr(), bsz, n, int(lo), span,
            multiplier, stream)
    _raise_on(lib, code, f"threefry_randint (B={bsz}, n={n}, lo={lo}, "
              f"hi={hi})")
    return out
