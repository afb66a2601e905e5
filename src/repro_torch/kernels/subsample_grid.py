"""The ``subsample_grid`` Hopper kernel: build, load and launch.

The kernel itself is CUDA C++ in ``csrc/subsample_grid.cu`` (its header
says what it computes, what bounds it and how its sums keep one order),
with jax's threefry draws in ``csrc/threefry.cuh``.  ``kernels._build``
compiles it with ``nvcc`` at first use; this module declares its three C
entries (indices read, indices drawn from seeds, and the draws alone)
and launches them on PyTorch's current stream.

:func:`plan` fixes how a shape is cut and which body runs it; the kernel
runs what it is told.  The summation order depends on the plan's
``groups`` and ``copies`` alone, and both are fixed by the shape (never
by the wave width or the body), so the two bodies, the two index forms
and every wave width give the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch import prng
from repro_torch.kernels._build import KernelLibrary

SOURCE = Path(__file__).resolve().parent / "csrc" / "subsample_grid.cu"
MAX_GRID = 512                   # kMaxGrid in the source
STATISTICS = {"alod": 0, "monthly_mean": 1}
BODIES = {"direct": 0, "staged": 1}
WARPS = 8                        # kWarps: a CTA's warps
BATCH = 8                        # kBatch: indices a lane draws before loading
MAX_SMEM = 232448 - 128          # kMaxSmem: a CTA's dynamic shared memory
MAX_STAGED_GRID = 256            # kMaxStagedGrid: staged months are bytes
BIN_BUDGET = 48 * 1024           # a CTA's bin copies: four CTAs an SM
# monthly_mean: drawn elements a CTA takes, in the direct body (enough CTAs
# at a wave of one to fill the card) and in the staged body (fewer CTAs,
# each of which copies the whole row in)
DIRECT_CTA_ELEMENTS = 4096
STAGED_CTA_ELEMENTS = 8192


@dataclass(frozen=True)
class Plan:
    """How ``subsample_grid`` cuts a shape: ``body`` ("direct" or
    "staged"), ``groups`` CTAs a (task, sample), ``copies`` bin copies a
    warp."""
    body: str
    groups: int
    copies: int


def copies_for(grid: int) -> int:
    """Bin copies a warp: the most, up to 32 (one a lane), whose sums and
    counts for ``WARPS`` warps fit ``BIN_BUDGET``."""
    copies = 32
    while copies > 1 and 8 * WARPS * grid * copies > BIN_BUDGET:
        copies //= 2
    return copies


def staged_bytes(sl: int, grid: int) -> int:
    """Dynamic shared memory of a staged CTA: the bins, the row's fp32
    values and its months as bytes."""
    return 8 * WARPS * grid * copies_for(grid) + 5 * sl


def stageable(sl: int, grid: int, statistic: str) -> bool:
    """Whether a row of ``sl`` fits the staged body by shape.  Only
    ``monthly_mean`` is staged: ``alod``'s rows (EAGLET's, 1-8 MB) never
    fit."""
    return (statistic == "monthly_mean" and sl % 4 == 0
            and grid <= MAX_STAGED_GRID
            and staged_bytes(sl, grid) <= MAX_SMEM)


@functools.lru_cache(maxsize=256)
def plan(sl: int, draws: int, draw_size: int, grid: int, statistic: str,
         body: str = "auto", aligned: bool = True) -> Plan:
    """The cut of a shape, from ``(sl, draws, draw_size, grid,
    statistic)`` alone.  The staged body pays where the row fits and a
    row has at least as many draws as elements (measured on the card:
    PERF.md §6); ``groups`` follows that choice, so forcing the other
    ``body`` keeps the same order.  ``aligned``: the data (and
    months) start on 16 bytes, which the staged body's copies need; "auto"
    takes the direct body where they do not.  Raises ``ValueError`` for a
    forced staged body that cannot run.  Cached: the waves of a job call it
    with a few shapes, once a launch."""
    if body not in ("auto", *BODIES):
        raise ValueError(f"unknown body {body!r}")
    n_e = draws * draw_size
    fits = stageable(sl, grid, statistic)
    pays = fits and n_e >= sl
    if statistic == "alod":
        groups = max(1, math.ceil(draws / WARPS))
    else:
        per_cta = STAGED_CTA_ELEMENTS if pays else DIRECT_CTA_ELEMENTS
        groups = max(1, math.ceil(n_e / per_cta))
    if body == "auto":
        body = "staged" if pays and aligned else "direct"
    elif body == "staged" and not (fits and aligned):
        raise ValueError(f"the staged body cannot take sl={sl}, grid={grid}"
                         f", {statistic} (aligned={aligned})")
    return Plan(body, groups, copies_for(grid))


def _declare(lib: ctypes.CDLL) -> None:
    lib.subsample_grid_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
        + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.subsample_grid_seeded_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
        + [ctypes.c_int] * 7 + [ctypes.c_uint32, ctypes.c_void_p])
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


def _is_aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def plan_for(data: torch.Tensor, months: torch.Tensor, draws: int, ds: int,
             grid: int, statistic: str, body: str = "auto") -> Plan:
    """:func:`plan` for the arena ``data [n_slots, ns, sl]`` (and
    ``months``), its alignment included."""
    planes = (data, months) if statistic == "monthly_mean" else (data,)
    return plan(data.shape[2], draws, ds, grid, statistic, body,
                aligned=_is_aligned(*planes))


def _grid_call(entry, data, months, rows, src, draws, ds, grid, statistic,
               body, *extra):
    """Launch ``entry`` (read or seeded) with ``src`` (idx or seeds) and
    return ``[B, 2, grid]`` fp32 with its per-CTA scratch."""
    lib = LIBRARY.load()
    _, ns, sl = data.shape
    bsz = rows.shape[0]
    cut = plan_for(data, months, draws, ds, grid, statistic, body)
    out = torch.empty((bsz, 2, grid), dtype=torch.float32, device=data.device)
    scratch = torch.empty((bsz, ns, cut.groups, 2, grid),
                          dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        code = getattr(lib, entry)(
            data.data_ptr(), months.data_ptr(), rows.data_ptr(),
            src.data_ptr(), scratch.data_ptr(), out.data_ptr(), bsz, ns, sl,
            draws, ds, grid, STATISTICS[statistic], BODIES[cut.body],
            cut.groups, cut.copies, *extra, stream)
    _raise_on(lib, code, f"{entry} (B={bsz}, ns={ns}, sl={sl}, "
              f"draws={draws}, ds={ds}, grid={grid}, statistic={statistic}, "
              f"{cut})")
    return out


def subsample_grid(data: torch.Tensor, months: torch.Tensor,
                   rows: torch.Tensor, idx: torch.Tensor, *, grid: int,
                   statistic: str, body: str = "auto") -> torch.Tensor:
    """Launch the kernel on CUDA tensors already checked by
    ``ops.subsample_grid``: ``data [n_slots, ns, sl]`` fp32, ``months`` of
    the same shape int32, ``rows [B]`` and ``idx [B, draws, ns, ds]``
    int32.  Returns ``[B, 2, grid]`` fp32 allocated here,
    with its per-CTA scratch, on PyTorch's current stream, without
    synchronising.  ``body`` forces "direct" or "staged" (tests and
    ``chip_smoke.py`` hold the two against each other); "auto" is
    :func:`plan`'s choice."""
    _, draws, _, ds = idx.shape
    return _grid_call("subsample_grid_launch", data, months, rows, idx,
                      draws, ds, grid, statistic, body)


def subsample_grid_seeded(data: torch.Tensor, months: torch.Tensor,
                          rows: torch.Tensor, seeds: torch.Tensor, *,
                          draws: int, draw_size: int, grid: int,
                          statistic: str, body: str = "auto") -> torch.Tensor:
    """The same with task ``b``'s indices drawn in the kernel:
    ``jax.random.randint(PRNGKey(seeds[b]), (draws, ns, draw_size), 0,
    sl)`` for ``seeds [B]`` int32, checked by
    ``ops.subsample_grid_seeded``.  Returns ``[B, 2, grid]`` fp32."""
    _, multiplier = prng._randint_multiplier(0, data.shape[2])
    return _grid_call("subsample_grid_seeded_launch", data, months, rows,
                      seeds, draws, draw_size, grid, statistic, body,
                      multiplier)


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
