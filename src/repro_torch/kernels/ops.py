"""Public wrappers around the port's kernels.

A wrapper launches its hand-written kernel when its tensors lie on the
card and runs the kernel's plain PyTorch version (``kernels.ref``) when
they lie on the CPU.  It never falls back from one to the other: a CUDA
tensor that the kernel cannot take, or a build or launch that fails,
raises.  Each wrapper counts its kernel launches, so a run can show that
its main path went through the kernel.

``attention_decode_int8`` is one decode step's attention over an int8 KV
cache; it returns the new cache beside its output and leaves the old one
untouched, as the model's decode does.

``flash_attention``, ``rwkv6_chunked``, ``rglru_scan`` and
``rglru_gated_scan`` are differentiable: with grad on and an input that
requires it, each runs as a ``torch.autograd.Function`` whose forward
saves what its backward reads (attention's log-sum-exp, the RWKV6 states
entering every chunk, the RG-LRU's output) and whose backward is a kernel
of its own (:func:`flash_attention_bwd`, :func:`rwkv6_chunked_bwd`,
:func:`rglru_scan_bwd` and :func:`rglru_gated_scan_bwd`): hand-written on
the card, the plain version on the CPU.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.kernels import attention_decode_int8 as _ad
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import rglru_scan_bwd as _rgb
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import rwkv6_scan_bwd as _rwb
from repro_torch.kernels import subsample_gather as _sg
from repro_torch.kernels import subsample_grid as _sgrid

KERNELS = ("subsample_stats", "rwkv6_chunked", "rglru_scan",
           "flash_attention", "subsample_gather", "subsample_grid",
           "threefry_randint", "flash_attention_bwd", "rwkv6_chunked_bwd",
           "rglru_scan_bwd", "attention_decode_int8")

_COUNTERS = 2 ** 32                      # flat positions a threefry key draws
_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)    # kernel launches since the reset


def launch_count(name: str = "subsample_stats") -> int:
    """Launches of the kernel ``name`` (one of :data:`KERNELS`) since the
    last reset."""
    with _count_lock:
        return _launches[name]


def reset_launch_count() -> None:
    """Set every kernel's launch count to 0."""
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def _counted(name: str) -> None:
    with _count_lock:
        _launches[name] += 1


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    _check_subsample_stats(data, indices, rows_per_step)
    if not data.is_cuda:
        return ref.subsample_stats_ref(data, indices,
                                       rows_per_step=rows_per_step)
    out = _sg.subsample_stats_wave(data, indices,
                                   rows_per_step=rows_per_step)
    _counted("subsample_stats")
    return out


def _check_subsample_stats_seeded(arena: torch.Tensor, rows: torch.Tensor,
                                  seeds: torch.Tensor, n_idx: int,
                                  rows_per_step: int) -> None:
    if arena.dim() != 3 or rows.dim() != 1:
        raise ValueError(
            "subsample_stats_seeded takes arena [S, N, D] and rows [B]; got "
            f"{tuple(arena.shape)} and {tuple(rows.shape)}")
    if tuple(seeds.shape) != tuple(rows.shape):
        raise ValueError(f"seeds must be [B] = [{rows.shape[0]}], got "
                         f"{tuple(seeds.shape)}")
    if arena.dtype != torch.float32:
        raise TypeError(f"subsample_stats_seeded takes an fp32 arena, got "
                        f"{arena.dtype}")
    if rows.dtype != torch.int32 or seeds.dtype != torch.int32:
        raise TypeError("subsample_stats_seeded takes int32 rows and seeds; "
                        f"got {rows.dtype} and {seeds.dtype}")
    if rows.device != arena.device or seeds.device != arena.device:
        raise ValueError(f"arena on {arena.device}, rows on {rows.device}, "
                         f"seeds on {seeds.device}")
    if not all(t.is_contiguous() for t in (arena, rows, seeds)):
        raise ValueError("subsample_stats_seeded takes contiguous tensors")
    if not 1 <= rows_per_step <= _sg.MAX_ROWS_PER_STEP:
        raise ValueError(f"rows_per_step must lie in [1, "
                         f"{_sg.MAX_ROWS_PER_STEP}], got {rows_per_step}")
    if not 0 <= n_idx < _COUNTERS:
        raise ValueError(f"n_idx must lie in [0, 2**32), got {n_idx}")
    if arena.shape[1] < 1:
        raise ValueError("subsample_stats_seeded draws rows from [0, N) and "
                         f"needs N >= 1; got arena {tuple(arena.shape)}")
    if rows.numel():
        lo, hi = torch.stack(torch.aminmax(rows)).tolist()
        if lo < 0 or hi >= arena.shape[0]:
            raise ValueError(f"rows must lie in [0, {arena.shape[0]}); got "
                             f"[{lo}, {hi}]")


def subsample_stats_seeded(arena: torch.Tensor, rows: torch.Tensor,
                           seeds: torch.Tensor, *, n_idx: int,
                           rows_per_step: int = 8) -> torch.Tensor:
    """:func:`subsample_stats` of a wave read through its slots, with each
    task's indices drawn from its seed: task ``b`` is block
    ``arena[rows[b]]`` of ``arena [S, N, D]`` fp32, its indices
    ``jax.random.randint(PRNGKey(seeds[b]), (n_idx,), 0, N)`` for ``rows,
    seeds [B]`` int32, bit for bit (:mod:`repro_torch.prng`) → ``stats [B,
    2, D]`` fp32.  On the card the kernel reads the arena in place and
    draws the indices itself; on the CPU the plain version draws them with
    :func:`repro_torch.prng.randint`.  Either way task ``b``'s stats are
    :func:`subsample_stats`' on ``arena[rows[b]]`` and those indices, bit
    for bit.  Every row must lie in ``[0, S)``.  Counts as a
    ``subsample_stats`` launch."""
    _check_subsample_stats_seeded(arena, rows, seeds, n_idx, rows_per_step)
    if not arena.is_cuda:
        return ref.subsample_stats_seeded_ref(arena, rows, seeds, n_idx=n_idx,
                                              rows_per_step=rows_per_step)
    out = _sg.subsample_stats_seeded(arena, rows, seeds, n_idx=n_idx,
                                     rows_per_step=rows_per_step)
    _counted("subsample_stats")
    return out


_FLOATS = (torch.float32, torch.bfloat16)


def _check_subsample_gather(data: torch.Tensor, indices: torch.Tensor,
                            n_valid: torch.Tensor) -> None:
    if data.dim() != 2 or indices.dim() != 1:
        raise ValueError(
            "subsample_gather takes data [N, D] and indices [T]; got "
            f"{tuple(data.shape)} and {tuple(indices.shape)}")
    if tuple(n_valid.shape) != (1,):
        raise ValueError(f"n_valid must be [1], got {tuple(n_valid.shape)}")
    if data.dtype not in _FLOATS:
        raise TypeError(
            f"subsample_gather takes fp32 or bf16 data, got {data.dtype}")
    if indices.dtype != torch.int32 or n_valid.dtype != torch.int32:
        raise TypeError("subsample_gather takes int32 indices and n_valid; "
                        f"got {indices.dtype} and {n_valid.dtype}")
    if indices.device != data.device or n_valid.device != data.device:
        raise ValueError(f"data on {data.device}, indices on "
                         f"{indices.device}, n_valid on {n_valid.device}")
    if not all(t.is_contiguous() for t in (data, indices, n_valid)):
        raise ValueError("subsample_gather takes contiguous tensors")
    if indices.numel() and data.shape[0] == 0:
        raise ValueError("subsample_gather has indices but no data rows")


def _subsample_gather_padded(data: torch.Tensor, indices: torch.Tensor,
                             n_valid: torch.Tensor):
    """The TPU kernel's own contract: ``data [N, D]`` fp32 or bf16,
    ``indices [T]`` int32 and ``n_valid [1]`` int32 (on the data's device)
    → ``(gathered [T, D]`` in the data's type``, stats [2, D]`` fp32``)``.
    Every row is gathered; only the rows ``t < n_valid`` count in
    ``stats = (Σ row, Σ row²)``.  Every index must lie in ``[0, N)``."""
    _check_subsample_gather(data, indices, n_valid)
    if not data.is_cuda:
        return ref.subsample_gather_ref(data, indices, n_valid)
    out = _sg.subsample_gather(data, indices, n_valid)
    _counted("subsample_gather")
    return out


def subsample_gather(data: torch.Tensor, indices: torch.Tensor):
    """``(gathered [T, D], stats [2, D])`` for random row ids ``indices``:
    ``data [N, D]`` fp32 or bf16, ``indices [T]`` int32, every index in
    ``[0, N)``; stats = ``(Σ row, Σ row²)`` in fp32 over all T rows.

    The reference pads T to a power of two so that XLA compiles one kernel
    per padded length.  The CUDA kernel takes T at run time from one
    build, so the port launches it with ``n_valid = T`` and no padding."""
    n_valid = torch.full((1,), indices.numel(), dtype=torch.int32,
                         device=indices.device)
    return _subsample_gather_padded(data, indices, n_valid)


def _check_grid_arena(data, months, rows, draws: int, ds: int, grid: int,
                      statistic: str) -> None:
    """What both ``subsample_grid`` forms need of the arena, the slots and
    the draw shape."""
    if data.dim() != 3 or rows.dim() != 1:
        raise ValueError("subsample_grid takes data [n_slots, ns, sl] and "
                         f"rows [B]; got {tuple(data.shape)} and "
                         f"{tuple(rows.shape)}")
    if statistic not in _sgrid.STATISTICS:
        raise ValueError(f"unknown statistic {statistic!r}; choose one of "
                         f"{sorted(_sgrid.STATISTICS)}")
    if not 1 <= grid <= _sgrid.MAX_GRID:
        raise ValueError(f"grid must lie in [1, {_sgrid.MAX_GRID}], got "
                         f"{grid}")
    if draws < 1 or ds < 1:
        raise ValueError(f"draws and draw_size must be >= 1, got {draws} "
                         f"and {ds}")
    if data.shape[1] * draws * ds >= 2 ** 24:
        raise ValueError(f"{data.shape[1]} x {draws} x {ds} drawn elements "
                         "a task: fp32 counts are exact only below 2**24")
    if data.dtype != torch.float32:
        raise TypeError(f"subsample_grid takes fp32 data, got {data.dtype}")
    if rows.dtype != torch.int32:
        raise TypeError(f"subsample_grid takes int32 rows, got {rows.dtype}")
    if tuple(months.shape) != tuple(data.shape):
        raise ValueError(f"months {tuple(months.shape)} != data "
                         f"{tuple(data.shape)}")
    if months.dtype != torch.int32:
        raise TypeError(f"subsample_grid takes int32 months, got "
                        f"{months.dtype}")


def _check_same_place(*tensors) -> None:
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("subsample_grid's tensors must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("subsample_grid takes contiguous tensors")


def _check_subsample_grid(data, months, rows, idx, grid: int,
                          statistic: str) -> None:
    if idx.dim() != 4:
        raise ValueError("subsample_grid takes idx [B, draws, ns, ds]; got "
                         f"{tuple(idx.shape)}")
    bsz, draws, ns, ds = idx.shape
    _check_grid_arena(data, months, rows, draws, ds, grid, statistic)
    if rows.shape[0] != bsz or ns != data.shape[1]:
        raise ValueError(f"idx {tuple(idx.shape)} does not fit rows "
                         f"{tuple(rows.shape)} and data {tuple(data.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"subsample_grid takes int32 idx, got {idx.dtype}")
    _check_same_place(data, months, rows, idx)


def _check_subsample_grid_seeded(data, months, rows, seeds, draws: int,
                                 ds: int, grid: int, statistic: str) -> None:
    # the arena's 2**24 bound on a task's draws also keeps them inside a
    # key's 2**32 counters
    _check_grid_arena(data, months, rows, draws, ds, grid, statistic)
    if data.shape[2] < 1:
        raise ValueError("subsample_grid_seeded draws from [0, sl) and "
                         f"needs sl >= 1; got data {tuple(data.shape)}")
    if seeds.dim() != 1 or seeds.shape[0] != rows.shape[0]:
        raise ValueError(f"seeds must be [B] = [{rows.shape[0]}], got "
                         f"{tuple(seeds.shape)}")
    if seeds.dtype != torch.int32:
        raise TypeError(f"subsample_grid_seeded takes int32 seeds, got "
                        f"{seeds.dtype}")
    _check_same_place(data, months, rows, seeds)


def subsample_grid(data: torch.Tensor, months: torch.Tensor,
                   rows: torch.Tensor, idx: torch.Tensor, *, grid: int,
                   statistic: str) -> torch.Tensor:
    """The paper's binned subsample statistics for a wave of map tasks:
    task ``b`` reads arena slot ``rows[b]`` of ``data [n_slots, ns, sl]``
    fp32 (and of ``months``, int32 of the same shape, which only
    ``monthly_mean`` reads) at the positions ``idx[b]``
    ``[draws, ns, ds]`` int32 → ``[B, 2, grid]`` fp32: row 0 the binned
    sum (``sum_curve`` / ``sum``), row 1 the bin counts (``hits`` /
    ``count``); see ``kernels.ref.grid_partial``.  One launch per wave;
    the kernel adds in one fixed order, so task ``b``'s partial does not
    depend on B, on its slot, or on the run.  Every row must lie in
    ``[0, n_slots)`` and every index in ``[0, sl)``."""
    _check_subsample_grid(data, months, rows, idx, grid, statistic)
    if not data.is_cuda:
        return ref.subsample_grid_ref(data, months, rows, idx, grid=grid,
                                      statistic=statistic)
    out = _sgrid.subsample_grid(data, months, rows, idx, grid=grid,
                                statistic=statistic)
    _counted("subsample_grid")
    return out


def subsample_grid_seeded(data: torch.Tensor, months: torch.Tensor,
                          rows: torch.Tensor, seeds: torch.Tensor, *,
                          draws: int, draw_size: int, grid: int,
                          statistic: str) -> torch.Tensor:
    """:func:`subsample_grid` with each task's indices drawn from its seed:
    task ``b``'s are ``jax.random.randint(PRNGKey(seeds[b]), (draws, ns,
    draw_size), 0, sl)`` for ``seeds [B]`` int32, bit for bit
    (:mod:`repro_torch.prng`).  On the card the kernel draws them itself,
    and no index tensor exists; on the CPU the plain version draws them
    with :func:`repro_torch.prng.randint`.  Either way task ``b``'s
    partial is :func:`subsample_grid`'s on those indices, bit for bit.
    Counts as a ``subsample_grid`` launch."""
    _check_subsample_grid_seeded(data, months, rows, seeds, draws,
                                 draw_size, grid, statistic)
    kw = dict(draws=draws, draw_size=draw_size, grid=grid,
              statistic=statistic)
    if not data.is_cuda:
        return ref.subsample_grid_seeded_ref(data, months, rows, seeds, **kw)
    out = _sgrid.subsample_grid_seeded(data, months, rows, seeds, **kw)
    _counted("subsample_grid")
    return out


def randint(seeds: torch.Tensor, shape: Sequence[int], lo: int,
            hi: int) -> torch.Tensor:
    """``jax.random.randint(PRNGKey(seed), shape, lo, hi, int32)`` for each
    of ``seeds [B]`` int32 → ``[B, *shape]`` int32: on the card the
    threefry of ``subsample_grid``'s kernel, on the CPU
    :func:`repro_torch.prng.randint`.  ``prod(shape)`` must lie below
    2**32."""
    shape = tuple(int(n) for n in shape)
    if seeds.dim() != 1:
        raise ValueError(f"randint takes seeds [B], got {tuple(seeds.shape)}")
    if seeds.dtype != torch.int32:
        raise TypeError(f"randint takes int32 seeds, got {seeds.dtype}")
    if not seeds.is_contiguous():
        raise ValueError("randint takes contiguous seeds")
    if any(n < 0 for n in shape) or math.prod(shape) >= _COUNTERS:
        raise ValueError(f"randint draws shapes of fewer than 2**32 "
                         f"elements, got {shape}")
    prng._randint_multiplier(lo, hi)              # bounds within int32
    if not seeds.is_cuda:
        return prng.randint(prng.PRNGKey(seeds), shape, lo, hi)
    out = _sgrid.threefry_randint(seeds, math.prod(shape), lo, hi)
    _counted("threefry_randint")
    return out.reshape((seeds.shape[0],) + shape)


def _check_rwkv6(r, k, v, logw, u, state, chunk: int) -> None:
    b, h, s, hd = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if t.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"u must be [H, hd] = {(h, hd)}, got "
                         f"{tuple(u.shape)}")
    if tuple(state.shape) != (b, h, hd, hd):
        raise ValueError(f"state must be [B, H, hd, hd] = {(b, h, hd, hd)}, "
                         f"got {tuple(state.shape)}")
    if r.dtype not in _FLOATS or any(t.dtype != r.dtype for t in (k, v, u)):
        raise TypeError("r, k, v and u take one type, fp32 or bf16; got "
                        f"{[t.dtype for t in (r, k, v, u)]}")
    if logw.dtype not in _FLOATS:
        raise TypeError(f"logw takes fp32 or bf16, got {logw.dtype}")
    if state.dtype != torch.float32:
        raise TypeError(f"state takes fp32, got {state.dtype}")
    if any(t.device != r.device for t in (k, v, logw, u, state)):
        raise ValueError("r, k, v, logw, u and state must lie on one device")
    if not all(t.is_contiguous() for t in (r, k, v, logw, u, state)):
        raise ValueError("rwkv6_chunked takes contiguous tensors")
    if s == 0 or not 1 <= chunk <= _rw.MAX_CHUNK or s % chunk:
        raise ValueError(f"the chunk length must lie in [1, "
                         f"{_rw.MAX_CHUNK}] and divide S; got chunk {chunk}, "
                         f"S {s}")
    if r.is_cuda and hd not in _rw.HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes hd in {_rw.HEAD_DIMS}, "
                         f"got {hd}")


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                  state: Optional[torch.Tensor] = None):
    """Chunked RWKV6 recurrence: ``r, k, v, logw [B, H, S, hd]`` (log decay
    ≤ 0) and ``u [H, hd]`` → ``(out [B, H, S, hd] fp32, state_out [B, H,
    hd, hd] fp32)``, carried from ``state`` (zeros when None), in chunks of
    ``min(chunk, S)`` tokens; ``S`` must be a multiple of that.  With grad
    on and an input that requires it, the call is differentiable
    (:class:`_RWKV6Chunked`)."""
    if r.dim() != 4:
        raise ValueError(f"rwkv6_chunked takes r [B, H, S, hd]; got "
                         f"{tuple(r.shape)}")
    b, h, s, hd = r.shape
    chunk = min(chunk, s)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                            device=r.device)
    _check_rwkv6(r, k, v, logw, u, state, chunk)
    if _wants_grad(r, k, v, logw, u, state):
        return _RWKV6Chunked.apply(r, k, v, logw, u, state, chunk)
    if not r.is_cuda:
        return ref.rwkv6_chunk_form_ref(r, k, v, logw, u, state, chunk)
    out = _rw.rwkv6_chunked(r, k, v, logw, u, state, chunk)
    _counted("rwkv6_chunked")
    return out


class _RWKV6Chunked(torch.autograd.Function):
    """``rwkv6_chunked`` with its gradient.  The forward saves its inputs,
    the final state and the states entering every chunk but the first
    (the kernel's state pass writes them anyway), so that the backward,
    :func:`rwkv6_chunked_bwd`, never runs the state pass again.  Under
    remat the forward runs again inside the backward and saves its own
    states: the kernel is deterministic, so they equal the first."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, chunk: int):
        if r.is_cuda:
            out, state_out, states = _rw.rwkv6_chunked(
                r, k, v, logw, u, state, chunk, with_states=True)
            _counted("rwkv6_chunked")
        else:
            out, state_out, states = ref.rwkv6_chunk_form_ref(
                r, k, v, logw, u, state, chunk, with_states=True)
        ctx.save_for_backward(r, k, v, logw, u, state, states, state_out)
        ctx.chunk = chunk
        return out, state_out

    @staticmethod
    def backward(ctx, dout, dstate_out):
        r, k, v, logw, u, state, states, state_out = ctx.saved_tensors
        grads = rwkv6_chunked_bwd(r, k, v, logw, u, state, states, state_out,
                                  dout.contiguous(), dstate_out.contiguous(),
                                  chunk=ctx.chunk)
        return (*grads, None)


def rwkv6_chunked_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logw: torch.Tensor, u: torch.Tensor,
                      state0: torch.Tensor, states: torch.Tensor,
                      state_out: torch.Tensor, dout: torch.Tensor,
                      dstate_out: torch.Tensor, *, chunk: int):
    """The gradient of :func:`rwkv6_chunked` from its inputs (``state0``
    the state it started from), the states entering every chunk but the
    first ``states [B, H, S / chunk − 1, hd, hd]`` and the final state
    ``state_out`` (fp32, what its forward wrote), and the gradients of its
    two outputs ``dout [B, H, S, hd]`` and ``dstate_out [B, H, hd, hd]``
    (fp32) → ``(dr, dk, dv, dlogw, du, dstate0)``: dr, dk, dv and du in
    r's type, dlogw in logw's, dstate0 fp32.  ``chunk`` is the forward's
    (divides S).  On the card one call launches the three passes of
    ``csrc/rwkv6_scan_bwd.cu`` and counts once as ``rwkv6_chunked_bwd``; on
    the CPU it runs :func:`kernels.ref.rwkv6_chunked_bwd_ref`."""
    _check_rwkv6(r, k, v, logw, u, state0, chunk)
    b, h, s, hd = r.shape
    want = {"states": (b, h, s // chunk - 1, hd, hd),
            "state_out": (b, h, hd, hd), "dout": (b, h, s, hd),
            "dstate_out": (b, h, hd, hd)}
    for name, t in (("states", states), ("state_out", state_out),
                    ("dout", dout), ("dstate_out", dstate_out)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes fp32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"rwkv6_chunked_bwd takes a contiguous {name}")
    if not r.is_cuda:
        return ref.rwkv6_chunked_bwd_ref(r, k, v, logw, u, state0, states,
                                         state_out, dout, dstate_out, chunk)
    grads = _rwb.rwkv6_chunked_bwd(r, k, v, logw, u, state0, states,
                                   state_out, dout, dstate_out, chunk)
    _counted("rwkv6_chunked_bwd")
    return grads


def _check_rglru(a, b, h0) -> None:
    if a.dim() != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"rglru_scan takes a, b [B, S, W] of one shape; "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 must be [B, W] = {(a.shape[0], a.shape[2])}, "
                         f"got {tuple(h0.shape)}")
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise TypeError("rglru_scan takes fp32 a, b and h0; got "
                        f"{[t.dtype for t in (a, b, h0)]}")
    if any(t.device != a.device for t in (b, h0)):
        raise ValueError("a, b and h0 must lie on one device")
    if not all(t.is_contiguous() for t in (a, b, h0)):
        raise ValueError("rglru_scan takes contiguous tensors")
    if a.shape[1] == 0:
        raise ValueError("rglru_scan takes S >= 1")


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """The RG-LRU linear recurrence ``h_t = a_t ⊙ h_{t−1} + b_t`` from
    ``h_{−1} = h0``: ``a, b [B, S, W]`` and ``h0 [B, W]``, all fp32, →
    ``[B, S, W]`` fp32.  Any ``S >= 1`` and any ``W``: the reference's
    tiling arguments (``chunk``, ``width_block``) have no counterpart.
    With grad on and an input that requires it, the call is
    differentiable (:class:`_RGLRUScan`)."""
    _check_rglru(a, b, h0)
    if _wants_grad(a, b, h0):
        return _RGLRUScan.apply(a, b, h0)
    return _rglru_scan(a, b, h0)


def _rglru_scan(a, b, h0):
    if not a.is_cuda:
        return ref.linear_scan_ref(a, b, h0)
    out = _rg.rglru_scan(a, b, h0)
    _counted("rglru_scan")
    return out


class _RGLRUScan(torch.autograd.Function):
    """``rglru_scan`` with its gradient: the forward saves ``a``, ``h0``
    and its output, the backward is :func:`rglru_scan_bwd`."""

    @staticmethod
    def forward(ctx, a, b, h0):
        out = _rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h0, out)
        return out

    @staticmethod
    def backward(ctx, dh):
        a, h0, out = ctx.saved_tensors
        return rglru_scan_bwd(a, out, h0, dh.contiguous())


def _check_rglru_bwd(h, dh, like) -> None:
    if tuple(h.shape) != tuple(like.shape) or tuple(dh.shape) != tuple(
            like.shape):
        raise ValueError(f"h and dh must be {tuple(like.shape)}; got "
                         f"{tuple(h.shape)} and {tuple(dh.shape)}")
    if h.dtype != torch.float32 or dh.dtype != torch.float32:
        raise TypeError(f"h and dh take fp32; got {h.dtype} and {dh.dtype}")
    if h.device != like.device or dh.device != like.device:
        raise ValueError("h and dh must lie on the inputs' device")
    if not (h.is_contiguous() and dh.is_contiguous()):
        raise ValueError("rglru_scan_bwd takes contiguous tensors")


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                   dh: torch.Tensor):
    """The gradient of :func:`rglru_scan` from its decay ``a``, its output
    ``h``, ``h0`` and the output's gradient ``dh`` (fp32 ``[B, S, W]``,
    ``h0 [B, W]``) → ``(da, db, dh0)`` fp32: the reverse scan ``g_t = dh_t
    + a_{t+1} g_{t+1}``, ``da_t = g_t h_{t−1}``, ``db_t = g_t``, ``dh0 = a_0
    g_0``.  On the card one launch of ``csrc/rglru_scan_bwd.cu``'s read
    form, counted as ``rglru_scan_bwd``; on the CPU
    :func:`kernels.ref.rglru_scan_bwd_ref`."""
    _check_rglru(a, a, h0)
    _check_rglru_bwd(h, dh, a)
    if not a.is_cuda:
        return ref.rglru_scan_bwd_ref(a, h, h0, dh)
    grads = _rgb.rglru_scan_bwd(a, h, h0, dh)
    _counted("rglru_scan_bwd")
    return grads


def _check_rglru_gated(u, gates, softplus_lam, h0) -> None:
    if u.dim() != 3 or u.shape[1] == 0:
        raise ValueError(f"rglru_gated_scan takes u [B, S, W] with S >= 1; "
                         f"got {tuple(u.shape)}")
    bsz, _, w = u.shape
    if any(tuple(t.shape) != (w,) for t in (*gates, softplus_lam)):
        raise ValueError(f"the gate vectors and softplus_lam must be [W] = "
                         f"[{w}]; got "
                         f"{[tuple(t.shape) for t in (*gates, softplus_lam)]}")
    if tuple(h0.shape) != (bsz, w):
        raise ValueError(f"h0 must be [B, W] = {(bsz, w)}, got "
                         f"{tuple(h0.shape)}")
    if u.dtype not in _FLOATS:
        raise TypeError(f"rglru_gated_scan takes fp32 or bf16 u, got "
                        f"{u.dtype}")
    if gates[0].dtype not in _FLOATS or any(t.dtype != gates[0].dtype
                                            for t in gates):
        raise TypeError("the four gate vectors take one type, fp32 or bf16; "
                        f"got {[t.dtype for t in gates]}")
    if softplus_lam.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError("rglru_gated_scan takes fp32 softplus_lam and h0; "
                        f"got {softplus_lam.dtype} and {h0.dtype}")
    if any(t.device != u.device for t in (*gates, softplus_lam, h0)):
        raise ValueError("u, the gate vectors, softplus_lam and h0 must lie "
                         "on one device")
    if not all(t.is_contiguous() for t in (u, *gates, softplus_lam, h0)):
        raise ValueError("rglru_gated_scan takes contiguous tensors")


def rglru_gated_scan(u: torch.Tensor, gate_a_w: torch.Tensor,
                     gate_a_b: torch.Tensor, gate_x_w: torch.Tensor,
                     gate_x_b: torch.Tensor, softplus_lam: torch.Tensor,
                     h0: torch.Tensor) -> torch.Tensor:
    """The RG-LRU with its gates: ``a`` and ``b`` of
    :func:`kernels.ref.rglru_gates` formed from the block's post-conv input
    ``u [B, S, W]`` (fp32 or bf16), the gate vectors ``gate_a_w, gate_a_b,
    gate_x_w, gate_x_b [W]`` (one type, fp32 or bf16) and ``softplus_lam =
    softplus(lam) [W]`` fp32, then :func:`rglru_scan` from ``h0 [B, W]``
    fp32 → ``[B, S, W]`` fp32.  On the card the kernel forms ``a`` and
    ``b`` itself, and neither exists in device memory; on the CPU the plain
    version runs the gates as torch ops.  Counts as a ``rglru_scan``
    launch."""
    gates = (gate_a_w, gate_a_b, gate_x_w, gate_x_b)
    _check_rglru_gated(u, gates, softplus_lam, h0)
    if _wants_grad(u, *gates, softplus_lam, h0):
        return _RGLRUGatedScan.apply(u, *gates, softplus_lam, h0)
    return _rglru_gated_scan(u, *gates, softplus_lam, h0)


def _rglru_gated_scan(u, *rest):
    if not u.is_cuda:
        return ref.rglru_gated_scan_ref(u, *rest)
    out = _rg.rglru_gated_scan(u, *rest)
    _counted("rglru_scan")
    return out


class _RGLRUGatedScan(torch.autograd.Function):
    """``rglru_gated_scan`` with its gradient: the forward saves its inputs
    and its output (``a`` and the gated input exist nowhere: the backward
    forms them again from ``u``), the backward is
    :func:`rglru_gated_scan_bwd`."""

    @staticmethod
    def forward(ctx, u, gate_a_w, gate_a_b, gate_x_w, gate_x_b,
                softplus_lam, h0):
        out = _rglru_gated_scan(u, gate_a_w, gate_a_b, gate_x_w, gate_x_b,
                                softplus_lam, h0)
        ctx.save_for_backward(u, gate_a_w, gate_a_b, gate_x_w, gate_x_b,
                              softplus_lam, h0, out)
        return out

    @staticmethod
    def backward(ctx, dh):
        return rglru_gated_scan_bwd(*ctx.saved_tensors, dh.contiguous())


def rglru_gated_scan_bwd(u: torch.Tensor, gate_a_w: torch.Tensor,
                         gate_a_b: torch.Tensor, gate_x_w: torch.Tensor,
                         gate_x_b: torch.Tensor, softplus_lam: torch.Tensor,
                         h0: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """The gradient of :func:`rglru_gated_scan` from its inputs, its output
    ``h`` and the output's gradient ``dh`` (fp32 ``[B, S, W]``) → ``(du,
    dgate_a_w, dgate_a_b, dgate_x_w, dgate_x_b, dsoftplus_lam, dh0)``: du
    in u's type, the gate vectors' in theirs, the last two fp32.  On the
    card one call launches ``csrc/rglru_scan_bwd.cu``'s gated form (which
    forms ``a`` and the gated input from ``u`` again) and its reduction
    over B, and counts once as ``rglru_scan_bwd``; on the CPU
    :func:`kernels.ref.rglru_gated_scan_bwd_ref`."""
    gates = (gate_a_w, gate_a_b, gate_x_w, gate_x_b)
    _check_rglru_gated(u, gates, softplus_lam, h0)
    _check_rglru_bwd(h, dh, u)
    if not u.is_cuda:
        return ref.rglru_gated_scan_bwd_ref(u, *gates, softplus_lam, h0, h,
                                            dh)
    grads = _rgb.rglru_gated_scan_bwd(u, *gates, softplus_lam, h0, h, dh)
    _counted("rglru_scan_bwd")
    return grads


def _check_flash(q, k, v, causal: bool, window: int, group: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or tuple(v.shape) != tuple(k.shape):
        raise ValueError("flash_attention takes q [BH, Sq, HD] and k, v "
                         "[BH / group, Skv, HD]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, sq, hd = q.shape
    if group < 1 or bh % group or k.shape[0] != bh // group:
        raise ValueError(f"{bh} query heads in groups of {group} need "
                         f"{bh // max(group, 1)} key/value heads, got "
                         f"{k.shape[0]}")
    if k.shape[2] != hd:
        raise ValueError(f"q has HD {hd}, k and v {k.shape[2]}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in _FLOATS or any(t.dtype != q.dtype for t in (k, v)):
        raise TypeError("q, k and v take one type, fp32 or bf16; got "
                        f"{[t.dtype for t in (q, k, v)]}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must lie on one device")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention takes contiguous tensors")
    if q.is_cuda and hd not in _fa.HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes HD in {_fa.HEAD_DIMS}, "
                         f"got {hd}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    group: int = 1) -> torch.Tensor:
    """Softmax attention: ``q [BH, Sq, HD]``, ``k, v [BH / group, Skv,
    HD]`` (fp32 or bf16, one type) → ``[BH, Sq, HD]`` in q's type.  Query
    head ``bh`` reads key/value head ``bh // group``; key ``j`` is seen by
    query ``i`` when ``j <= i`` (if ``causal``) and ``i − j < window`` (if
    ``window`` > 0).  Any ``Sq`` and ``Skv``: the reference's tiling
    arguments (``block_q``, ``block_k``) have no counterpart.

    With grad on and an input that requires it, the call is differentiable
    (:class:`_FlashAttention`); else it launches the forward alone, with
    no log-sum-exp."""
    _check_flash(q, k, v, causal, window, group)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, group)
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       group=group)
    out = _fa.flash_attention(q, k, v, causal=causal, window=window,
                              group=group)
    _counted("flash_attention")
    return out


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient.  The forward writes the
    output and each row's log-sum-exp and saves ``q, k, v, out, lse``; the
    backward is :func:`flash_attention_bwd`.  Under remat the forward runs
    again inside the backward and saves its own ``lse``: the kernel is
    deterministic, so the recomputed output equals the first."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, group: int):
        kw = dict(causal=causal, window=window, group=group)
        if q.is_cuda:
            out, lse = _fa.flash_attention(q, k, v, with_lse=True, **kw)
            _counted("flash_attention")
        else:
            out = ref.flash_attention_ref(q, k, v, **kw)
            lse = ref.flash_attention_lse_ref(q, k, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, group: int = 1):
    """The gradient of :func:`flash_attention` from its inputs, its output
    ``out`` and log-sum-exp ``lse [BH, Sq]`` fp32, and the output's
    gradient ``dout`` (``out``'s shape and type) → ``(dq, dk, dv)`` in the
    inputs' type, under the forward's mask (``causal``, ``window``).  On
    the card one call launches the kernels of
    ``csrc/flash_attention_bwd.cu`` (three, four at bf16 HD 256) and
    counts once as ``flash_attention_bwd``; on the CPU it runs
    :func:`kernels.ref.flash_attention_bwd_ref`."""
    _check_flash(q, k, v, causal, window, group)
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(
            q.shape):
        raise ValueError(f"out and dout must be q's shape {tuple(q.shape)}; "
                         f"got {tuple(out.shape)} and {tuple(dout.shape)}")
    if tuple(lse.shape) != tuple(q.shape[:2]) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {tuple(q.shape[:2])}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(t.dtype != q.dtype for t in (out, dout)):
        raise TypeError("out and dout take q's type; got "
                        f"{[t.dtype for t in (out, dout)]}")
    if any(t.device != q.device for t in (out, lse, dout)):
        raise ValueError("q, k, v, out, lse and dout must lie on one device")
    if not all(t.is_contiguous() for t in (out, lse, dout)):
        raise ValueError("flash_attention_bwd takes contiguous tensors")
    if not q.is_cuda:
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, window=window,
                                           group=group)
    grads = _fab.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                     window=window, group=group)
    _counted("flash_attention_bwd")
    return grads


_CACHE_KEYS = ("k", "k_scale", "v", "v_scale")


def _check_attention_decode_int8(q, k, v, cache, pos: int,
                                 window: int) -> None:
    if q.dim() != 5 or q.shape[1] != 1:
        raise ValueError("attention_decode_int8 takes q [B, 1, KV, G, HD]; "
                         f"got {tuple(q.shape)}")
    b, _, kv, _, hd = q.shape
    if tuple(k.shape) != (b, 1, kv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"the new k and v must be {(b, 1, kv, hd)}; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if set(cache) != set(_CACHE_KEYS):
        raise ValueError(f"an int8 cache holds {_CACHE_KEYS}; got "
                         f"{sorted(cache)}")
    ck, cv, ks, vs = (cache[n] for n in ("k", "v", "k_scale", "v_scale"))
    if ck.dtype != torch.int8 or cv.dtype != torch.int8:
        raise TypeError(f"the cache's k and v must be int8; got {ck.dtype}, "
                        f"{cv.dtype}")
    if ck.dim() != 4 or tuple(ck.shape[::2]) != (b, kv) or ck.shape[3] != hd \
            or tuple(cv.shape) != tuple(ck.shape):
        raise ValueError(f"the cache's k and v must be [{b}, S_max, {kv}, "
                         f"{hd}]; got {tuple(ck.shape)}, {tuple(cv.shape)}")
    s_max = ck.shape[1]
    if any(t.dtype != torch.float32 or tuple(t.shape) != (b, s_max, kv, 1)
           for t in (ks, vs)):
        raise ValueError(f"the scales must be fp32 {(b, s_max, kv, 1)}; got "
                         f"{ks.dtype} {tuple(ks.shape)}, {vs.dtype} "
                         f"{tuple(vs.shape)}")
    if pos < 0 or window < 0:
        raise ValueError(f"pos and window must be >= 0; got {pos}, {window}")
    write_at = pos % window if window else pos
    if write_at >= s_max:
        raise ValueError(f"decode writes slot {write_at} of a {s_max}-slot "
                         "cache")
    if q.dtype not in _FLOATS or any(t.dtype != q.dtype for t in (k, v)):
        raise TypeError("q and the new k, v take one type, fp32 or bf16; "
                        f"got {[t.dtype for t in (q, k, v)]}")
    tensors = (q, k, v, ck, cv, ks, vs)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and the cache must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_decode_int8 takes contiguous tensors")
    if q.is_cuda:
        _ad.check_supported(q)


def attention_decode_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache, pos: int, *, window: int = 0):
    """One decode step's attention over an int8 KV cache: ``q [B, 1, KV,
    G, HD]`` and the new token's ``k, v [B, 1, KV, HD]`` (after RoPE; fp32
    or bf16, one type), the cache ``{k, v [B, S_max, KV, HD] int8,
    k_scale, v_scale [B, S_max, KV, 1] fp32}``, ``pos`` the current length
    (a Python int) → ``(out [B, KV, G, HD]`` in q's type, the new
    cache``)``.  The new token is quantized and written at ``pos`` (at
    ``pos % window`` in a rolling buffer of ``window`` > 0); slots past the
    write are masked until the buffer has wrapped.  The cache is not
    written in place: on the card the four tensors are copied and the
    kernel, built for HD 128 in bf16 alone, writes the copy; on the CPU
    (and on ``meta``) it runs :func:`kernels.ref.attention_decode_int8_ref`
    for any HD and either type."""
    _check_attention_decode_int8(q, k, v, cache, pos, window)
    if not q.is_cuda:
        return ref.attention_decode_int8_ref(q, k, v, cache, pos,
                                             window=window)
    new_cache = {n: t.clone() for n, t in cache.items()}
    s_max = cache["k"].shape[1]
    write_at = pos % window if window else pos
    n_valid = s_max if window and pos >= window else write_at + 1
    out = _ad.attention_decode_int8(
        q, k, v, new_cache["k"], new_cache["v"], new_cache["k_scale"],
        new_cache["v_scale"], write_at=write_at, n_valid=n_valid)
    _counted("attention_decode_int8")
    return out, new_cache
