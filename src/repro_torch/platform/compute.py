"""Map-task compute engines for the platform driver (thesis §3.1, Fig 1).

The driver resolves ONE engine per job so every backend executes the exact
same per-task computation (this is what makes the threaded and simulated
backends bit-identical for a fixed seed):

  ``kernel``  — the hand-written CUDA ``subsample_stats`` kernel
                (``repro_torch.kernels``) for the row-subsampling
                ``moments`` statistic: a random row gather + (Σ, Σ²)
                accumulation in registers.  On the CPU its wrapper runs the
                plain PyTorch version.
  ``numpy``   — pure-NumPy reference path, forced for debugging.  It draws
                indices from NumPy's RNG, so it is statistically — not
                bitwise — equivalent to ``kernel``.

The paper's own statistics (``alod``, ``monthly_mean``) get their torch
engine in the next slice of the port; until then ``auto`` raises for them.

Block building pads samples to a common power-of-two length so one block
shape serves many tasks.

Wave execution: a *wave* is a batch of same-shape ready tasks executed in
ONE kernel launch.  :class:`BlockArena` packs the job's padded blocks into
a device-resident ``[n_tasks, count, len]`` tensor per distinct shape
(uploaded once); :func:`run_map_wave` gathers the wave's arena slots,
derives every task's row indices from its seed with
:func:`repro_torch.prng.randint` (jax's exact draws), and launches the
kernel once for the wave.  Per-task accumulation order is independent of
the wave partition, so wave and per-task execution are bit-identical for
a fixed seed.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, MutableSequence, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ops

NEXT_SLICE = ("the torch engine for the paper's statistics "
              "(core/subsample.py) is the next slice of the port")


@dataclasses.dataclass(frozen=True)
class MomentsSpec:
    """Row-subsampling workload whose map task IS the kernel's semantics:
    each draw gathers ``draw_size`` random *rows* (samples) of the task
    block and accumulates (Σrow, Σrow²)."""

    name: str = "moments"
    statistic: str = "moments"
    draws: int = 8
    draw_size: int = 64
    grid: int = 0             # unused; kept for workload interface parity


MOMENTS = MomentsSpec()


@dataclasses.dataclass
class DispatchStats:
    """Observable device-overhead counters (thesis Fig 5/6 made visible):
    how many device dispatches the map phase issued, how many bytes went
    host→device, and how large each executed wave was.  Per-task execution
    shows ``device_dispatches == n_tasks``; wave execution collapses that
    by roughly the mean wave size."""

    device_dispatches: int = 0
    bytes_uploaded: float = 0.0
    # a list for one-shot jobs; :meth:`bounded` swaps in a capped deque
    wave_sizes: MutableSequence[int] = dataclasses.field(
        default_factory=list)
    # data-plane prefetch pipeline (DESIGN.md §9): how many task fetches
    # were already in flight when their wave executed vs fetched inline
    prefetch_hits: int = 0
    prefetch_misses: int = 0

    @classmethod
    def bounded(cls, max_wave_history: int) -> "DispatchStats":
        """Counters for a long-lived holder (the persistent service):
        dispatches never stop, so only the most recent
        ``max_wave_history`` wave sizes are retained."""
        return cls(wave_sizes=deque(maxlen=max_wave_history))


def check_device(device) -> torch.device:
    """The device an entry point was asked to run on.  Asking for the card
    where there is none raises: nothing continues on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    return dev


def wave_supported(engine: str) -> bool:
    """Wave execution batches kernel launches, so it exists only for the
    device engine; numpy and custom map_fns fall back to per-task."""
    return engine == "kernel"


# Auto-wave threshold: waves amortize the fixed per-dispatch tax, which
# only dominates when per-task compute is tiny (the thesis' Fig 5/6 story
# — large tasks amortize their own overhead).  Per-task compute scales
# with the workload's drawn elements; above this many, auto mode stays
# per-task (``wave="on"`` overrides).
WAVE_AUTO_MAX_DRAW = 4096


def wave_profitable(workload) -> bool:
    try:
        return workload.draws * workload.draw_size <= WAVE_AUTO_MAX_DRAW
    except (AttributeError, TypeError):
        return False


def resolve_engine(statistic: str, prefer: str = "auto") -> str:
    """Pick the compute engine once per job (never per task)."""
    if prefer == "auto":
        if statistic == "moments":
            return "kernel"
        raise NotImplementedError(
            f"statistic {statistic!r} has no device engine in the port yet: "
            f"{NEXT_SLICE}; pass engine='numpy' for the host reference")
    if prefer == "torch":
        raise NotImplementedError(f"engine 'torch': {NEXT_SLICE}")
    if prefer == "kernel" and statistic != "moments":
        raise ValueError(
            "engine 'kernel' computes the row-subsample 'moments' "
            f"statistic; workload statistic is {statistic!r}")
    if prefer not in ("kernel", "numpy"):
        raise ValueError(f"unknown engine {prefer!r}; choose 'auto', "
                         "'kernel' or 'numpy'")
    return prefer


# ---------------------------------------------------------------------------
# Block building — uniform task shapes (thesis §3.2.1 outlier handling)
# ---------------------------------------------------------------------------


def pow2_ceil(n: int) -> int:
    """Round up to a power of two — the padding primitive shared by block
    lengths (:func:`padded_len`) and wave widths."""
    return 1 << (max(n, 1) - 1).bit_length()


def padded_len(longest: int, min_len: int = 0) -> int:
    """The block length ``pad_to_common`` will produce for rows whose
    longest member is ``longest`` — the single source of the padding
    policy (shape keys for warmup/calibration derive from this too)."""
    return pow2_ceil(max(longest, min_len))


def pad_to_common(arrays: List[np.ndarray],
                  min_len: int = 0) -> List[np.ndarray]:
    """Samples are heavy-tailed (§3.2.1 outliers); pad to the block max,
    rounded up to a power of two so the number of block shapes stays
    bounded.  ``min_len`` forces a job-global length (statistics whose
    partial shape depends on sample length must align across tasks)."""
    n = padded_len(max(a.shape[0] for a in arrays), min_len)
    return [np.pad(a, (0, n - a.shape[0]), mode="wrap")
            if a.shape[0] < n else a for a in arrays]


def partial_pad_len(statistic: str, samples: Dict[int, np.ndarray]) -> int:
    """Job-global pad length: grid statistics (alod/monthly_mean) emit
    fixed-size partials so per-block padding suffices (0); per-column
    statistics (moments) must pad every block to the dataset max."""
    if statistic == "moments":
        return max(a.shape[0] for a in samples.values())
    return 0


def build_block(samples: Dict[int, np.ndarray],
                months: Dict[int, np.ndarray],
                ids: Sequence[int],
                sample_ids: Sequence[int],
                max_count: int,
                pad_len: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize one task's [count, len] block, wrap-padded to the job's
    max task count so one block shape serves the whole job."""
    rows = [samples[ids[i]] for i in sample_ids]
    mrows = [months[ids[i]] for i in sample_ids]
    while len(rows) < max_count:
        rows.append(rows[len(rows) % len(sample_ids)])
        mrows.append(mrows[len(mrows) % len(sample_ids)])
    return (np.stack(pad_to_common(rows, pad_len)),
            np.stack(pad_to_common(mrows, pad_len)))


# ---------------------------------------------------------------------------
# Device-resident block arena (wave execution)
# ---------------------------------------------------------------------------


class BlockArena:
    """The job's padded task blocks, packed per distinct block shape into
    one ``[n_tasks, count, len]`` tensor on ``device`` and uploaded ONCE.

    Per-task execution re-uploads every block; the arena replaces that
    with a single upload plus a device-side slot gather per wave (the slot
    and seed vectors are the only host→device traffic a wave pays).
    ``slots`` maps a wave of same-shape tasks to rows of its shape bucket.
    """

    def __init__(self, device):
        self.device = check_device(device)
        self._data: Dict[Any, torch.Tensor] = {}   # key -> [B, count, len]
        self._months: Dict[Any, Optional[torch.Tensor]] = {}
        self._slot: Dict[int, Tuple[Any, int]] = {}   # task_id -> (key, row)
        self.nbytes = 0.0

    @classmethod
    def pack(cls, tasks: Sequence, shape_key: Callable, build: Callable,
             with_months: bool = True, *, device="cuda") -> "BlockArena":
        """Bucket ``tasks`` by ``shape_key``, materialize each task's
        padded block via ``build(task) -> (block, months)`` straight into
        the bucket's host array, and upload each bucket once.
        ``with_months=False`` skips the months plane (the moments kernel
        never reads it — packing it would double the upload and skew
        ``bytes_uploaded``)."""
        arena = cls(device)
        buckets: Dict[Any, List] = {}
        for task in tasks:
            buckets.setdefault(shape_key(task), []).append(task)
        for key, group in buckets.items():
            data = months = None
            for row, task in enumerate(group):
                block, mo = build(task)
                if data is None:
                    data = np.empty((len(group),) + block.shape, block.dtype)
                    if with_months:
                        months = np.empty((len(group),) + mo.shape, mo.dtype)
                data[row] = block
                if with_months:
                    months[row] = mo
                arena._slot[task.task_id] = (key, row)
            arena._data[key] = torch.from_numpy(data).to(arena.device)
            arena.nbytes += float(data.nbytes)
            arena._months[key] = None
            if with_months:
                arena._months[key] = torch.from_numpy(months).to(arena.device)
                arena.nbytes += float(months.nbytes)
        return arena

    def bucket(self, key) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._data[key], self._months[key]

    def slots(self, tasks: Sequence) -> Tuple[Any, np.ndarray]:
        """Arena rows for a wave.  Waves are drained same-shape by the
        scheduler, so all tasks must live in one shape bucket."""
        keys = {self._slot[t.task_id][0] for t in tasks}
        if len(keys) != 1:
            raise ValueError(f"wave spans shape buckets: {keys}")
        key = keys.pop()
        rows = np.asarray([self._slot[t.task_id][1] for t in tasks],
                          np.int32)
        return key, rows


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def run_map_task(block: np.ndarray, months: np.ndarray, seed: int,
                 workload, engine: str, *,
                 device="cuda") -> Dict[str, np.ndarray]:
    """One map task: subsample the block, compute the statistic partial.

    Partials are plain dicts of NumPy arrays so the reduce tree can combine
    them with element-wise addition regardless of engine or backend.
    """
    if engine == "kernel":
        return _moments_kernel(block, seed, workload, check_device(device))
    if engine == "numpy":
        return _map_task_numpy(block, months, seed, workload)
    raise ValueError(f"unknown engine {engine!r}")


def _moments_kernel(block: np.ndarray, seed: int, workload,
                    device: torch.device) -> Dict[str, np.ndarray]:
    """The kernel as the map-task compute, as a wave of one: identical
    math to :func:`run_map_wave`, so per-task and wave execution agree to
    the last bit for the same per-task seed."""
    n_idx = workload.draws * workload.draw_size
    data = torch.from_numpy(np.ascontiguousarray(block)).to(device)[None]
    stats = _moments_wave(data, np.zeros(1, np.int32),
                          np.asarray([seed], np.int32), n_idx=n_idx)
    return _split_moments(stats, n_idx)[0]


def _split_moments(stats: np.ndarray, n_idx: int) -> List[Dict[str, np.ndarray]]:
    """[B, 2, D] kernel stats → per-task reduce-tree partials."""
    return [{"sum": s[0], "sumsq": s[1],
             "count": np.asarray(float(n_idx), np.float32)}
            for s in stats]


def _moments_wave(arena_data: torch.Tensor, rows: np.ndarray,
                  seeds: np.ndarray, *, n_idx: int) -> np.ndarray:
    """The wave pipeline: slot gather out of the resident arena → per-task
    row indices from the seeds (jax's exact threefry draws) → one kernel
    launch for the whole wave → ``[B, 2, D]`` on the host."""
    device = arena_data.device
    rows_t = torch.from_numpy(rows.astype(np.int64)).to(device)
    seeds_t = torch.from_numpy(np.asarray(seeds, np.int32)).to(device)
    data = arena_data.index_select(0, rows_t)           # [B, count, len]
    idx = prng.randint(prng.PRNGKey(seeds_t), (n_idx,), 0, data.shape[1])
    return ops.subsample_stats(data, idx).cpu().numpy()


def run_map_wave(arena: BlockArena, tasks: Sequence, seeds: np.ndarray,
                 workload, engine: str,
                 pad_to: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
    """Execute a wave of same-shape tasks in one kernel launch and split
    the batched result back into per-task reduce-tree partials.

    The wave is padded (repeating the first slot; padded outputs
    discarded) to ``pad_to`` when given — the driver pins one wave width
    per shape bucket — else to the next power of two.
    """
    if engine != "kernel":
        raise ValueError(f"engine {engine!r} does not support wave execution")
    key, rows = arena.slots(tasks)
    b = len(rows)
    b_pad = max(pad_to, b) if pad_to is not None else pow2_ceil(b)
    seeds = np.asarray(seeds, np.int32)
    if b_pad != b:
        rows = np.concatenate([rows, np.repeat(rows[:1], b_pad - b)])
        seeds = np.concatenate([seeds, np.repeat(seeds[:1], b_pad - b)])
    data, _ = arena.bucket(key)
    n_idx = workload.draws * workload.draw_size
    stats = _moments_wave(data, rows, seeds, n_idx=n_idx)
    return _split_moments(stats[:b], n_idx)


def _map_task_numpy(block: np.ndarray, months: np.ndarray, seed: int,
                    workload) -> Dict[str, np.ndarray]:
    """Pure-NumPy reference path (mirrors ``kernels.ref.subsample_stats_ref``
    for moments and the reference package's ``subsample.map_task`` for the
    paper's statistics)."""
    rng = np.random.default_rng(seed)
    ns, sl = block.shape
    stat = workload.statistic

    if stat == "moments":
        idx = rng.integers(0, ns, workload.draws * workload.draw_size)
        rows = block[idx].astype(np.float32)
        return {"sum": rows.sum(axis=0), "sumsq": (rows * rows).sum(axis=0),
                "count": np.asarray(float(len(idx)), np.float32)}

    draws, ds, grid = workload.draws, workload.draw_size, workload.grid
    idx = rng.integers(0, sl, (draws, ns, ds))
    gathered = np.take_along_axis(block[None, :, :], idx, axis=2)
    gathered = np.swapaxes(gathered, 0, 1)          # [ns, draws, ds]
    idx = np.swapaxes(idx, 0, 1)

    if stat == "alod":
        pos = idx.astype(np.float32) / sl
        cell = np.clip((pos * grid).astype(np.int32), 0, grid - 1)
        mean = gathered.mean(axis=2, keepdims=True)
        sd = gathered.std(axis=2, keepdims=True) + 1e-6
        z = np.abs((gathered - mean) / sd)
        curve = np.zeros(grid, np.float32)
        hits = np.zeros(grid, np.float32)
        np.add.at(curve, cell.reshape(-1), z.reshape(-1))
        np.add.at(hits, cell.reshape(-1), 1.0)
        return {"sum_curve": curve, "hits": hits,
                "count": np.asarray(float(ns * draws), np.float32)}

    if stat == "monthly_mean":
        m = np.take_along_axis(months[:, None, :], idx, axis=2)
        m = np.clip(m, 0, grid - 1)
        sums = np.zeros(grid, np.float32)
        cnts = np.zeros(grid, np.float32)
        np.add.at(sums, m.reshape(-1), gathered.reshape(-1))
        np.add.at(cnts, m.reshape(-1), 1.0)
        return {"sum": sums, "count": cnts}

    raise ValueError(f"unknown statistic {stat!r}")
