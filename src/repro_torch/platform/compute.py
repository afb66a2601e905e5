"""Map-task compute engines for the platform driver (thesis §3.1, Fig 1).

The driver resolves ONE engine per job so every backend executes the exact
same per-task computation (this is what makes the threaded and simulated
backends bit-identical for a fixed seed):

  ``kernel``  — the hand-written CUDA ``subsample_stats`` kernel
                (``repro_torch.kernels``) for the row-subsampling
                ``moments`` statistic: each task's block staged once in
                shared memory, its rows drawn in the kernel and their
                (Σ, Σ²) accumulated in registers.
  ``torch``   — the paper's own statistics (EAGLET ``alod``, Netflix
                ``monthly_mean``; ``repro_torch.core.subsample``, the
                reference's ``jnp`` engine): the random element gather and
                the binned partials in the hand-written CUDA
                ``subsample_grid`` kernel, which adds in one fixed order.
  ``numpy``   — pure-NumPy reference path, forced for debugging.  It draws
                indices from NumPy's RNG, so it is statistically — not
                bitwise — equivalent to the device engines.

On the CPU (``device="cpu"``) the kernel wrappers run their plain PyTorch
versions.

Block building pads samples to a common power-of-two length so one block
shape serves many tasks.

Wave execution: a *wave* is a batch of same-shape ready tasks executed in
ONE kernel launch.  :class:`BlockArena` packs the job's padded blocks into
a device-resident ``[n_tasks, count, len]`` tensor per distinct shape
(uploaded once; the ``torch`` engine's arena carries the months plane
too); :func:`run_map_wave` launches the engine's kernel once for the
wave's own tasks, given only their slots and seeds: the kernel reads
the resident arena through the slots and draws every task's indices
from its seed itself (jax's exact threefry draws).  Per-task
accumulation order is independent of the wave partition and of the
slot, so wave and per-task execution are bit-identical for a fixed
seed.

Sharded wave execution: :class:`ShardedBlockArena` partitions each shape
bucket over a wave mesh (``repro_torch.launch.mesh``: a list of devices,
one CUDA stream an entry) with the reference's interleaved
slot→(device, local-slot) placement (:func:`shard_slot`);
:func:`run_map_wave_sharded` splits a wave into each entry's lanes,
launches the unsharded wave's kernel over them on every entry's stream,
then gathers the partials on the host in mesh order.  A task's partial
depends only on its block and seed, so sharded results are bit-identical
to the unsharded wave's at every mesh size.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, MutableSequence, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import subsample as ss
from repro_torch.device import check_device
from repro_torch.kernels import ops
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import wave_sharding


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


def wave_supported(engine: str) -> bool:
    """Wave execution batches kernel launches, so it exists only for the
    device engines; numpy and custom map_fns fall back to per-task."""
    return engine in ("kernel", "torch")


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
        return "kernel" if statistic == "moments" else "torch"
    if prefer == "kernel" and statistic != "moments":
        raise ValueError(
            "engine 'kernel' computes the row-subsample 'moments' "
            f"statistic; workload statistic is {statistic!r} — use engine "
            "'torch' (or 'auto')")
    if prefer == "torch" and statistic == "moments":
        raise ValueError(
            "engine 'torch' computes the grid statistics ('alod', "
            "'monthly_mean'); 'moments' runs on engine 'kernel' (or "
            "'auto')")
    if prefer not in ("kernel", "torch", "numpy"):
        raise ValueError(f"unknown engine {prefer!r}; choose 'auto', "
                         "'kernel', 'torch' or 'numpy'")
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
    with a single upload, which each wave's kernel reads in place through
    the wave's slots (the slot and seed vectors are the only host→device
    traffic a wave pays).
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
# Sharded block arena (multi-device wave execution)
# ---------------------------------------------------------------------------


def shard_slot(index: int, n_dev: int) -> Tuple[int, int]:
    """Interleaved slot→(device, local-slot) indirection: logical bucket
    index ``i`` lives on device ``i % n_dev`` at local slot ``i // n_dev``.

    Interleaving — rather than contiguous blocks per device — is what
    bounds per-device wave occupancy: the scheduler claims waves as
    contiguous FIFO runs of the bucket, and any contiguous run of ``w``
    logical slots touches each device at most ``ceil(w / n_dev)`` times,
    so every entry gets a near-equal share of a wave."""
    return index % n_dev, index // n_dev


def unshard_slot(device: int, local: int, n_dev: int) -> int:
    """Inverse of :func:`shard_slot` (exact round-trip for any
    ``0 <= device < n_dev``)."""
    return local * n_dev + device


def shard_wave_width(cap: int, n_dev: int) -> int:
    """The lanes one device contributes to a full wave of a bucket whose
    (mesh-invariant) claim cap is ``cap``, rounded to a power of two: the
    reference pins its per-device kernel width to this.  The port's
    kernels take the width at run time and launch over an entry's own
    lanes, unpadded, so nothing here depends on it; it states the
    placement's occupancy bound."""
    return pow2_ceil(-(-max(cap, 1) // max(n_dev, 1)))


class ShardedBlockArena(BlockArena):
    """A :class:`BlockArena` partitioned over a wave mesh: each shape
    bucket's rows are permuted so device ``d`` holds the contiguous
    physical rows ``[d * per_dev, (d+1) * per_dev)`` — exactly its
    interleaved logical slots — uploaded once, one tensor an entry
    (:func:`~repro_torch.parallel.sharding.wave_sharding`).  Tail rows
    (bucket size not a multiple of the mesh) wrap-copy earlier blocks so
    every physical row is valid data; no lane reads them.

    ``bucket(key)`` gives the entries' tensors as lists in mesh order.
    The base-class ``_slot`` keeps the *physical* row (the row of the
    entries' blocks concatenated); ``_dev_slot`` adds the (device,
    local-slot) view the sharded dispatch uses."""

    def __init__(self, mesh):
        super().__init__(mesh.devices[0])
        self.mesh = mesh
        self.n_dev = mesh.n_dev
        self._dev_slot: Dict[int, Tuple[Any, int, int]] = {}
        self._per_dev: Dict[Any, int] = {}

    @classmethod
    def pack(cls, tasks: Sequence, shape_key: Callable, build: Callable,
             mesh=None, with_months: bool = True) -> "ShardedBlockArena":
        if mesh is None:
            raise ValueError("ShardedBlockArena.pack needs a mesh")
        arena = cls(mesh)
        n_dev = arena.n_dev
        sharding = wave_sharding(mesh)
        buckets: Dict[Any, List] = {}
        for task in tasks:
            buckets.setdefault(shape_key(task), []).append(task)
        for key, group in buckets.items():
            b = len(group)
            per_dev = -(-b // n_dev)
            data = months = None
            for i, task in enumerate(group):
                block, mo = build(task)
                if data is None:
                    data = np.empty((n_dev * per_dev,) + block.shape,
                                    block.dtype)
                    if with_months:
                        months = np.empty((n_dev * per_dev,) + mo.shape,
                                          mo.dtype)
                dev, local = shard_slot(i, n_dev)
                data[dev * per_dev + local] = block
                if with_months:
                    months[dev * per_dev + local] = mo
                arena._slot[task.task_id] = (key, dev * per_dev + local)
                arena._dev_slot[task.task_id] = (key, dev, local)
            # physical order: device-major over the interleaved placement;
            # a tail row holds logical slot unshard_slot(dev, local) % b
            for dev in range(n_dev):
                for local in range(per_dev):
                    i = unshard_slot(dev, local, n_dev)
                    if i >= b:
                        src, src_local = shard_slot(i % b, n_dev)
                        data[dev * per_dev + local] = \
                            data[src * per_dev + src_local]
                        if with_months:
                            months[dev * per_dev + local] = \
                                months[src * per_dev + src_local]
            arena._data[key] = sharding.place(data)
            arena.nbytes += float(data.nbytes)
            arena._months[key] = None
            if with_months:
                arena._months[key] = sharding.place(months)
                arena.nbytes += float(months.nbytes)
            arena._per_dev[key] = per_dev
        return arena

    def dev_slots(self, tasks: Sequence) -> Tuple[Any, np.ndarray, np.ndarray]:
        """(key, devices, local rows) for a same-shape wave."""
        keys = {self._dev_slot[t.task_id][0] for t in tasks}
        if len(keys) != 1:
            raise ValueError(f"wave spans shape buckets: {keys}")
        key = keys.pop()
        devs = np.asarray([self._dev_slot[t.task_id][1] for t in tasks],
                          np.int32)
        rows = np.asarray([self._dev_slot[t.task_id][2] for t in tasks],
                          np.int32)
        return key, devs, rows


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
    if engine == "torch":
        return ss.run_map_task_np(block, months, seed, workload,
                                  device=device)
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


def _moments_wave_device(arena_data: torch.Tensor, rows: np.ndarray,
                         seeds: np.ndarray, *, n_idx: int) -> torch.Tensor:
    """The wave pipeline: the slot and seed vectors up → one
    ``subsample_stats_seeded`` launch, which reads the resident arena
    through the slots and draws each task's rows from its seed (jax's
    exact threefry draws) → ``[B, 2, D]`` on the device, on the current
    stream."""
    device = arena_data.device
    rows_t = torch.from_numpy(np.asarray(rows, np.int32)).to(device)
    seeds_t = torch.from_numpy(np.asarray(seeds, np.int32)).to(device)
    return ops.subsample_stats_seeded(arena_data, rows_t, seeds_t,
                                      n_idx=n_idx)


def _moments_wave(arena_data: torch.Tensor, rows: np.ndarray,
                  seeds: np.ndarray, *, n_idx: int) -> np.ndarray:
    """:func:`_moments_wave_device` → ``[B, 2, D]`` on the host."""
    return _moments_wave_device(arena_data, rows, seeds,
                                n_idx=n_idx).cpu().numpy()


def run_map_wave(arena: BlockArena, tasks: Sequence, seeds: np.ndarray,
                 workload, engine: str) -> List[Dict[str, np.ndarray]]:
    """Execute a wave of same-shape tasks in one kernel launch and split
    the batched result back into per-task reduce-tree partials.

    Both engines launch over the wave's own tasks only: their kernels take
    the wave width at run time and read the resident arena through the
    wave's slots, so no lane is padded and no block is copied.

    A :class:`ShardedBlockArena` routes to the multi-device dispatch —
    same signature, bit-identical results — so the wave closures in the
    driver, service pool and threaded backend need not know whether the
    arena is sharded.
    """
    if engine not in ("kernel", "torch"):
        raise ValueError(f"engine {engine!r} does not support wave execution")
    if isinstance(arena, ShardedBlockArena):
        return run_map_wave_sharded(arena, tasks, seeds, workload, engine)
    key, rows = arena.slots(tasks)
    seeds = np.asarray(seeds, np.int32)
    data, months = arena.bucket(key)
    if engine == "torch":
        if months is None:
            raise ValueError("torch waves need pack(with_months=True)")
        # one subsample_grid launch: the draws from the seeds in the
        # kernel, the resident arena read through the slots
        stats = ss.map_wave(data, months, rows, seeds, workload)
        return ss.split_partials(stats.cpu().numpy(), workload,
                                 data.shape[1])
    n_idx = workload.draws * workload.draw_size
    return _split_moments(_moments_wave(data, rows, seeds, n_idx=n_idx),
                          n_idx)


def run_map_wave_sharded(arena: ShardedBlockArena, tasks: Sequence,
                         seeds: np.ndarray, workload, engine: str,
                         ) -> List[Dict[str, np.ndarray]]:
    """Execute a wave across the arena's mesh and split the result back
    into per-task reduce-tree partials.

    The wave's members are routed to their owning entry's lanes, in wave
    order.  Every entry with a lane runs the unsharded wave's body over
    its own lanes only (one ``subsample_stats_seeded`` or
    ``subsample_grid_seeded`` launch reading its block of the arena
    through its local slots; no lane is padded, and an entry with no
    lane launches nothing), each on its own stream, all launched before
    any is read, so distinct cards overlap.  The partials are then
    gathered on the host in mesh order
    (:func:`~repro_torch.parallel.collectives.gather_shards`) and put
    back in task order.  A task's partial depends only on its block and
    seed, so the result is the unsharded wave's bit for bit.

    The mesh's streams are shared by every thread that dispatches waves:
    two workers' waves on one entry queue on its stream, one after the
    other, as two unsharded waves queue on the card's default stream.
    """
    if engine not in ("kernel", "torch"):
        raise ValueError(f"engine {engine!r} does not support wave execution")
    key, devs, local_rows = arena.dev_slots(tasks)
    seeds = np.asarray(seeds, np.int32)
    data, months = arena.bucket(key)
    if engine == "torch" and months is None:
        raise ValueError("torch waves need pack(with_months=True)")
    n_idx = workload.draws * workload.draw_size
    mesh = arena.mesh
    lanes, parts, streams = [], [], []
    for d in range(arena.n_dev):
        members = np.flatnonzero(devs == d)
        if not len(members):
            continue
        stream = mesh.stream(d)
        if stream is not None:
            # the arena was uploaded on the caller's stream
            stream.wait_stream(torch.cuda.current_stream(mesh.devices[d]))
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            # the slot and seed uploads, the launch and its output (with
            # the kernel's scratch) all on the entry's stream
            if engine == "torch":
                out = ss.map_wave(data[d], months[d], local_rows[members],
                                  seeds[members], workload)
            else:
                out = _moments_wave_device(data[d], local_rows[members],
                                           seeds[members], n_idx=n_idx)
        lanes.append(members)
        parts.append(out)
        streams.append(stream)
    gathered = col.gather_shards(parts, streams)
    stats = np.empty_like(gathered)
    stats[np.concatenate(lanes)] = gathered
    if engine == "torch":
        return ss.split_partials(stats, workload, data[0].shape[1])
    return _split_moments(stats, n_idx)


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
