"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and nvcc
(sm_90a).  It imports neither JAX nor the reference package ``repro``.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the six CUDA kernels from ``src/repro_torch``
   (``subsample_stats``, ``subsample_gather``, ``rwkv6_chunked``,
   ``rglru_scan``, ``flash_attention`` and ``subsample_grid``), one nvcc
   each, started together, and prints ptxas' registers, shared memory and
   spills.
3. Holds each kernel against its plain PyTorch version on the card, at
   the shapes its main path gives it and at shapes that take its other
   branches, and times kernel, plain version, the bound and, where one
   PyTorch call computes the same function, that call (``index_select``
   beside ``subsample_gather`` is a floor for its gather alone);
   ``flash_attention`` also gives its TFLOP/s and share of its bound, and
   a second launch at the serving shape must equal the first; the same
   for ``rwkv6_chunked``, which is also held at extreme decays (logw down
   to -40 a token) and timed pass by pass (its state pass and its output
   pass), with ptxas' lines for both.
   ``subsample_stats`` is held in both forms: the read form (indices
   given) and the draw form (the platform's: 16 slots, out of order, of
   an arena of 32 blocks ``[64, 65536]``, each task's 512 rows drawn in
   the kernel), the draw form bit for bit against the read form fed
   ``ops.randint``'s indices, at N = 40 (not a power of two) too, and at
   shapes that take its global body; both forms are timed.
   ``rglru_scan`` is held in both forms: the read form (``a`` and ``b``
   given) against its sequential plain version, and the gated form (the
   prefill's: the gates formed in the kernel from ``u``) against the gates
   as torch ops on the card followed by the read form, both bit for bit,
   at the serving shape, at S = 1, at widths off the kernel's channel
   block and on a view off 16-byte alignment; each is timed beside its
   bound, and the gated form beside the torch gates and read form it
   replaced.
4. Runs the platform's main path at real size: the full Netflix Prize catalogue
   (17,770 movies, its published mean of 5,654 ratings per movie) through
   ``Platform.run`` with the ``moments`` workload, BTS sizing with a
   64-movie task block, threaded backend, waves of 16.  The launch counts
   are zeroed just before and read just after this run: ``subsample_stats``
   must launch once a wave plus one warm-up a block shape, and nothing may
   draw indices outside it (no ``threefry_randint`` launch, no
   ``prng.randint`` call).  Then it times each stage of one wave, beside
   the stages of the pipeline the draw form replaced, and the per-task
   path's block build and upload, on the host; and reruns the job traced
   (telemetry and ``torch.profiler``) for each wave's host time inside
   the job and the device's busy share, with no ``index_select`` kernel
   in the trace.  Then it drives ``ops.subsample_gather`` on one
   real 64-movie block of that catalogue with the 512 rows a task draws,
   the launch counts zeroed just before and read just after, and holds
   its stats against ``ops.subsample_stats`` on the same block and rows.
5. Reruns that job per task (``wave="off"``) and asserts the result is
   bit-identical.  Then the paper's own workloads on ``subsample_grid``:
   phase 3f holds the kernel's own threefry draws (``ops.randint``)
   against ``prng.randint``, its draw form (the platform's path) against
   its read form fed those indices (bit for bit) and against its plain
   version, on real task blocks of EAGLET at the thesis' scale (400
   families, 131,072 markers on average, 230.5 MB) and of the Netflix
   catalogue, and at its other branches, and one task against float64
   numpy, and times the draw form at waves of 16 and 3; each case names
   the body ``subsample_grid``'s launcher took (``plan``: the staged body
   where a row fits shared memory and has as many draws as elements, else
   the direct one) and holds both bodies, forced, bit for bit against
   each other, and waves of 16, 3 and 1 against each other; a weighted
   ``torch.bincount`` over the same cells and values is timed as a floor
   for the binning alone.  ``grid_split`` times the kernel at the jobs'
   own launch shapes (NETFLIX_HIGH ``[64, 16384]`` and ``[64, 32768]`` at
   waves of 1 and 3, NETFLIX_LOW, EAGLET ``[64, 524288]`` and ``[64,
   2097152]``), warm and cold, beside its element and sector bounds; step
   4c runs the catalogue through ``Platform.run`` as NETFLIX_LOW
   (``wave="auto"``) and
   NETFLIX_HIGH (waves and per task, bit-identical); step 4b runs EAGLET
   the same way.  Each of those jobs runs under ``torch.profiler``, the
   launch counts zeroed just before and read just after (waves or tasks
   plus one warm-up a block shape) and prints the kernel's device ms a
   launch.  Then a 512-movie ``moments`` job on the threaded and the
   simulated backend, bit-identical and agreeing
   with a float64 numpy reference computed from the same draws; and
   EAGLET (48 families) and NETFLIX_LOW (512 movies) threaded ≡ simulated
   bit for bit.
6. Serves ``rwkv6-7b`` at full width (32 layers, d_model 4096, bf16
   weights from a seed) through ``ServingEngine.generate``: batch 4, a
   1,000-token prompt, 32 new tokens; the launch counts are zeroed just
   before and read just after, and prefill must launch ``rwkv6_chunked``
   once per layer.  One ``torch.profiler`` pass over a prefill and one
   over a decode step give the kernel's share of prefill device time (both
   passes, and each alone) and the device's busy share of each.  Then, in
   float32 weights at full width with the depth cut to 4 layers, decoding
   token x after
   ``prefill(P)`` must give the logits of the last position of
   ``prefill(P ++ [x])``.
8. Serves ``recurrentgemma-2b`` at full width (26 layers: 18 RG-LRU and 8
   local attention with a 2,048 window, d_model 2560, bf16 weights from a
   seed) through ``ServingEngine.generate``: batch 4, a 4,096-token prompt
   (longer than the window, so the cache roll and the window mask both
   run), 32 new tokens; prefill must launch ``rglru_scan`` 18 times and
   ``flash_attention`` 8 times.  One ``torch.profiler`` pass over a
   prefill and one over a decode step; then each part of one RG-LRU
   block's prefill (projections, conv taps, the gates as torch ops, both
   forms of ``rglru_scan``, ``h * y``) timed apart by CUDA events.
9. The decode ≡ prefill invariant for ``recurrentgemma-2b``: full width,
   depth cut to 8 layers, float32 weights, at P = 64 (shorter than the
   window) and P = 2,112 (longer).
10. Between steps 4b/4c and the 512-movie jobs, on the same datasets: the
   platform's data plane and recovery, each job bit for bit against its
   run without them and its launches counted (waves plus warm-ups).  10a
   the ``moments`` job with a ``ReplicatedDataStore`` (3 nodes, balanced
   claims, prefetch, block cache), no index drawn on the host; 10b
   NETFLIX_HIGH and EAGLET with the same; 10c NETFLIX_HIGH under a seeded
   ``FaultPlan`` (a worker crash, a node killed and revived, a latency
   spike) with leases, every planned event fired; 10d the ``moments``
   job checkpointed (saves and bytes printed), then crashed at a save and
   resumed, launching only for the missing tasks; 10e bench_balance.py's
   degraded data plane (10 ms a fetch, one node of three 5x slower) at
   512 movies, balanced off and on, both makespans printed.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises, and the script then
exits non-zero without printing that line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
INT32_OPS_PER_S = 16.7e12      # derived: 64 INT32 results a clock an SM x
                               # 132 SMs x 1.98 GHz (the clock behind the
                               # 67 TFLOP/s fp32 peak); no data-sheet rate
THREEFRY_OPS = 75              # 32-bit integer operations of one hash
RTOL, ATOL = 1e-5, 1e-4        # kernel vs plain: same rows, fp32 sums
# rwkv6_chunked vs its plain version: the same fp32 chunk form from the
# same inputs, with the same log-decay sums (a cumulative sum in row order,
# as torch.cumsum takes it on the card along a dimension that is not the
# last), its products added in other orders on the tensor cores, each fp32
# operand split into two TF32 parts (about 2^-21 of each product): outputs
# of order 10 agree to a few ulps of the sums
RW_TOL = 1e-4
# decode after prefill(P) vs the last position of prefill(P ++ [x]), fp32
# weights: the single-step formula against the chunk form (a padded second
# chunk), over 4 layers of width 4,096 and a 65,536-way head
INVARIANT_TOL = 1e-3
# flash_attention vs its plain version.  fp32 (CUDA cores): the same fp32
# scores and softmax, products and the online softmax's rescaled partial
# sums added in other orders, so outputs of order 1 agree to ~1e-5.  bf16
# (tensor cores): products of bf16 values are exact in fp32, so the scores
# differ only in the order of summation; P enters P V as a bf16 high and low
# part, each weight kept to about 2^-17 (one bf16 term alone would err by
# up to 2^-9 of each weight, ~1e-4 on outputs near zero at the serving
# shape); so the fp32 output agrees to ~1e-5 again, and the bf16 output is
# one rounding of it: the two may part by one bf16 step (2^-8 relative,
# under 1e-2)
FA_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-4)}


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(data: torch.Tensor, idx: torch.Tensor, *, seeded=False,
           multiplier=0):
    """Least time for one ``subsample_stats`` call on the blocks ``data
    [B, N, D]`` (for the draw form, the arena's slots of the wave) and the
    indices ``idx [B, T]`` it reads or draws: every gathered row read once
    (the distinct rows this run's indices touch), the stats written once,
    and every index read once, or for the draw form, which draws them, each
    task's slot and seed read once, over 3.35 TB/s; against 3 fp32
    operations per gathered element over 67 TFLOP/s and, for the draw form,
    each index drawn once (one Threefry-2x32 hash, about 75 integer
    operations, where the span's multiplier is 0, else two) over 16.7 T/s
    (derived, ``INT32_OPS_PER_S``)."""
    b, _, d = data.shape
    t = idx.shape[1]
    rows = sum(int(torch.unique(idx[k]).numel()) for k in range(b))
    index_bytes = b * 8 if seeded else b * t * 4
    nbytes = rows * d * 4 + index_bytes + b * 2 * d * 4
    flops = 3.0 * b * t * d
    int_ops = (THREEFRY_OPS * (1 if multiplier == 0 else 2) * b * t
               if seeded else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _body(sg, data, t):
    cols = sg.tile_cols(data, t)
    return f"staged, C = {cols}" if cols else "global"


# the main path's wave: 16 slots, out of order, of an arena of 32 blocks
MAIN_SLOTS = [31, 2, 17, 8, 25, 0, 13, 29, 6, 21, 10, 3, 27, 15, 19, 4]


def check_seeded_kernel(ops, ref, prng, sg):
    """Phase 3, the draw form (the platform's path): on an arena of 32
    blocks ``[64, 65536]`` (the main path's), 16 slots out of order, 512
    rows a task; at N = 40 (a multiplier that is not 0: two hashes and
    ``%``); and at shapes that take the global body (N = 2,048; D = 1,030).
    Each case: the draw form ``torch.equal`` to the read form fed
    ``ops.randint``'s indices on ``arena[rows]``, within ``RTOL``/``ATOL``
    of its plain version, each task equal to itself as a wave of one.
    Returns the worst error and the main case's inputs."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # n_slots, n, d, slots, n_idx
        (32, 64, 65536, MAIN_SLOTS, 512),        # the main path's wave
        (8, 40, 4096, [5, 1, 7, 1], 512),         # N not a power of two
        (4, 2048, 1024, [3, 0, 2], 100),          # N past the staged tile
        (6, 48, 1030, [4, 1, 5, 0], 77),          # D % 4 != 0
    ]
    worst = 0.0
    for n_slots, n, d, slots, n_idx in cases:
        arena = torch.randn((n_slots, n, d), generator=gen, device=dev)
        rows = torch.tensor(slots, dtype=torch.int32, device=dev)
        seeds = torch.arange(len(slots), dtype=torch.int32, device=dev) * 3
        idx = ops.randint(seeds, (n_idx,), 0, n)
        got = ops.subsample_stats_seeded(arena, rows, seeds, n_idx=n_idx)
        blocks = arena[rows.long()].contiguous()
        read = ops.subsample_stats(blocks, idx)
        want = ref.subsample_stats_seeded_ref(arena, rows, seeds,
                                              n_idx=n_idx)
        torch.cuda.synchronize()
        if not torch.equal(got, read):
            raise AssertionError(f"draw form != read form at {(n, d)}")
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        for k in range(len(slots)):
            one = ops.subsample_stats_seeded(arena, rows[k:k + 1],
                                             seeds[k:k + 1], n_idx=n_idx)
            if not torch.equal(one[0], got[k]):
                raise AssertionError(f"task {k} of the wave != itself alone "
                                     f"at {(n, d)}")
        _, mult = prng._randint_multiplier(0, n)
        worst = max(worst, err)
        print(f"seeded kernel check arena {(n_slots, n, d)} slots {slots} "
              f"T={n_idx} (multiplier {mult}; {_body(sg, arena, n_idx)} "
              f"body): draw form == read form on ops.randint's indices bit "
              f"for bit; max_abs_err vs plain {err!r}; each task == itself "
              "alone")
        if d == 65536:
            main = (arena, rows, seeds, blocks, idx)
    return worst, main


def check_kernel(ops, ref, prng, sg):
    """Phase 3: the kernel against its plain version, on the card, both
    forms; times both forms at the main path's wave."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [(16, 64, 65536, 512),    # the main path's wave
             (3, 40, 96, 13),         # T not a multiple of 8
             (2, 2048, 1024, 64),     # N past the staged tile: global body
             (2, 17, 1030, 21)]       # D not a multiple of 4: scalar loads
    worst = 0.0
    for b, n, d, t in cases:
        data = torch.randn((b, n, d), generator=gen).to(dev)
        idx = prng.randint(prng.PRNGKey(torch.arange(b, dtype=torch.int32,
                                                     device=dev)),
                           (t,), 0, n)
        got = ops.subsample_stats(data, idx)
        want = ref.subsample_stats_ref(data, idx)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        singles = torch.cat([ops.subsample_stats(data[k:k + 1],
                                                 idx[k:k + 1])
                             for k in range(b)])
        if not torch.equal(got, singles):
            raise AssertionError(f"wave != single launches at {(b, n, d, t)}")
        worst = max(worst, err)
        print(f"kernel check B={b} N={n} D={d} T={t} ({_body(sg, data, t)} "
              f"body): max_abs_err={err!r} wave == single launches bitwise")
    seeded_err, (arena, rows, seeds, data, idx) = check_seeded_kernel(
        ops, ref, prng, sg)
    # the kernel through its binding; the op also checks that every slot
    # lies in the arena, which reads the slots back to the host
    ms = _time_ms(lambda: sg.subsample_stats_seeded(arena, rows, seeds,
                                                    n_idx=512))
    op_ms = _time_ms(lambda: ops.subsample_stats_seeded(arena, rows, seeds,
                                                        n_idx=512))
    read_ms = _time_ms(lambda: sg.subsample_stats_wave(data, idx))
    plain_ms = _time_ms(lambda: ref.subsample_stats_seeded_ref(
        arena, rows, seeds, n_idx=512), reps=3)
    bound_ms, bound_by = _bound(data, idx, seeded=True)
    read_bound_ms, read_bound_by = _bound(data, idx)
    print(f"subsample_stats at the main path's wave (16 slots of an arena "
          f"[32, 64, 65536], T=512): draw form {ms!r} ms (through the op, "
          f"with its slot check, {op_ms!r} ms), bound "
          f"{bound_ms!r} ms ({bound_by}), share of the bound "
          f"{bound_ms / ms!r}; read form on the gathered [16, 64, 65536] "
          f"{read_ms!r} ms, bound {read_bound_ms!r} ms ({read_bound_by}); "
          f"plain (prng.randint, then the sums) {plain_ms!r} ms; no single "
          "PyTorch call computes this function, so library_ms is null")
    del arena, data
    torch.cuda.empty_cache()
    return {"max_abs_err": max(worst, seeded_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "read_form_ms": read_ms, "read_form_bound_ms": read_bound_ms}


def _gather_bound(data: torch.Tensor, idx: torch.Tensor, n_valid: int):
    """Least time for one ``subsample_gather`` call: the distinct rows this
    run's indices touch read once, the indices and n_valid read once, the
    ``[T, D]`` gathered rows and the ``[2, D]`` stats written once, over
    3.35 TB/s; against 3 fp32 operations for every element of the rows
    that count, over 67 TFLOP/s."""
    _, d = data.shape
    t = idx.shape[0]
    esize = data.element_size()
    rows = int(torch.unique(idx).numel())
    nbytes = rows * d * esize + t * 4 + 4 + t * d * esize + 2 * d * 4
    flops = 3.0 * min(max(n_valid, 0), t) * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gather_kernel(ops, ref):
    """Phase 3e: ``subsample_gather`` against its plain version on the
    card, gathered rows and stats equal bit for bit: at the main path's
    shape (one moments task's block, 64 movies wide, padded to 65,536
    ratings, 8 draws x 64 rows) in fp32 and bf16, with a masked padded
    tail (T = 13, n_valid = 9), at T = 1, and at D = 1,030 (scalar
    loads)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [  # n, d, t, n_valid, dtype
        (64, 65536, 512, 512, torch.float32),     # the main path's shape
        (64, 65536, 512, 512, torch.bfloat16),
        (40, 96, 13, 9, torch.float32),            # masked padded tail
        (40, 96, 13, 9, torch.bfloat16),
        (64, 4096, 1, 1, torch.float32),           # T = 1
        (17, 1030, 21, 21, torch.float32),         # D % 4 != 0: scalar
        (17, 1030, 21, 15, torch.bfloat16),
    ]
    worst = 0.0
    for n, d, t, n_valid, dtype in cases:
        data = torch.randn((n, d), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, n, (t,), generator=gen, device=dev,
                            dtype=torch.int32)
        nv = torch.full((1,), n_valid, dtype=torch.int32, device=dev)
        gathered, stats = ops._subsample_gather_padded(data, idx, nv)
        want_g, want_s = ref.subsample_gather_ref(data, idx, nv)
        torch.cuda.synchronize()
        err = float((stats - want_s).abs().max())
        if not (torch.equal(gathered, data[idx.long()])
                and torch.equal(gathered, want_g)
                and torch.equal(stats, want_s)):
            raise AssertionError(
                f"subsample_gather != its plain version at {(n, d, t)} "
                f"n_valid={n_valid} {dtype}: stats max_abs_err {err!r}")
        worst = max(worst, err)
        print(f"gather kernel check N={n} D={d} T={t} n_valid={n_valid} "
              f"{str(dtype).split('.')[-1]}: gathered == data[idx] and "
              f"stats == plain bit for bit (max_abs_err {err!r})")
        if (d, t, dtype) == (65536, 512, torch.float32):
            main = (data, idx, nv)
    data, idx, nv = main
    ms = _time_ms(lambda: ops._subsample_gather_padded(data, idx, nv))
    plain_ms = _time_ms(lambda: ref.subsample_gather_ref(data, idx, nv),
                        reps=3)
    bound_ms, bound_by = _gather_bound(data, idx, int(nv[0]))
    idx_long = idx.long()
    select_ms = _time_ms(lambda: torch.index_select(data, 0, idx_long))
    print(f"subsample_gather at [64, 65536] fp32, T=512: kernel {ms!r} ms, "
          f"plain {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}); "
          f"torch.index_select alone {select_ms!r} ms (a floor for the "
          "gather without the stats); no single PyTorch call computes "
          "gathered rows and stats, so library_ms is null")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def netflix_block_gather(ops, prng, block: np.ndarray) -> int:
    """Step 4's gather path: ``ops.subsample_gather`` on one real task
    block of the catalogue with the 512 rows the wave draws for seed 0,
    the launch counts zeroed just before and read just after.  Its stats
    must be ``allclose`` to ``ops.subsample_stats`` on the same block and
    rows (only the order of summation differs) and its rows equal
    ``block[idx]``.  Returns the launch count."""
    data = torch.from_numpy(block).to("cuda")
    seeds = torch.zeros(1, dtype=torch.int32, device="cuda")
    idx = prng.randint(prng.PRNGKey(seeds), (512,), 0, data.shape[0])
    ops.reset_launch_count()
    gathered, stats = ops.subsample_gather(data, idx[0])
    launches = ops.launch_count("subsample_gather")
    want = ops.subsample_stats(data[None], idx)[0]
    torch.cuda.synchronize()
    err = float((stats - want).abs().max())
    print(f"netflix block {tuple(data.shape)} {data.dtype}, T=512: "
          f"subsample_gather launches {launches}; stats vs subsample_stats "
          f"max_abs_err {err!r} (rtol {RTOL}, atol {ATOL}), gathered == "
          f"block[idx] {torch.equal(gathered, data[idx[0].long()])}")
    if launches < 1:
        raise AssertionError("the gather path launched no subsample_gather "
                             "kernel")
    if not torch.equal(gathered, data[idx[0].long()]):
        raise AssertionError("subsample_gather rows != block[idx]")
    torch.testing.assert_close(stats, want, rtol=RTOL, atol=ATOL)
    return launches


def _rwkv6_inputs(b, h, s, hd, gen, dtype=torch.bfloat16, span=2.45):
    """bf16 r/k/v/u (the model's types), fp32 decays in [-0.05 - span,
    -0.05] (span 2.45 the realistic range, 39.95 down to -40 a token) and
    a non-zero fp32 state, drawn on the card from ``gen``."""
    dev = torch.device("cuda")

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    r, k, v = (normal(b, h, s, hd).to(dtype) for _ in range(3))
    logw = -0.05 - span * torch.rand((b, h, s, hd), generator=gen,
                                     device=dev)
    u = normal(h, hd, scale=0.3).to(dtype)
    state = normal(b, h, hd, hd, scale=0.5)
    return r, k, v, logw, u, state


def _rwkv6_bound(r, logw, chunk):
    """Least time for one call: r/k/v/u/logw/state0 read once and
    out/state_out written once, over 3.35 TB/s, against the chunk form's
    operations over 495 TFLOP/s (TF32 dense).  Per (b, h) and chunk of C:
    the three products (2·C·hd² for inter, hd·C(C+1) for A v over j <= i,
    2·C·hd² for the state), the pairwise decays of A (5 per pair and
    column over j < i: difference, exponential, two products, sum; 3 on
    the diagonal) and about 10·C·hd + 3·hd² elementwise operations."""
    b, h, s, hd = r.shape
    esize = r.element_size()
    nbytes = (3 * b * h * s * hd * esize + b * h * s * hd * logw.element_size()
              + h * hd * esize + 2 * b * h * hd * hd * 4 + b * h * s * hd * 4)
    c = chunk
    per_chunk = (4 * c * hd * hd + hd * c * (c + 1)
                 + 5 * hd * c * (c - 1) // 2 + 3 * c * hd
                 + 10 * c * hd + 3 * hd * hd)
    flops = per_chunk * b * h * (s // c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / TF32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_rwkv6_kernel(ops, ref, rw):
    """Phase 3b: ``rwkv6_chunked`` against its plain version on the card,
    ``out`` and ``state_out``, at the serving shape (one layer's prefill of
    batch 4 at 1,024 tokens: 64 heads of 64, chunks of 64), a single short
    chunk, hd = 32 over 8 chunks, chunks of 16 and extreme decays (logw
    down to -40 a token); a second launch at the serving shape must equal
    the first bit for bit.  Times the op and each of its two passes at the
    serving shape, and prints ptxas' lines for both passes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for line in rw.build_info["log"].splitlines():
        if any(k in line for k in ("rwkv6_chunked", "registers", "spill")):
            print("  rwkv6 ptxas:", line.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(4, 64, 1024, 64, 64, 2.45),    # the main path's shape
             (2, 64, 13, 64, 64, 2.45),      # one short chunk: C = S = 13
             (4, 32, 256, 32, 32, 2.45),     # hd = 32, 8 chunks
             (4, 64, 256, 64, 16, 2.45),     # chunks of 16
             (4, 64, 256, 64, 64, 39.95)]    # extreme decays
    worst = 0.0
    for b, h, s, hd, chunk, span in cases:
        x = _rwkv6_inputs(b, h, s, hd, gen, span=span)
        out, state = ops.rwkv6_chunked(*x[:5], chunk=chunk, state=x[5])
        want, want_state = ref.rwkv6_chunk_form_ref(*x, min(chunk, s))
        torch.cuda.synchronize()
        err = max(float((out - want).abs().max()),
                  float((state - want_state).abs().max()))
        if not bool(torch.isfinite(out).all() and
                    torch.isfinite(state).all()):
            raise AssertionError("rwkv6_chunked gave a value that is not "
                                 "finite")
        torch.testing.assert_close(out, want, rtol=RW_TOL, atol=RW_TOL)
        torch.testing.assert_close(state, want_state, rtol=RW_TOL,
                                   atol=RW_TOL)
        worst = max(worst, err)
        print(f"rwkv6 kernel check B={b} H={h} S={s} hd={hd} C={chunk} "
              f"logw down to {-0.05 - span:.2f}: max_abs_err={err!r} over "
              f"out and state_out, outputs up to "
              f"{float(want.abs().max())!r} (tolerance {RW_TOL}: the same "
              "fp32 chunk form and log-decay sums, products in another "
              "order)")
        if (b, h, s, hd, chunk, span) == cases[0]:
            main = (x, chunk, out, state)
    x, chunk, out, state = main
    again = ops.rwkv6_chunked(*x[:5], chunk=chunk, state=x[5])
    torch.cuda.synchronize()
    if not (torch.equal(again[0], out) and torch.equal(again[1], state)):
        raise AssertionError("two rwkv6_chunked launches on the same inputs "
                             "differ")
    ms = _time_ms(lambda: ops.rwkv6_chunked(*x[:5], chunk=chunk,
                                            state=x[5]))
    bufs = (torch.empty_like(out), torch.empty_like(state),
            rw.scratch_states(x[0], chunk))
    pass_ms = {}
    for name, passes in (("state_pass_ms", rw.STATE_PASS),
                         ("out_pass_ms", rw.OUT_PASS)):
        pass_ms[name] = _time_ms(lambda: rw.launch(
            *x[:5], x[5], chunk, *bufs, passes=passes))
    plain_ms = _time_ms(lambda: ref.rwkv6_chunk_form_ref(*x, chunk), reps=3)
    bound_ms, bound_by = _rwkv6_bound(x[0], x[3], chunk)
    print(f"rwkv6_chunked at [4, 64, 1024, 64] bf16 r/k/v/u, fp32 logw, "
          f"C=64: kernel {ms!r} ms (state pass {pass_ms['state_pass_ms']!r}"
          f" ms, output pass {pass_ms['out_pass_ms']!r} ms), plain "
          f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}); two "
          "launches equal bit for bit; no PyTorch call computes this "
          "function, so library_ms is null")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **pass_ms}


def _profiled(label, fn, kernels=("rwkv6_chunked",), *, ran=(), absent=()):
    """``fn()`` once under ``torch.profiler``, closed by a synchronise:
    its host wall time, the device time and each of ``kernels``' share of
    it, the device's busy share of the host wall time, and the device
    operations by name.  Fails unless every name in ``ran`` took device
    time and no device operation's name holds one of ``absent``.  Returns
    what ``fn`` returned."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    if not dev:
        raise AssertionError(f"the profiler saw no device time in {label}")
    total = sum(end - start for start, end, _ in dev)
    shares = {k: sum(end - start for start, end, name in dev if k in name)
              for k in kernels}
    for k in ran:
        if not any(k in name and end > start for start, end, name in dev):
            raise AssertionError(f"{label}: no device time in {k}")
    for k in absent:
        seen = sorted({name for _, _, name in dev if k in name})
        if seen:
            raise AssertionError(f"{label}: ran {seen}, not expected")
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, _ in dev:
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    by_name = {}
    for start, end, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    kernel_text = ", ".join(f"{k} {t / 1e3!r} ms (share {t / total!r})"
                            for k, t in shares.items())
    print(f"{label} under the profiler: host wall {wall_us / 1e3!r} ms, "
          f"{len(dev)} device operations, device time {total / 1e3!r} ms, "
          f"{kernel_text}; "
          f"device busy {busy / 1e3!r} ms (share of the wall "
          f"{busy / wall_us!r}); top device ms by name "
          f"{json.dumps([[n[:60], round(t, 3)] for n, t in top])}")
    return out


def serve_full_width(ops):
    """Phase 6: ``rwkv6-7b`` at full width, bf16 weights from a seed,
    through ``ServingEngine.generate``; returns the rwkv6_chunked launch
    count of the measured run."""
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine, grow_caches

    cfg = get_config("rwkv6-7b")
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"rwkv6-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.rwkv_num_heads} heads of {cfg.rwkv_head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} bf16 parameters "
          f"({cfg.param_count()} by the config's count, which leaves out "
          f"the decay biases and the final norm) drawn on the card in "
          f"{time.perf_counter() - t0!r} s")
    engine = ServingEngine(model, params, max_new_tokens=32)
    batch = model.make_inputs(ShapeConfig("serve", "prefill", 1000, 4),
                              model.generator(1))
    warm = engine.generate(batch, new_tokens=2)
    print(f"warm-up generate (2 new tokens): prefill "
          f"{warm.prefill_seconds!r} s, decode {warm.decode_seconds!r} s")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    out = engine.generate(batch, new_tokens=32)
    launches = ops.launch_count("rwkv6_chunked")
    other = ops.launch_count("subsample_stats")
    peak = torch.cuda.max_memory_allocated()
    print(f"serving rwkv6-7b, batch 4, prompt 1000 (16 chunks of 64 after "
          f"padding), 32 new tokens: prefill_seconds "
          f"{out.prefill_seconds!r}, decode_seconds {out.decode_seconds!r}, "
          f"tokens_per_second {out.tokens_per_second!r}, peak device "
          f"memory {peak} bytes; rwkv6_chunked launches {launches}, "
          f"subsample_stats launches {other}")
    if launches != cfg.num_layers:
        raise AssertionError(f"prefill launched rwkv6_chunked {launches} "
                             f"times, not once per layer ({cfg.num_layers})")
    if out.tokens.shape != (4, 32) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generated tokens: shape {out.tokens.shape}")
    with torch.inference_mode():
        logits, caches = _profiled(
            "prefill", lambda: model.prefill(params, batch),
            kernels=("rwkv6_chunked", "rwkv6_chunked_state",
                     "rwkv6_chunked_out"))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite")
        caches = model.prefill_to_decode(grow_caches(caches, 1001))
        tok = torch.argmax(logits, dim=-1)[:, None]
        logits, _ = _profiled("one decode step", lambda: model.decode_step(
            params, tok, caches, 1000))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("decode logits are not finite")
    del caches
    del engine, params
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    from repro_torch.tree import tree_leaves_with_path

    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def decode_invariant():
    """Phase 7: decoding token x after ``prefill(P)`` gives the logits of
    the last position of ``prefill(P ++ [x])``: full width, float32
    weights, depth cut to 4 layers; the token-shift mixes, decay bias and
    bonus drawn away from their zero init so that every carried state is
    read.  P is one chunk (64 tokens), so P ++ [x] pads a second."""
    from repro_torch.config import get_config
    from repro_torch.models import Model
    from repro_torch.serving import grow_caches

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=4,
                              dtype="float32")
    model = Model(cfg, device="cuda")
    gen = model.generator(2)
    params = model.init(gen)
    for block in params["blocks"]:
        mix = block["mix"]
        mix["mix"].uniform_(0.0, 1.0, generator=gen)
        mix["decay_bias"].normal_(-1.0, 0.5, generator=gen)
        mix["bonus_u"].normal_(0.0, 0.3, generator=gen)
        block["ffn"]["mix"].uniform_(0.0, 1.0, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        _, caches = model.prefill(params, {"tokens": tokens[:, :64]})
        caches = model.prefill_to_decode(grow_caches(caches, 65))
        stepped, _ = model.decode_step(params, tokens[:, 64:], caches, 64)
        whole, _ = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    err = float((stepped - whole).abs().max())
    scale = float(whole.abs().max())
    print(f"decode after prefill(P) vs prefill(P ++ [x]) at full width, 4 "
          f"layers, fp32: max_abs_err {err!r} on logits up to {scale!r} "
          f"(tolerance {INVARIANT_TOL}, relative and absolute)")
    if not bool(torch.isfinite(whole).all()):
        raise AssertionError("invariant logits are not finite")
    torch.testing.assert_close(stepped, whole, rtol=INVARIANT_TOL,
                               atol=INVARIANT_TOL)
    del params, caches
    torch.cuda.empty_cache()


def _rglru_bound(a):
    """Least time for one read-form call: a and b read once, h0 read once
    and out written once over 3.35 TB/s, against 2 fp32 operations an
    element over 67 TFLOP/s."""
    b, s, w = a.shape
    nbytes = 3 * b * s * w * 4 + b * w * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * s * w / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# fp32 operations of one element of the gated form, counted from
# kernels/ref.py rglru_gates (each exp, quotient and root one): two gates
# of a multiply, an add and a sigmoid (negate, exp, add, divide), -8·r·sp
# and its exp, 1 − a², the clamp and the root, i·u and the product, and
# the recurrence's multiply and add
RGLRU_GATED_OPS = 23


def _rglru_gated_bound(u, gate_vectors):
    """Least time for one gated-form call: u, h0, the gate vectors and
    softplus(Λ) read once and out written once over 3.35 TB/s, against
    ``RGLRU_GATED_OPS`` fp32 operations an element over 67 TFLOP/s."""
    b, s, w = u.shape
    nbytes = (u.numel() * u.element_size() + b * s * w * 4 + b * w * 4
              + sum(t.numel() * t.element_size() for t in gate_vectors))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = RGLRU_GATED_OPS * b * s * w / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _rglru_gate_vectors(w, dtype, gen, lam_mean=1.0):
    """The four gate vectors in ``dtype`` and softplus(Λ) fp32, drawn away
    from their one/zero inits as a trained model's are."""
    def normal(mean, std):
        return (mean + std * torch.randn((w,), generator=gen,
                                         device="cuda")).to(dtype)

    lam = normal(lam_mean, 0.3).float()
    return (normal(1.0, 0.3), normal(0.0, 0.2), normal(1.0, 0.3),
            normal(0.0, 0.2), torch.nn.functional.softplus(lam))


def check_rglru_kernel(ops, ref):
    """Phase 3c: both forms of ``rglru_scan`` on the card.  The read form
    against its sequential plain version at the serving shape (one RG-LRU
    layer's prefill of batch 4 at 4,096 tokens, width 2,560) with a
    non-zero h0, at S = 1, at widths that are not a multiple of the
    kernel's 16-channel block, and on a view 4 bytes off 16-byte alignment:
    both round a·h, then add b, one step after another, so they are equal
    bit for bit.  The gated form (the prefill's) against the gates as torch
    ops on the card followed by the read form, at the serving shape with
    bf16 u and gate vectors (the model's types), in fp32, at ragged shapes
    and with Λ so negative that the clamp of 1 − a² binds: the kernel
    takes the gates' operations one by one in the same order, so equal bit
    for bit, and so to its plain version ``ref.rglru_gated_scan_ref`` (the
    same torch gates, then the sequential scan).  A second gated launch must equal the first.  Times both
    forms, their plain versions and bounds, and the torch gates followed
    by the read form, the pipeline the gated form replaced."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0

    def same(got, want, what):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bit for bit, max_abs_err "
                                 f"{err!r}")
        print(f"rglru kernel check, {what}: max_abs_err {err!r} (bit for "
              "bit, as required)")
        return err

    for b, s, w, offset in [(4, 4096, 2560, 0), (2, 13, 100, 0),
                            (1, 1, 7, 0), (3, 70, 2563, 0), (2, 67, 96, 1)]:
        n = b * s * w
        a = (0.2 + 0.79 * torch.rand((n + offset,), generator=gen,
                                     device="cuda"))[offset:].view(b, s, w)
        x = 0.5 * torch.randn((b, s, w), generator=gen, device="cuda")
        h0 = torch.randn((b, w), generator=gen, device="cuda")
        worst = max(worst, same(ops.rglru_scan(a, x, h0),
                                ref.linear_scan_ref(a, x, h0),
                                f"read form B={b} S={s} W={w}, a at "
                                f"{a.data_ptr() % 16} bytes past 16"))
        if s == 4096:
            main = (a, x, h0)

    for b, s, w, dtype, lam_mean in [
            (4, 4096, 2560, torch.bfloat16, 1.0),
            (2, 13, 100, torch.float32, 1.0), (1, 1, 7, torch.bfloat16, 1.0),
            (3, 70, 2563, torch.bfloat16, 1.0),
            (2, 200, 48, torch.float32, -20.0)]:
        u = (2.0 * torch.randn((b, s, w), generator=gen,
                               device="cuda")).to(dtype)
        gv = _rglru_gate_vectors(w, dtype, gen, lam_mean)
        h0 = torch.randn((b, w), generator=gen, device="cuda")
        got = ops.rglru_gated_scan(u, *gv, h0)
        what = (f"gated form B={b} S={s} W={w} {str(dtype).split('.')[-1]} "
                f"u and gates, Λ ~ {lam_mean}")
        worst = max(worst, same(got, ref.rglru_gated_scan_ref(u, *gv, h0),
                                f"{what}, against its plain version"),
                    same(got, ops.rglru_scan(*ref.rglru_gates(u, *gv), h0),
                         f"{what}, against torch gates + read form"))
        if s == 4096:
            gated_main = (u, gv, h0, got)
    u, gv, h0, first = gated_main
    if not torch.equal(first, ops.rglru_gated_scan(u, *gv, h0)):
        raise AssertionError("two rglru_gated_scan launches on the serving "
                             "shape's inputs differ")
    pre = gv[0] * u.float() + gv[1]
    sig_formula = torch.equal(torch.sigmoid(pre), 1 / (1 + torch.exp(-pre)))
    print(f"torch.sigmoid on the card equals 1 / (1 + exp(-x)) bit for bit "
          f"on the serving shape's gate inputs: {sig_formula}")

    a, x, h0r = main
    read = {"ms": _time_ms(lambda: ops.rglru_scan(a, x, h0r)),
            "plain_ms": _time_ms(lambda: ref.linear_scan_ref(a, x, h0r),
                                 reps=3)}
    read["bound_ms"], read["bound_by"] = _rglru_bound(a)
    ms = _time_ms(lambda: ops.rglru_gated_scan(u, *gv, h0))
    plain_ms = _time_ms(lambda: ref.rglru_gated_scan_ref(u, *gv, h0), reps=3)
    torch_gates_ms = _time_ms(lambda: ops.rglru_scan(
        *ref.rglru_gates(u, *gv), h0))
    bound_ms, bound_by = _rglru_gated_bound(u, gv)
    print(f"rglru_scan read form at [4, 4096, 2560] fp32: kernel "
          f"{read['ms']!r} ms, plain {read['plain_ms']!r} ms, bound "
          f"{read['bound_ms']!r} ms ({read['bound_by']}); gated form at "
          f"[4, 4096, 2560] bf16 u and gates: kernel {ms!r} ms, plain "
          f"{plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}), torch gates "
          f"+ read form {torch_gates_ms!r} ms; two gated launches equal bit "
          "for bit; no PyTorch call computes a linear recurrence with a "
          "decay per element, so library_ms is null")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "torch_gates_and_read_form_ms": torch_gates_ms,
            "read_form": read}


def _flash_bound(q, k, causal, window, group):
    """Least time for one call: q, k and v read once and out written once
    over 3.35 TB/s, against 4·HD operations for every (query, key) pair
    this call's mask leaves (two products of HD multiply-adds) over the
    tensor-core rate of the inputs' type (bf16 989, else TF32 495
    TFLOP/s)."""
    from repro_torch.kernels import ref

    bh, sq, hd = q.shape
    skv = k.shape[1]
    esize = q.element_size()
    nbytes = (2 * bh * sq * hd + 2 * (bh // group) * skv * hd) * esize
    pairs = int(ref.attention_mask(sq, skv, causal=causal, window=window,
                                   device=q.device).sum()) * bh
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else TF32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * hd * pairs / rate * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, pairs


def _sdpa_ms(q, k, v, causal, window, group):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the same inputs, k and v expanded to every query head and the mask
    given as a boolean tensor."""
    from repro_torch.kernels import ref

    bh, sq, hd = q.shape
    skv = k.shape[1]
    mask = ref.attention_mask(sq, skv, causal=causal, window=window,
                              device=q.device)
    qs = q.view(bh // group, group, sq, hd)
    ks = k.view(bh // group, 1, skv, hd).expand(-1, group, -1, -1)
    vs = v.view(bh // group, 1, skv, hd).expand(-1, group, -1, -1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask), reps=10)


def check_flash_kernel(ops, ref):
    """Phase 3d: ``flash_attention`` against its plain version on the card:
    at the serving shape (one local layer's prefill of batch 4 at 4,096
    tokens: 40 query heads of 256 on 4 KV heads, window 2,048, bf16), at
    window 0 and group 1 causal and not (the TPU kernel's function), at
    HD 32 with a ragged Sq = Skv = 1,000, and in fp32 at HD 256; then bf16
    (the tensor-core body) at HD 32 with Sq < Skv, at HD 64 with a window
    below one tile and Sq > Skv, at Sq = 1 against 1,000 keys, and with q
    and k scaled by 8 (large score gaps for the online rescale).  At the
    serving shape a second launch must equal the first bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [  # bh, sq, skv, hd, causal, window, group, dtype, q and k scale
        (40, 4096, 4096, 256, True, 2048, 10, torch.bfloat16, 1),
        (8, 2048, 2048, 128, True, 0, 1, torch.bfloat16, 1),
        (8, 2048, 2048, 128, False, 0, 1, torch.bfloat16, 1),
        (16, 1000, 1000, 32, True, 0, 1, torch.float32, 1),
        (16, 1000, 1000, 32, True, 256, 4, torch.bfloat16, 1),
        (20, 577, 577, 256, True, 128, 10, torch.float32, 1),
        (8, 577, 1000, 32, False, 0, 2, torch.bfloat16, 1),
        (8, 1000, 577, 64, True, 16, 1, torch.bfloat16, 1),
        (6, 1, 1000, 256, False, 0, 3, torch.bfloat16, 1),
        (8, 1000, 1000, 256, True, 300, 2, torch.bfloat16, 8),
    ]
    worst = 0.0
    for bh, sq, skv, hd, causal, window, group, dtype, scale in cases:
        q = torch.randn((bh, sq, hd), generator=gen, device="cuda")
        k, v = (torch.randn((bh // group, skv, hd), generator=gen,
                            device="cuda") for _ in range(2))
        q, k, v = q.mul(scale).to(dtype), k.mul(scale).to(dtype), v.to(dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  group=group)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       group=group)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        rtol, atol = FA_TOL[dtype]
        torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
        worst = max(worst, err)
        print(f"flash kernel check BH={bh} Sq={sq} Skv={skv} HD={hd} "
              f"causal={causal} window={window} group={group} "
              f"{str(dtype).split('.')[-1]} q, k x{scale}: max_abs_err "
              f"{err!r} (rtol {rtol}, atol {atol})")
        if (bh, sq) == (40, 4096):
            main = (q, k, v, causal, window, group, out)
    q, k, v, causal, window, group, first = main
    again = ops.flash_attention(q, k, v, causal=causal, window=window,
                                group=group)
    if not torch.equal(first, again):
        raise AssertionError("two flash_attention launches on the serving "
                             "shape's inputs differ")
    ms = _time_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                              window=window, group=group),
                  reps=10)
    plain_ms = _time_ms(lambda: ref.flash_attention_ref(
        q, k, v, causal=causal, window=window, group=group), reps=3)
    (bound_ms, bound_by), pairs = _flash_bound(q, k, causal, window, group)
    library_ms = _sdpa_ms(q, k, v, causal, window, group)
    tflops = 4.0 * q.shape[2] * pairs / ms / 1e9
    print(f"flash_attention at q [40, 4096, 256] bf16, k, v [4, 4096, 256], "
          f"window 2048, group 10 ({pairs} query-key pairs): kernel {ms!r} "
          f"ms ({tflops!r} TFLOP/s, {bound_ms / ms!r} of its bound; a "
          f"second launch equal bit for bit), plain {plain_ms!r} ms, bound "
          f"{bound_ms!r} ms ({bound_by}), scaled_dot_product_attention "
          f"with a boolean mask {library_ms!r} ms")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def serve_recurrentgemma(ops):
    """Phase 8: ``recurrentgemma-2b`` at full width, bf16 weights from a
    seed, through ``ServingEngine.generate``; returns the launch counts of
    the measured run."""
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine, grow_caches

    cfg = get_config("recurrentgemma-2b")
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    kinds = cfg.layer_kinds()
    print(f"recurrentgemma-2b: {cfg.num_layers} layers "
          f"({kinds.count('rglru')} RG-LRU, {kinds.count('local')} local "
          f"attention, window {cfg.local_window}), d_model {cfg.d_model}, "
          f"{cfg.num_heads} query heads of {cfg.head_dim} on "
          f"{cfg.num_kv_heads} KV head, lru width {cfg.lru_width}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} bf16 parameters "
          f"({cfg.param_count()} by the config's count) drawn on the card "
          f"in {time.perf_counter() - t0!r} s")
    engine = ServingEngine(model, params, max_new_tokens=32)
    batch = model.make_inputs(ShapeConfig("serve", "prefill", 4096, 4),
                              model.generator(1))
    warm = engine.generate(batch, new_tokens=2)
    print(f"warm-up generate (2 new tokens): prefill "
          f"{warm.prefill_seconds!r} s, decode {warm.decode_seconds!r} s")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    out = engine.generate(batch, new_tokens=32)
    launches = {name: ops.launch_count(name) for name in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    print(f"serving recurrentgemma-2b, batch 4, prompt 4096, 32 new tokens: "
          f"prefill_seconds {out.prefill_seconds!r}, decode_seconds "
          f"{out.decode_seconds!r}, tokens_per_second "
          f"{out.tokens_per_second!r}, peak device memory {peak} bytes; "
          f"launches {json.dumps(launches)}")
    if (launches["rglru_scan"], launches["flash_attention"]) != (18, 8):
        raise AssertionError(f"prefill launched rglru_scan "
                             f"{launches['rglru_scan']} and flash_attention "
                             f"{launches['flash_attention']} times, not 18 "
                             "and 8")
    if out.tokens.shape != (4, 32) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generated tokens: shape {out.tokens.shape}")
    kernels = ("rglru", "rglru_gated_scan", "flash_attention")
    with torch.inference_mode():
        # the prefill runs the gated form, never the read form's kernel
        logits, caches = _profiled(
            "recurrentgemma-2b prefill", lambda: model.prefill(params, batch),
            kernels, ran=("rglru_gated_scan", "flash_attention"),
            absent=("rglru_scan_kernel",))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite")
        caches = model.prefill_to_decode(
            grow_caches(caches, 4097, cfg.local_window))
        tok = torch.argmax(logits, dim=-1)[:, None]
        logits, _ = _profiled(
            "recurrentgemma-2b decode step",
            lambda: model.decode_step(params, tok, caches, 4096), kernels,
            absent=("rglru_gated_scan", "rglru_scan_kernel"))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("decode logits are not finite")
    del caches
    rglru_block_split(ops, cfg, params)
    del engine, params
    torch.cuda.empty_cache()
    return launches


def rglru_block_split(ops, cfg, params):
    """Device time of each part of one RG-LRU block's prefill at the
    serving shape (batch 4, 4,096 tokens, width 2,560, bf16), by CUDA
    events on the first RG-LRU layer's weights: the two projections and
    the GeLU, the conv taps, the gates as torch ops, the read form of
    ``rglru_scan`` on them, the gated form, ``h * y`` and the output
    projection.  Returns the parts in ms."""
    from repro_torch.models import rglru as RG

    gen = torch.Generator(device="cuda").manual_seed(7)
    p = {k: v[0] for k, v in params["blocks"][0]["mix"].items()}
    b, s = 4, 4096
    x = torch.randn((b, s, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    conv0 = torch.zeros((b, cfg.conv_width - 1, cfg.lru_width),
                        device="cuda")
    h0 = torch.zeros((b, cfg.lru_width), device="cuda")
    with torch.inference_mode():
        u0 = x @ p["w_x"]
        y = RG._gelu(x @ p["w_y"])
        u, _ = RG._causal_conv(p, u0, conv0)
        a, gated = RG._gates(p, u)
        h = ops.rglru_scan(a, gated, h0)
        sp = torch.nn.functional.softplus(p["lam"].float())
        parts = {
            "projections_and_gelu": lambda: (x @ p["w_x"],
                                             RG._gelu(x @ p["w_y"])),
            "conv_taps": lambda: RG._causal_conv(p, u0, conv0),
            "gates_torch": lambda: RG._gates(p, u),
            "read_form": lambda: ops.rglru_scan(a, gated, h0),
            "h_times_y": lambda: (h * y.float()).to(x.dtype),
            "out_projection": lambda: (h * y.float()).to(x.dtype)
            @ p["w_out"],
            "gated_form": lambda: ops.rglru_gated_scan(
                u, p["gate_a_w"], p["gate_a_b"], p["gate_x_w"],
                p["gate_x_b"], sp, h0),
            "block": lambda: RG.rglru_apply(
                cfg, p, x, {"h": h0, "conv": conv0}),
        }
        ms = {name: _time_ms(fn, reps=10) for name, fn in parts.items()}
    print(f"recurrentgemma-2b RG-LRU block parts at [4, 4096, 2560] bf16 "
          f"(first RG-LRU layer's weights, device ms by CUDA events; "
          f"out_projection includes h_times_y): {json.dumps(ms)}")
    return ms


def rg_decode_invariant():
    """Phase 9: for ``recurrentgemma-2b`` at full width, float32 weights
    and the depth cut to 8 layers (2 blocks and the tail), decoding token
    x after ``prefill(P)`` gives the logits of the last position of
    ``prefill(P ++ [x])``; P = 64 is shorter than the 2,048 window, P =
    2,112 longer, so the cache roll runs.  Λ, the gate biases and the
    conv bias are drawn away from their one/zero inits."""
    from repro_torch.config import get_config
    from repro_torch.models import Model
    from repro_torch.serving import grow_caches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=8,
                              dtype="float32")
    model = Model(cfg, device="cuda")
    gen = model.generator(5)
    params = model.init(gen)
    for block in params["blocks"] + params["tail"]:
        mix = block["mix"]
        if "lam" in mix:
            mix["lam"].normal_(1.0, 0.3, generator=gen)
            for name in ("gate_a_b", "gate_x_b", "conv_b"):
                mix[name].normal_(0.0, 0.1, generator=gen)
    for p in (64, 2112):
        tokens = torch.randint(0, cfg.vocab_size, (2, p + 1), generator=gen,
                               device="cuda")
        with torch.inference_mode():
            _, caches = model.prefill(params, {"tokens": tokens[:, :p]})
            caches = model.prefill_to_decode(
                grow_caches(caches, p + 1, cfg.local_window))
            stepped, _ = model.decode_step(params, tokens[:, p:], caches, p)
            whole, _ = model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        err = float((stepped - whole).abs().max())
        scale = float(whole.abs().max())
        print(f"recurrentgemma-2b decode after prefill(P) vs prefill(P ++ "
              f"[x]) at full width, 8 layers, fp32, P={p}: max_abs_err "
              f"{err!r} on logits up to {scale!r} (tolerance "
              f"{INVARIANT_TOL}, relative and absolute)")
        if not bool(torch.isfinite(whole).all()):
            raise AssertionError("invariant logits are not finite")
        torch.testing.assert_close(stepped, whole, rtol=INVARIANT_TOL,
                                   atol=INVARIANT_TOL)
    del params, caches
    torch.cuda.empty_cache()


def _host_ms(fn, reps: int = 10) -> float:
    """Mean host wall time of ``fn`` followed by a synchronise, after one
    warm-up call: what one stage of the wave pipeline costs its worker."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def wave_anatomy(ops, prng, n_tasks: int, count: int, length: int,
                 build_block):
    """Host time of each stage of one 16-task wave of the main path
    (``compute._moments_wave``: the slot and seed vectors up, one
    ``subsample_stats_seeded`` launch, the stats down), on an arena of the
    main path's shape, and of the per-task path's block build and upload.
    Beside them, labelled ``removed_``, the stages of the pipeline this
    wave replaced (the slot gather by ``index_select``, ``prng.randint``,
    the read form on the gathered blocks), timed in the same run."""
    from repro_torch.platform import compute as pc

    arena = torch.empty((n_tasks, count, length), device="cuda").normal_()
    rows = np.asarray(MAIN_SLOTS, np.int32) % n_tasks
    seeds = np.arange(16, dtype=np.int32)
    state = {}

    def upload():
        state["rows"] = torch.from_numpy(rows).to("cuda")
        state["seeds"] = torch.from_numpy(seeds).to("cuda")

    def kernel():
        state["stats"] = ops.subsample_stats_seeded(
            arena, state["rows"], state["seeds"], n_idx=512)

    def copy_back():
        state["host"] = state["stats"].cpu().numpy()

    def whole():
        pc._moments_wave(arena, rows, seeds, n_idx=512)

    def gather():
        state["data"] = arena.index_select(0, state["rows"].long())

    def draw():
        state["idx"] = prng.randint(prng.PRNGKey(state["seeds"]), (512,), 0,
                                    count)

    def read_kernel():
        ops.subsample_stats(state["data"], state["idx"])

    block = np.ones((count, length), np.float32)
    stages = {name: _host_ms(fn) for name, fn in (
        ("slot_seed_upload", upload), ("seeded_kernel", kernel),
        ("stats_to_host", copy_back), ("whole_wave", whole),
        ("removed_index_select", gather), ("removed_prng_randint", draw),
        ("removed_read_kernel", read_kernel),
        ("per_task_block_build", build_block),
        ("per_task_block_upload",
         lambda: torch.from_numpy(block).to("cuda")))}
    print("wave anatomy (host ms per stage, 16-task wave of [64, 65536] "
          "blocks, 512 draws a task; removed_* are the stages of the wave "
          "before the draw form): " + json.dumps(stages))
    del arena, state


def traced_wave_run(Platform, spec, samples, months, workload):
    """A separate traced run of the main path (telemetry on, under
    ``torch.profiler``): the host seconds of each wave inside the job,
    and the device's busy share over the execute phase, taken as the span
    from the end of the warm-up wave's stats copy (the first device→host
    copy) to the end of the last one.  Fails if the device ran a slot
    gather (``index_select``'s kernel) anywhere in the job."""
    from torch.profiler import ProfilerActivity, profile

    plat = Platform(dataclasses.replace(spec, telemetry=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = plat.run(samples, months, workload)
    wave_s = sorted(e.fields["seconds"]
                    for e in plat.telemetry.events("wave_dispatched"))
    window_ms, busy_ms, by_kind = _execute_window(prof, "subsample_stats")
    gathers = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "indexSelect" in e.name)
    print(f"traced run: makespan {rep.makespan!r} s, {len(wave_s)} waves, "
          f"host seconds per wave median {wave_s[len(wave_s) // 2]!r} max "
          f"{wave_s[-1]!r}; execute window {window_ms!r} ms, device busy "
          f"{busy_ms!r} ms (share {busy_ms / window_ms!r}), device "
          f"ms by kind {json.dumps(by_kind)}; index_select kernels {gathers}")
    if gathers:
        raise AssertionError(f"the moments job ran {gathers} index_select "
                             "kernels")


def _execute_window(prof, kernel, names=None):
    """The device's work over a job's execute phase in a profiler trace:
    the window from the end of the first device→host copy (the warm-up's
    result) to the end of the last, the device's busy ms inside it (its
    intervals merged), and its ms by kind (``kernel``, whose device
    functions' names hold one of ``names``; copies; other)."""
    names = names or (kernel,)
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    d2h = [end for _, end, name in dev if "DtoH" in name]
    if len(d2h) < 2:
        raise AssertionError(f"the profiler saw {len(d2h)} device-to-host "
                             "copies: no execute window")
    lo, hi = d2h[0], d2h[-1]
    busy, cur_start, cur_end = 0.0, None, None
    by_kind = {kernel: 0.0, "memcpy": 0.0, "other": 0.0}
    for start, end, name in dev:
        if start < lo or end > hi:
            continue
        kind = (kernel if any(k in name for k in names)
                else "memcpy" if "Memcpy" in name else "other")
        by_kind[kind] += (end - start) / 1e3
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += 0.0 if cur_end is None else cur_end - cur_start
    return (hi - lo) / 1e3, busy / 1e3, by_kind


def _eaglet_thesis_scale():
    """The thesis' EAGLET dataset: 400 families of 131,072 markers on
    average (57.6 M markers, 230.5 MB of fp32), the 15x outlier at
    1,966,080 markers."""
    from repro_torch.data import EagletSpec, eaglet_dataset

    t0 = time.perf_counter()
    samples, months = eaglet_dataset(EagletSpec(n_families=400,
                                                mean_markers=131072))
    n = sum(a.shape[0] for a in samples.values())
    print(f"eaglet: 400 families, {n} markers, {n * 4} bytes of fp32, "
          f"largest {max(a.shape[0] for a in samples.values())}, made in "
          f"{time.perf_counter() - t0!r} s")
    return samples, months


def _tasks_by_shape(dataset, workload):
    """The torch engine's job partition (64 samples a task) of
    ``dataset``: its plan and its tasks grouped by padded block shape."""
    from repro_torch.platform.driver import plan_job

    samples, months = dataset
    mean = float(np.mean([a.nbytes for a in samples.values()]))
    plan = plan_job(samples, months, workload, sizing="kneepoint",
                    engine="torch", n_exec=2, knee_bytes=64 * mean)
    by_shape = {}
    for task in plan.tasks:
        by_shape.setdefault(plan.task_shape(task), []).append(task)
    return plan, by_shape


def _real_blocks(dataset, workload, count):
    """``count`` task blocks of one padded shape, as the torch engine's job
    partition builds them: the first tasks of the shape most tasks have,
    or task 0 alone for ``count`` 1."""
    plan, by_shape = _tasks_by_shape(dataset, workload)
    if count == 1:
        return [plan.build_block(plan.tasks[0])]
    group = max(by_shape.values(), key=len)[:count]
    return [plan.build_block(task) for task in group]


def _netflix(n_movies: int):
    from repro_torch.data import NetflixSpec, netflix_dataset

    return netflix_dataset(NetflixSpec(n_movies=n_movies, mean_ratings=5654))


def _spec(samples, *, wave="on", backend="threaded", device="cuda",
          knee_count=64, **kw):
    from repro_torch.platform import PlatformSpec, WaveOptions

    mean_bytes = float(np.mean([a.nbytes for a in samples.values()]))
    return PlatformSpec(platform="BTS", n_workers=2, backend=backend,
                        waves=WaveOptions(wave=wave, max_wave=16),
                        knee_bytes=knee_count * mean_bytes, device=device,
                        **kw)


def _assert_bitwise(a, b, what):
    for key in a:
        if not np.array_equal(np.asarray(a[key]), np.asarray(b[key])):
            raise AssertionError(f"{what}: {key!r} differs")


def _check_result(rep, n_cols):
    res = rep.result
    for key in ("mean", "var"):
        arr = np.asarray(res[key])
        if arr.shape != (n_cols,) or not np.all(np.isfinite(arr)):
            raise AssertionError(f"{key}: shape {arr.shape}, finite "
                                 f"{bool(np.all(np.isfinite(arr)))}")
    if float(res["count"]) != rep.n_tasks * 8 * 64:
        raise AssertionError(f"count {res['count']} != {rep.n_tasks} x 512")


def _numpy_reference(samples, knee_count, n_cols, seed, prng):
    """Float64 moments over the same draws the port makes: blocks of
    ``knee_count`` consecutive movies, each row wrap-padded to ``n_cols``
    and the rows cycled to the job's block height; indices from the
    jax-compatible threefry on the CPU."""
    ids = sorted(samples)
    groups = [ids[i:i + knee_count] for i in range(0, len(ids), knee_count)]
    height = max(len(g) for g in groups)
    total = np.zeros(n_cols)
    total_sq = np.zeros(n_cols)
    for tid, g in enumerate(groups):
        rows = [np.resize(samples[m], n_cols) for m in g]
        rows = [rows[i % len(g)] for i in range(height)]
        block = np.stack(rows).astype(np.float64)
        idx = prng.randint(prng.PRNGKey(seed + tid), (8 * 64,), 0,
                           height).numpy()
        picked = block[idx]
        total += picked.sum(0)
        total_sq += (picked * picked).sum(0)
    n = len(groups) * 8 * 64
    mean = total / n
    return mean, np.maximum(total_sq / n - mean * mean, 0.0)


# subsample_grid vs its plain version: the same elements binned into the same
# cells, so the counts are equal; the sums are fp32 sums of the same terms
# (for alod, scores from a mean and a std also summed) in another order:
# relative 2e-5, with an absolute floor of 1e-5 of the largest sum for bins
# that nearly cancel.  The float64 host check holds the kernel to the same.
GRID_RTOL, GRID_ATOL_SCALE = 2e-5, 1e-5


def _grid_close(got, want, what):
    """Counts equal, sums within the stated tolerance; returns the sums'
    max_abs_err."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if not torch.equal(got[:, 1], want[:, 1]):
        raise AssertionError(f"{what}: counts differ")
    atol = GRID_ATOL_SCALE * float(want[:, 0].abs().max())
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=GRID_RTOL,
                               atol=atol, msg=what)
    return float((got[:, 0] - want[:, 0]).abs().max())



def _grid_bound(data, rows, idx, grid, statistic, multiplier):
    """Least time for one ``subsample_grid_seeded`` call, which draws
    ``idx`` itself: the slot and seed vectors read once, each distinct
    element this run's indices touch read once from the block (and from
    the months), the ``[B, 2, grid]`` output written once, over 3.35 TB/s;
    against the draws' 32-bit integer operations, about 75 a drawn
    element (one Threefry-2x32 hash: 20 rounds of add, rotate and xor,
    the key injections, the output words' xor and a mask) when the span's
    multiplier is 0 and about 150 (two hashes and three remainders) when
    it is not, over 16.7 T/s (derived, ``INT32_OPS_PER_S``); and against
    the fp32 operations an element needs (alod: the mean, the deviation,
    its square, the score's divide and absolute value, the cell's divide
    and multiply, the bin's add: 10; monthly_mean: the bin's add) over 67
    TFLOP/s.  The integer and fp32 units work side by side, so the bound
    is the largest of the three, named (``bound_ms``, ``bound_by``).

    The card cannot fetch less than a 32-byte sector from device memory,
    so ``sector_ms`` counts the distinct sectors the elements lie in
    (each plane's rows start on a sector: sl % 8 == 0 at the jobs'
    shapes) in place of the elements; ``in_force`` names the largest of
    the element bytes, the sector bytes and the operations."""
    _, ns, sl = data.shape
    b = idx.shape[0]
    key = ((rows.long()[:, None, None, None] * ns
            + torch.arange(ns, device=idx.device)[None, None, :, None]) * sl
           + idx.long())
    touched = int(torch.unique(key).numel())
    sectors = int(torch.unique(key // 8).numel())
    planes = 2 if statistic == "monthly_mean" else 1
    fixed = 2 * b * 4 + b * 2 * 4 * grid
    int_ops = THREEFRY_OPS * (1 if multiplier == 0 else 2) * idx.numel()
    flops = (10.0 if statistic == "alod" else 1.0) * idx.numel()
    t_bytes = (fixed + touched * 4 * planes) / HBM_BYTES_PER_S * 1e3
    t_sectors = (fixed + sectors * 32 * planes) / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
    in_force = max((t_bytes, "bytes"), (t_sectors, "sectors"),
                   (t_ops, "operations"))[1]
    return {"bound_ms": bound, "bound_by": by, "sector_ms": t_sectors,
            "in_force": in_force}


def _grid_f64(block, months, idx, grid, statistic):
    """One task's partial in numpy float64 from the kernel's indices: the
    cells in the reference's fp32 arithmetic (so they are the same cells),
    the scores and sums in float64."""
    draws, ns, ds = idx.shape
    sl = block.shape[1]
    rows = np.arange(ns)[None, :, None]
    x = block[rows, idx].astype(np.float64)               # [draws, ns, ds]
    if statistic == "alod":
        pos = idx.astype(np.float32) / np.float32(sl)
        cell = np.clip((pos * np.float32(grid)).astype(np.int32), 0,
                       grid - 1)
        mean = x.mean(axis=2, keepdims=True)
        value = np.abs((x - mean) / (x.std(axis=2, keepdims=True) + 1e-6))
    else:
        cell = np.clip(months[rows, idx], 0, grid - 1)
        value = x
    sums = np.zeros(grid)
    np.add.at(sums, cell.reshape(-1), value.reshape(-1))
    counts = np.bincount(cell.reshape(-1), minlength=grid).astype(np.float64)
    return np.stack([sums, counts])[None]


RANDINT_SEEDS = [-1, -2 ** 31, 2 ** 31 - 1] + list(range(16))


def check_randint(ops, prng, shapes):
    """Phase 3f, the draws alone: ``ops.randint`` (the kernel's threefry)
    ``torch.equal`` to ``prng.randint`` (jax's draws as int64 torch ops)
    on the card, at the workloads' ``(draws, ns, ds)`` shapes over their
    spans and at spans that are not powers of two (77, 1,000, 65,537: a
    multiplier of 0 and a remainder; 3), for seeds -1, -2^31, 2^31 - 1
    and 0-15."""
    seeds = torch.tensor(RANDINT_SEEDS, dtype=torch.int32, device="cuda")
    keys = prng.PRNGKey(seeds)
    cases = list(shapes) + [((8, 4, 300), span)
                            for span in (77, 1000, 65537, 3)]
    for shape, span in cases:
        got = ops.randint(seeds, shape, 0, span)
        want = prng.randint(keys, shape, 0, span)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"ops.randint != prng.randint at {shape} "
                                 f"span {span}: {bad} draws differ")
        _, mult = prng._randint_multiplier(0, span)
        print(f"randint check {shape} in [0, {span}) (multiplier {mult}), "
              f"{len(RANDINT_SEEDS)} seeds: the kernel's draws == "
              "prng.randint bit for bit")


def check_grid_kernel(ops, ref, prng, ss, sg, eaglet_block, netflix_blocks):
    """Phase 3f: ``subsample_grid`` on the card, its draw form (the
    platform's path, ``ops.subsample_grid_seeded``) against its read form
    fed ``prng.randint``'s indices and against its plain version.  The
    workloads' real blocks: EAGLET on one task block of the 400-family
    dataset (64 families, padded to 2,097,152 markers by its 15x
    outlier), NETFLIX_HIGH and NETFLIX_LOW on one 64-movie block of the
    catalogue, and NETFLIX_HIGH on its first 16,384 columns (the staged
    body's shape); then ns = 1, a draw size that is not a multiple of 32,
    grid 64, 120 and 512 for both statistics, months below 0 and past the
    grid (clipped), an ``alod`` row of 2,048 draws (drawn again in each
    pass), block lengths that are not powers of two (1,000 and 65,537 for
    the remainder, 77 and 3), and a row just inside and one just past the
    staged body's shared memory.  Each case, a wave of 16 (slots of an
    arena, seeds 0-15): the body ``kernels/subsample_grid.py::plan`` takes,
    the draws alone ``torch.equal`` to ``prng.randint``'s, the draw form
    ``torch.equal`` to the read form on those indices, each body forced on
    the same input ``torch.equal`` to the other where the row fits the
    staged one, counts equal and sums within tolerance of the plain
    version, two launches equal bit for bit, the first 3 tasks as a wave
    of 3 and each task as a wave of one equal to the wave of 16.  Then one
    task's partial against a float64 numpy recomputation from the same
    indices, and the times: the draw form at waves of 16 and 3
    (``grid_wave_times``: queued, on the device and on the host), the read
    form at 16, and one weighted ``torch.bincount`` plus a ``bincount``
    over the kernel's cells and values (a floor for the binning alone; it
    adds with atomics, in no fixed order)."""
    dev = torch.device("cuda")
    eb, em = (torch.from_numpy(a).to(dev)[None] for a in eaglet_block)
    nb = torch.from_numpy(np.stack([b for b, _ in netflix_blocks])).to(dev)
    nm = torch.from_numpy(np.stack([m for _, m in netflix_blocks])).to(dev)
    check_randint(ops, prng, [
        ((w.draws, data.shape[1], w.draw_size), data.shape[2])
        for w, data in ((ss.EAGLET, eb), (ss.NETFLIX_HIGH, nb),
                        (ss.NETFLIX_LOW, nb))])

    def cut(x, n):
        return x[..., :n].contiguous()

    wl = ss.SubsampleWorkload
    # a row just inside and one just past the staged body's shared memory
    edge = max(n for n in range(4, 65536, 4)
               if sg.stageable(n, 120, "monthly_mean"))
    gen = torch.Generator(device=dev).manual_seed(5)
    edge_months = torch.randint(-3, 124, (1, eb.shape[1], edge + 4),
                                device=dev, dtype=torch.int32, generator=gen)
    cases = [  # label, data, months, workload
        ("EAGLET", eb, em, ss.EAGLET),
        ("NETFLIX_HIGH", nb, nm, ss.NETFLIX_HIGH),
        ("NETFLIX_LOW", nb, nm, ss.NETFLIX_LOW),
        ("NETFLIX_HIGH on [64, 16384]", cut(nb, 16384), cut(nm, 16384),
         ss.NETFLIX_HIGH),
        (f"monthly sl={edge}, the staged body's longest row", cut(eb, edge),
         cut(edge_months, edge), wl("m", "monthly_mean", 8, 8192, 120)),
        (f"monthly sl={edge + 4}, just past it", cut(eb, edge + 4),
         edge_months, wl("m", "monthly_mean", 8, 8192, 120)),
        ("monthly grid=512", nb, nm, wl("m", "monthly_mean", 8, 300, 512)),
        ("alod grid=512", cut(nb, 4096), cut(nm, 4096),
         wl("a", "alod", 8, 300, 512)),
        ("alod ns=1", eb[:, :1].contiguous(), em[:, :1].contiguous(),
         ss.EAGLET),
        ("monthly ns=1", nb[:, :1].contiguous(), nm[:, :1].contiguous(),
         ss.NETFLIX_HIGH),
        ("alod ds=77 grid=120", eb, em, wl("a", "alod", 7, 77, 120)),
        ("monthly ds=77 grid=64, months shifted by -10",
         nb, (nm - 10).contiguous(), wl("m", "monthly_mean", 7, 77, 64)),
        ("alod grid=64 on the netflix block", nb, nm,
         wl("a", "alod", 8, 256, 64)),
        ("alod ds=2048, each index drawn again", nb, nm,
         wl("a", "alod", 8, 2048, 64)),
        ("monthly sl=1000", cut(nb, 1000), cut(nm, 1000), ss.NETFLIX_HIGH),
        ("alod sl=65537", cut(eb, 65537), cut(em, 65537), ss.EAGLET),
        ("alod sl=77 ds=40", cut(eb, 77), cut(em, 77),
         wl("a", "alod", 5, 40, 64)),
        ("monthly sl=3", cut(nb, 3), cut(nm, 3), ss.NETFLIX_LOW),
    ]
    worst, timed = 0.0, {}
    for label, data, months, w in cases:
        n_slots = data.shape[0]
        rows = torch.arange(16, dtype=torch.int32, device=dev) % n_slots
        seeds = torch.arange(16, dtype=torch.int32, device=dev)
        shape = (w.draws, data.shape[1], w.draw_size)
        idx = prng.randint(prng.PRNGKey(seeds), shape, 0, data.shape[2])
        if not torch.equal(ops.randint(seeds, shape, 0, data.shape[2]), idx):
            raise AssertionError(f"{label}: the kernel's draws != "
                                 "prng.randint")
        kw = dict(grid=w.grid, statistic=w.statistic)
        skw = dict(draws=w.draws, draw_size=w.draw_size, **kw)
        plan = sg.plan_for(data, months, w.draws, w.draw_size, w.grid,
                           w.statistic)
        got = ops.subsample_grid_seeded(data, months, rows, seeds, **skw)
        read = ops.subsample_grid(data, months, rows, idx, **kw)
        want = ref.subsample_grid_seeded_ref(data, months, rows, seeds, **skw)
        torch.cuda.synchronize()
        if not torch.equal(got, read):
            raise AssertionError(f"{label}: the draw form != the read form "
                                 "on prng.randint's indices")
        bodies = ["direct", "staged"] if sg.stageable(
            data.shape[2], w.grid, w.statistic) else ["direct"]
        for body in bodies:
            if not torch.equal(got, sg.subsample_grid_seeded(
                    data, months, rows, seeds, body=body, **skw)):
                raise AssertionError(f"{label}: the {body} body forced != "
                                     f"the {plan.body} body")
        err = _grid_close(got, want, label)
        if not torch.equal(got, ops.subsample_grid_seeded(
                data, months, rows, seeds, **skw)):
            raise AssertionError(f"{label}: two launches differ")
        if not torch.equal(got[:3], ops.subsample_grid_seeded(
                data, months, rows[:3], seeds[:3], **skw)):
            raise AssertionError(f"{label}: the first 3 tasks of a wave of "
                                 "16 != the same tasks as a wave of 3")
        for b in range(16):
            one = ops.subsample_grid_seeded(data, months, rows[b:b + 1],
                                            seeds[b:b + 1], **skw)
            if not torch.equal(one[0], got[b]):
                raise AssertionError(f"{label}: task {b} of a wave of 16 "
                                     "!= the task as a wave of one")
        worst = max(worst, err)
        print(f"grid kernel check {label}: data {tuple(data.shape)}, "
              f"{w.statistic} draws {w.draws} x {w.draw_size}, grid "
              f"{w.grid}, wave of 16; the launcher took the {plan.body} "
              f"body (CTAs a sample {plan.groups}, bin copies a warp "
              f"{plan.copies}): draws == prng.randint; draw form == read "
              f"form bit for bit; {' == '.join(bodies)} forced bit for bit; "
              f"counts "
              f"equal, sums max_abs_err {err!r} (rtol {GRID_RTOL}, atol "
              f"{GRID_ATOL_SCALE} x max |sum|); two launches equal; waves "
              "of 16, 3 and 1 equal")
        if label in ("EAGLET", "NETFLIX_HIGH", "NETFLIX_LOW"):
            host = _grid_f64(data[0].cpu().numpy(), months[0].cpu().numpy(),
                             idx[0].cpu().numpy(), w.grid, w.statistic)
            err64 = _grid_close(got[:1].double().cpu(),
                                torch.from_numpy(host), f"{label} float64")
            print(f"  {label}: task 0 against float64 numpy from the same "
                  f"indices, max_abs_err {err64!r}")
            timed[label] = (data, months, rows, seeds, idx, skw)
    rows_ms = {}
    for label, (data, months, rows, seeds, idx, skw) in timed.items():
        _, mult = prng._randint_multiplier(0, data.shape[2])
        for width in (16, 3):
            r, sd, ix = rows[:width], seeds[:width], idx[:width]
            ms, dev_ms, host_us = grid_wave_times(ops, data, months, r, sd,
                                                  skw)
            bound = _grid_bound(data, r, ix, skw["grid"], skw["statistic"],
                                mult)
            rows_ms[label, width] = (ms, bound)
            print(f"subsample_grid (draw form) {label} wave of {width} on "
                  f"{tuple(data.shape)}, draws {tuple(ix.shape)}: kernel "
                  f"{ms!r} ms (calls queued back to back), device "
                  f"{dev_ms!r} ms (behind a spin), host {host_us!r} µs a "
                  f"call; bound {bound['bound_ms']!r} ms "
                  f"({bound['bound_by']}), share of the bound "
                  f"{bound['bound_ms'] / ms!r}; sector bound "
                  f"{bound['sector_ms']!r} ms; in force: "
                  f"{bound['in_force']}")
        kw = dict(grid=skw["grid"], statistic=skw["statistic"])
        read_ms = _time_ms(lambda: ops.subsample_grid(data, months, rows, idx,
                                                      **kw))
        print(f"subsample_grid (read form, the oracle) {label} wave of 16: "
              f"kernel {read_ms!r} ms")
    data, months, rows, seeds, idx, skw = timed["NETFLIX_HIGH"]
    plain_ms = _time_ms(lambda: ref.subsample_grid_seeded_ref(
        data, months, rows, seeds, **skw), reps=3)
    # the kernel's cells and values as one flat list, each task's cells
    # offset by b * grid: a floor for the binning alone
    grid = skw["grid"]
    flat = ((rows.long()[:, None, None, None] * data.shape[1]
             + torch.arange(data.shape[1], device=dev)[None, None, :, None])
            * data.shape[2] + idx.long()).reshape(-1)
    cells = (months.reshape(-1)[flat].clamp(0, grid - 1).long()
             + torch.arange(16, device=dev).repeat_interleave(
                 flat.numel() // 16) * grid)
    values = data.reshape(-1)[flat]

    def bincounts():
        torch.bincount(cells, weights=values, minlength=16 * grid)
        torch.bincount(cells, minlength=16 * grid)

    bincount_ms = _device_ms(bincounts)
    ms, bound = rows_ms["NETFLIX_HIGH", 16]
    print(f"subsample_grid (draw form) at NETFLIX_HIGH's wave of 16: kernel "
          f"{ms!r} ms, plain (prng.randint, then the binned sums) "
          f"{plain_ms!r} ms; a weighted torch.bincount plus a bincount over "
          f"the same {values.numel()} cells and values {bincount_ms!r} ms "
          "(a floor for the binning alone, with atomics in no fixed order); "
          "no single PyTorch call computes these binned sums in a fixed "
          "order, so library_ms is null")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "sector_bound_ms": bound["sector_ms"],
            "bincount_floor_ms": bincount_ms}


# the jobs' own launch shapes (steps 4c and 4b): workload, padded block
# shape, wave widths.  Steps 4c's waves hold 1-10 tasks (mean 2.6); per
# task is a wave of one.
GRID_SPLIT_SHAPES = [("NETFLIX_HIGH", (64, 16384), (1, 3)),
                     ("NETFLIX_HIGH", (64, 32768), (1, 3)),
                     ("NETFLIX_LOW", (64, 32768), (1, 3)),
                     ("EAGLET", (64, 524288), (1,)),
                     ("EAGLET", (64, 2097152), (1,))]


def _device_ms(fn, reps: int = 10, cold=False) -> float:
    """Device ms a call of ``fn``, by CUDA events around each call, after
    one warm-up call.  A spin kernel (``torch.cuda._sleep``) holds the
    stream while the host queues the calls, so the events time the
    device's work and not the host's launch overhead (about 30-50 µs a
    call, more than a small launch's device time).  ``cold``: 64 MB
    written before each call (outside its events) evict the 50 MB L2
    cache, so the block is cold as a job's next wave finds it."""
    flush = torch.empty(1 << 24, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(20_000_000)
    for start, end in pairs:
        if cold:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def grid_wave_times(ops, data, months, rows, seeds, skw, reps=20):
    """One wave's ``ops.subsample_grid_seeded`` call three ways: ms a call
    with the calls queued back to back (``_time_ms``; where the host's
    launch cost exceeds the device's work, that cost is what it reads),
    device ms a call behind a spin (``_device_ms``), and the host's µs a
    call, the least of 5 rounds of ``reps`` calls (the host's cores are
    shared), each timed while a spin holds the stream so that the host
    never waits on the device.  Returns (queued ms, device ms, host µs)."""
    def call():
        ops.subsample_grid_seeded(data, months, rows, seeds, **skw)

    queued = _time_ms(call, reps)
    device = _device_ms(call)
    rounds = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        rounds.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return queued, device, min(rounds)


def grid_split(ops, prng, ss, sg, netflix, eaglet):
    """``subsample_grid_seeded`` at the launch shapes of steps 4c and 4b,
    on real task blocks of the catalogue and of EAGLET at the thesis'
    scale (the first tasks of each shape; seeds 0, 1, ...): device ms a
    launch (``_device_ms``), warm (the same blocks again) and cold, beside
    the bounds; where the row fits the staged body (``sg.stageable``),
    also each body forced, warm.  Returns {label: (warm ms, cold ms)}
    and, for those shapes, {label + " staged / direct": (staged ms,
    direct ms)}."""
    datasets = {"NETFLIX_HIGH": netflix, "NETFLIX_LOW": netflix,
                "EAGLET": eaglet}
    out = {}
    for name, shape, widths in GRID_SPLIT_SHAPES:
        w = getattr(ss, name)
        plan, by_shape = _tasks_by_shape(datasets[name], w)
        blocks = [plan.build_block(t) for t in by_shape[shape][:max(widths)]]
        data = torch.from_numpy(np.stack([b for b, _ in blocks])).cuda()
        months = torch.from_numpy(np.stack([m for _, m in blocks])).cuda()
        del blocks
        _, mult = prng._randint_multiplier(0, shape[1])
        for width in widths:
            rows = (torch.arange(width, dtype=torch.int32, device="cuda")
                    % data.shape[0])
            seeds = torch.arange(width, dtype=torch.int32, device="cuda")
            kw = dict(draws=w.draws, draw_size=w.draw_size, grid=w.grid,
                      statistic=w.statistic)

            def call():
                ops.subsample_grid_seeded(data, months, rows, seeds, **kw)

            warm, cold = _device_ms(call), _device_ms(call, cold=True)
            idx = prng.randint(prng.PRNGKey(seeds),
                               (w.draws, shape[0], w.draw_size), 0, shape[1])
            bound = _grid_bound(data, rows, idx, w.grid, w.statistic, mult)
            label = f"{name} {list(shape)} B={width}"
            out[label] = (warm, cold)
            print(f"grid_split {label}: kernel warm {warm!r} ms, cold "
                  f"{cold!r} ms; bound {bound['bound_ms']!r} ms "
                  f"({bound['bound_by']}), sector bound "
                  f"{bound['sector_ms']!r} ms, in force: "
                  f"{bound['in_force']}")
            if sg.stageable(shape[1], w.grid, w.statistic):
                forced = tuple(_device_ms(
                    lambda body=body: sg.subsample_grid_seeded(
                        data, months, rows, seeds, body=body, **kw))
                    for body in ("staged", "direct"))
                out[f"{label} staged / direct"] = forced
                taken = sg.plan_for(data, months, w.draws, w.draw_size,
                                    w.grid, w.statistic).body
                print(f"grid_split {label}, each body forced, warm: "
                      f"staged {forced[0]!r} ms, direct {forced[1]!r} ms "
                      f"(the launcher takes the {taken} body)")
        del data, months
        torch.cuda.empty_cache()
    return out


def _plan_shapes(samples, months, workload, knee_bytes, engine="torch"):
    """The distinct padded block shapes of the job's task partition (the
    warm-up launches one wave, or one task, per shape) with the number of
    tasks of each."""
    from repro_torch.platform.driver import plan_job

    plan = plan_job(samples, months, workload, sizing="kneepoint",
                    engine=engine, n_exec=2, knee_bytes=knee_bytes)
    shapes = {}
    for task in plan.tasks:
        shape = plan.task_shape(task)
        shapes[shape] = shapes.get(shape, 0) + 1
    return dict(sorted(shapes.items()))


def grid_job(ops, Platform, label, samples, months, workload, *, wave,
             backend="threaded", knee_count=64, platform_kw=None,
             spec_kw=None):
    """One job of the paper's workloads through ``Platform.run`` on the
    card, under ``torch.profiler``, the launch counts zeroed just before
    and read just after.  Prints its makespan, compile phase, waves,
    launches (which must be waves or tasks plus one warm-up per block
    shape), arena bytes and the device's busy share of the execute
    window; checks the result.  ``platform_kw`` (a datastore, a fault
    injector) go to ``Platform``, ``spec_kw`` to its spec.  Returns the
    report and the launches."""
    from torch.profiler import ProfilerActivity, profile

    spec = _spec(samples, wave=wave, backend=backend, knee_count=knee_count,
                 **(spec_kw or {}))
    shapes = _plan_shapes(samples, months, workload, spec.knee_bytes)
    warm_ups, ns = len(shapes), next(iter(shapes))[0]
    torch.cuda.synchronize()
    ops.reset_launch_count()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rep = Platform(spec, **(platform_kw or {})).run(samples, months,
                                                       workload)
        torch.cuda.synchronize()
    launches = ops.launch_count("subsample_grid")
    waved = bool(rep.wave_sizes)
    dispatched = len(rep.wave_sizes) if waved else rep.n_tasks
    window_ms, busy_ms, by_kind = _execute_window(
        prof, "subsample_grid", ("grid_partial_kernel", "sum_samples_kernel"))
    kernel_ms = sum(e.time_range.end - e.time_range.start
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and ("grid_partial_kernel" in e.name
                         or "sum_samples_kernel" in e.name)) / 1e3
    print(f"{label}: {workload.name} ({workload.statistic}), wave="
          f"{wave!r}, {backend}: {rep.n_tasks} tasks, makespan "
          f"{rep.makespan!r} s (under the profiler), compile "
          f"{rep.phases.get('compile')!r} s, block shapes (tasks) "
          f"{json.dumps([[list(k), v] for k, v in shapes.items()])}, "
          f"{len(rep.wave_sizes)} waves "
          f"{list(rep.wave_sizes)}, subsample_grid launches {launches} "
          f"({dispatched} {'waves' if waved else 'tasks'} + {warm_ups} "
          f"warm-ups), arena/uploaded {rep.bytes_uploaded!r} bytes; execute "
          f"window {window_ms!r} ms, device busy {busy_ms!r} ms (share "
          f"{busy_ms / window_ms!r}), device ms outside the kernel "
          f"{by_kind['memcpy'] + by_kind['other']!r}, device ms by kind "
          f"{json.dumps(by_kind)}; subsample_grid device ms over the whole "
          f"trace {kernel_ms!r}, {kernel_ms / max(launches, 1)!r} a launch")
    if backend == "threaded" and launches != dispatched + warm_ups:
        raise AssertionError(f"{label}: {launches} launches != "
                             f"{dispatched} + {warm_ups} warm-ups")
    if launches < 1:
        raise AssertionError(f"{label}: no subsample_grid launch")
    res = rep.result
    if workload.statistic == "alod":
        curve = np.asarray(res["alod"])
        if curve.shape != (workload.grid,) or not np.all(np.isfinite(curve)):
            raise AssertionError(f"{label}: alod curve {curve.shape}")
        if float(res["n"]) != rep.n_tasks * ns * workload.draws:
            raise AssertionError(f"{label}: n {res['n']}")
    else:
        mean = np.asarray(res["monthly_mean"])
        count = np.asarray(res["count"])
        seen = count > 0
        if (mean.shape != (workload.grid,) or not np.all(np.isfinite(mean))
                or not seen.any()
                or not np.all((mean[seen] >= 1) & (mean[seen] <= 5))):
            raise AssertionError(f"{label}: monthly means out of [1, 5]")
        if float(count.sum()) != (rep.n_tasks * ns * workload.draws
                                  * workload.draw_size):
            raise AssertionError(f"{label}: count {count.sum()}")
    return rep, launches


def paper_workload_jobs(ops, Platform, ss, samples, months, eaglet):
    """Steps 4c and 4b: the Netflix catalogue as NETFLIX_LOW (wave
    "auto", which waves) and NETFLIX_HIGH (wave on and off, bitwise
    equal); EAGLET at the thesis' 400 families x 131,072 markers (wave on
    and off, bitwise equal).  Returns the launches of the five jobs and
    the waved NETFLIX_HIGH and EAGLET reports."""
    t0 = time.perf_counter()
    launches = 0
    _, n = grid_job(ops, Platform, "step 4c", samples, months,
                    ss.NETFLIX_LOW, wave="auto")
    launches += n
    on, n = grid_job(ops, Platform, "step 4c", samples, months,
                     ss.NETFLIX_HIGH, wave="on")
    launches += n
    off, n = grid_job(ops, Platform, "step 4c", samples, months,
                      ss.NETFLIX_HIGH, wave="off")
    launches += n
    _assert_bitwise(on.result, off.result, "NETFLIX_HIGH wave vs per-task")
    waved = {"NETFLIX_HIGH": on}
    print(f"step 4c: NETFLIX_HIGH wave == per-task bitwise "
          f"({time.perf_counter() - t0!r} s for step 4c)")
    t0 = time.perf_counter()
    e_samples, e_months = eaglet
    on, n = grid_job(ops, Platform, "step 4b", e_samples, e_months,
                     ss.EAGLET, wave="on")
    launches += n
    off, n = grid_job(ops, Platform, "step 4b", e_samples, e_months,
                      ss.EAGLET, wave="off")
    launches += n
    _assert_bitwise(on.result, off.result, "EAGLET wave vs per-task")
    waved["EAGLET"] = on
    print(f"step 4b: EAGLET wave == per-task bitwise "
          f"({time.perf_counter() - t0!r} s for step 4b)")
    return launches, waved


def paper_workload_invariants(ops, Platform, ss):
    """Threaded ≡ simulated bitwise for EAGLET (48 families at 2,048
    markers, 8 a task) and NETFLIX_LOW (the 512-movie catalogue)."""
    from repro_torch.data import EagletSpec, eaglet_dataset

    eag = eaglet_dataset(EagletSpec(n_families=48, mean_markers=2048))
    for label, (smp, mo), wl, knee in (
            ("EAGLET 48 families", eag, ss.EAGLET, 8),
            ("NETFLIX_LOW 512 movies", _netflix(512), ss.NETFLIX_LOW, 64)):
        thr, _ = grid_job(ops, Platform, label, smp, mo, wl, wave="on",
                          knee_count=knee)
        sim = Platform(_spec(smp, wave="off", backend="simulated",
                             knee_count=knee)).run(smp, mo, wl)
        _assert_bitwise(thr.result, sim.result, f"{label}: threaded vs "
                        "simulated")
        print(f"{label}: threaded (waves) == simulated bitwise over "
              f"{thr.n_tasks} tasks")


# phase 10 — the platform's data plane, faults and checkpoint/resume

# the job store's block cache: room for the whole catalogue (the cache
# holds the store's own arrays, no copy)
CACHE_BYTES = 1 << 30
# bench_balance.py's degraded data plane (benchmarks/bench_balance.py:60-85):
# 10 ms a fetch, the first of three nodes 5x slower, each sample on two
BALANCE_LAT, BALANCE_DEGRADE = 10e-3, 5.0
# 10d: a save every 32 leaves (a moments leaf is 512 KB at the catalogue's
# 65,536 columns: at most 278 x 512 KB a save, 8 saves, 0.6 GB in all),
# the crash at the 4th
CKPT_EVERY, CKPT_CRASH_AT = 32, 4


def _job_store():
    """The jobs' data plane: three nodes holding every sample, the
    adaptive replication controller deciding once in 10,000 fetches (as
    bench_balance.py sets it; by default once in 64, which shrinks an
    idle plane to one node within a task) so that the three stay in
    service for the faults to strike."""
    from repro_torch.core.datastore import (ReplicatedDataStore,
                                            ReplicationPolicy)

    return ReplicatedDataStore(
        n_initial=3, policy=ReplicationPolicy(window=10_000, max_replicas=3))


def _degraded_store(select):
    """bench_balance.py's store: three nodes, the first 5x slower, each
    sample placed on two (``put_all(..., replication=2)``)."""
    from repro_torch.core.datastore import (ReplicatedDataStore,
                                            ReplicationPolicy)

    store = ReplicatedDataStore(
        n_initial=3, select=select, latency=lambda nbytes: BALANCE_LAT,
        policy=ReplicationPolicy(fetch_slo=BALANCE_LAT, window=10_000,
                                 max_replicas=3))
    store.nodes[0].latency = lambda nbytes: BALANCE_LAT * BALANCE_DEGRADE
    return store


def _store_kw(**extra):
    """Spec keywords of a job with a datastore: balanced claims, prefetch
    and the block cache."""
    from repro_torch.core.blockcache import CacheOptions
    from repro_torch.platform import ScheduleOptions

    return dict(schedule=ScheduleOptions(balanced="on", prefetch="on"),
                cache=CacheOptions(capacity_bytes=CACHE_BYTES), **extra)


def moments_job(ops, prng, Platform, label, samples, months, spec, warm_ups,
                platform_kw=None, resume_from=None):
    """The ``moments`` job through ``Platform.run``, the launch counts
    zeroed just before and read just after and ``prng.randint`` counted.
    Fails unless ``subsample_stats`` launched once a wave plus one warm-up
    a block shape and nothing drew indices outside the kernel.  Returns
    the report and its run() wall seconds."""
    from repro_torch.platform import MOMENTS

    host_draws = []
    randint = prng.randint

    def counted_randint(*args, **kwargs):
        host_draws.append(1)
        return randint(*args, **kwargs)

    prng.randint = counted_randint
    try:
        torch.cuda.synchronize()
        ops.reset_launch_count()
        t0 = time.perf_counter()
        rep = Platform(spec, **(platform_kw or {})).run(
            samples, months, MOMENTS, resume_from=resume_from)
        wall = time.perf_counter() - t0
        launches = ops.launch_count("subsample_stats")
        drawn = ops.launch_count("threefry_randint")
    finally:
        prng.randint = randint
    print(f"{label}: {rep.n_tasks} tasks, makespan {rep.makespan!r} s, "
          f"run() wall {wall!r} s, phases {rep.phases}, "
          f"{len(rep.wave_sizes)} waves ({sum(rep.wave_sizes)} tasks), "
          f"subsample_stats launches {launches} (+ {warm_ups} warm-ups), "
          f"threefry_randint launches {drawn}, prng.randint calls "
          f"{len(host_draws)}")
    if launches != len(rep.wave_sizes) + warm_ups or not rep.wave_sizes:
        raise AssertionError(f"{label}: {launches} subsample_stats launches "
                             f"for {len(rep.wave_sizes)} waves and "
                             f"{warm_ups} warm-ups")
    if drawn or host_draws:
        raise AssertionError(f"{label}: indices drawn outside the kernel")
    return rep, wall


def _plane_stats(rep):
    return (f"datastore_stats {json.dumps(rep.datastore_stats)}, "
            f"prefetch_stats {json.dumps(rep.prefetch_stats)}, "
            f"cache_stats {json.dumps(rep.cache_stats)}")


def _fault_plan(n_tasks):
    """The first seeded plan (from seed 0 up) whose worker crash falls at
    the worker's first claim, which each worker makes; its node kill,
    revival and latency spike fall within the job's completions.  So
    every planned event can fire."""
    from repro_torch.platform.faults import FaultPlan

    for seed in range(10_000):
        plan = FaultPlan.from_seed(seed, n_workers=2, n_nodes=3,
                                   n_tasks=n_tasks, revive_after=8)
        crash = [e for e in plan.events if e.kind == "worker_crash"]
        if crash[0].at_claims == 1 and all(
                e.at_completions <= n_tasks for e in plan.events):
            return seed, plan
    raise AssertionError("no seed below 10,000 gives such a plan")


def data_plane_and_recovery(ops, prng, Platform, ss, samples, months, eaglet,
                            step4, waved):
    """Phase 10: the jobs of steps 4, 4c and 4b again with the platform's
    data plane and recovery, each bit for bit against its run without
    them, with the launch counts zeroed just before and read just after
    each.  10a ``moments`` with a ``ReplicatedDataStore`` (3 nodes,
    balanced claims, prefetch, block cache); 10b NETFLIX_HIGH and EAGLET
    with the same; 10c NETFLIX_HIGH under a seeded ``FaultPlan`` (a worker
    crash, a node killed and revived, a latency spike) with leases; 10d
    ``moments`` checkpointed, crashed at a save and resumed; 10e
    bench_balance's degraded data plane at 512 movies, balanced off and
    on, both makespans printed."""
    import shutil
    import tempfile

    from repro_torch.platform import MOMENTS, FaultOptions, ScheduleOptions
    from repro_torch.platform.faults import (FaultEvent, FaultInjector,
                                             FaultPlan, InjectedCrash)

    card = _card_line()
    # 10a — moments with a datastore
    store = _job_store()
    rep, _ = moments_job(ops, prng, Platform, "10a moments + datastore",
                         samples, months, _spec(samples, **_store_kw()),
                         step4["warm_ups"], platform_kw={"datastore": store})
    _assert_bitwise(step4["result"], rep.result, "10a: moments with a store")
    print(f"10a: bit for bit equal to step 4; makespan {rep.makespan!r} s "
          f"against step 4's {step4['makespan']!r} s ({card}); "
          f"{_plane_stats(rep)}; fetches by node "
          f"{json.dumps(store.fetch_counts())}")
    # where the store's time goes: the fetches alone (FIFO claims, inline
    # fetches, no cache), then with balanced claims; and one task's
    # fetch_many of its 64 samples alone on the host
    layers = {"full": rep.makespan}
    for arm, sched in (("fetch_only", dict(balanced="off", prefetch="off")),
                       ("fetch_balanced", dict(balanced="on",
                                               prefetch="off"))):
        rep, _ = moments_job(ops, prng, Platform, f"10a {arm}", samples,
                             months, _spec(samples, schedule=ScheduleOptions(
                                 **sched)), step4["warm_ups"],
                             platform_kw={"datastore": _job_store()})
        _assert_bitwise(step4["result"], rep.result, f"10a: {arm}")
        layers[arm] = rep.makespan
    store = _job_store()
    store.put_all(samples)
    ids = sorted(samples)
    one_task_ms = _host_ms(lambda: store.fetch_many(ids[:64]), reps=50)
    store.close()
    print(f"10a layers: makespan without a store {step4['makespan']!r} s, "
          f"fetches alone {layers['fetch_only']!r} s, + balanced claims "
          f"{layers['fetch_balanced']!r} s, + prefetch and cache "
          f"{layers['full']!r} s; one task's fetch_many of 64 samples "
          f"alone on the host {one_task_ms!r} ms ({card})")

    # 10b — the paper's workloads with a datastore
    for name, (smp, mo) in (("NETFLIX_HIGH", (samples, months)),
                            ("EAGLET", eaglet)):
        wl = getattr(ss, name)
        store = _job_store()
        rep, _ = grid_job(ops, Platform, f"10b {name} + datastore", smp, mo,
                          wl, wave="on", platform_kw={"datastore": store},
                          spec_kw=_store_kw())
        _assert_bitwise(waved[name].result, rep.result,
                        f"10b: {name} with a store")
        print(f"10b {name}: bit for bit equal to its run without the store; "
              f"makespan {rep.makespan!r} s against "
              f"{waved[name].makespan!r} s, both under the profiler "
              f"({card}); {_plane_stats(rep)}")

    # 10c — faults: a crash, a node killed and revived, a latency spike
    seed, plan = _fault_plan(waved["NETFLIX_HIGH"].n_tasks)
    inj = FaultInjector(plan)
    rep, _ = grid_job(ops, Platform, "10c NETFLIX_HIGH + faults", samples,
                      months, ss.NETFLIX_HIGH, wave="on",
                      platform_kw={"datastore": _job_store(),
                                   "fault_injector": inj},
                      spec_kw=_store_kw(faults=FaultOptions(
                          lease_seconds=1.0)))
    _assert_bitwise(waved["NETFLIX_HIGH"].result, rep.result,
                    "10c: NETFLIX_HIGH under faults")
    events = [(e.kind, e.target, e.at_claims or e.at_completions)
              for e in plan.events]
    print(f"10c: seed {seed}, plan {json.dumps(events)}; fired "
          f"{rep.fault_events}, restarts {rep.restarts}; bit for bit equal "
          f"to the fault-free run; makespan {rep.makespan!r} s ({card})")
    if rep.restarts < 1 or rep.fault_events != len(plan.events):
        raise AssertionError(f"10c: {rep.restarts} restarts, "
                             f"{rep.fault_events} of {len(plan.events)} "
                             "planned events fired")

    # 10d — checkpoint, crash, resume
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="ckpt_", dir=root)
    try:
        full = os.path.join(ckpt_root, "full")
        rep, wall = moments_job(
            ops, prng, Platform, "10d moments checkpointed", samples, months,
            _spec(samples, faults=FaultOptions(checkpoint_dir=full,
                                               checkpoint_every=CKPT_EVERY)),
            step4["warm_ups"])
        _assert_bitwise(step4["result"], rep.result,
                        "10d: checkpointed moments")
        print(f"10d: {rep.checkpoint_saves} saves every {CKPT_EVERY} "
              f"leaves, {rep.checkpoint_bytes} array bytes written and "
              f"fsynced; makespan {rep.makespan!r} s against step 4's "
              f"{step4['makespan']!r} s without checkpointing ({card})")
        crashed = os.path.join(ckpt_root, "crashed")
        inj = FaultInjector(FaultPlan((FaultEvent(
            "checkpoint_crash", at_saves=CKPT_CRASH_AT),)))
        try:
            Platform(_spec(samples, faults=FaultOptions(
                checkpoint_dir=crashed, checkpoint_every=CKPT_EVERY)),
                fault_injector=inj).run(samples, months, MOMENTS)
        except InjectedCrash as err:
            print(f"10d: the run raised InjectedCrash ({err})")
        else:
            raise AssertionError("10d: the checkpoint crash did not fire")
        rep, wall = moments_job(ops, prng, Platform, "10d resumed", samples,
                                months, _spec(samples), step4["warm_ups"],
                                resume_from=crashed)
        _assert_bitwise(step4["result"], rep.result, "10d: resumed moments")
        missing = rep.n_tasks - rep.tasks_restored
        print(f"10d: resumed with {rep.tasks_restored} of {rep.n_tasks} "
              f"tasks restored, {sum(rep.wave_sizes)} run; bit for bit "
              f"equal to step 4; makespan {rep.makespan!r} s ({card})")
        if rep.tasks_restored <= 0 or sum(rep.wave_sizes) != missing:
            raise AssertionError(f"10d: {rep.tasks_restored} restored, "
                                 f"{sum(rep.wave_sizes)} run of {missing} "
                                 "missing")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)

    # 10e — a degraded data plane, balanced off and on
    small, small_months = _netflix(512)
    out = {}
    for arm, select, sched in (
            ("off", "static", dict(balanced="off", speculation="off",
                                   prefetch="off")),
            ("on", "response_time", dict(balanced="on", speculation="auto",
                                         prefetch="on"))):
        store = _degraded_store(select)
        store.put_all(small, replication=2)
        rep, _ = moments_job(
            ops, prng, Platform, f"10e balanced={arm}", small, small_months,
            _spec(small, schedule=ScheduleOptions(**sched)),
            len(_plan_shapes(small, small_months, MOMENTS,
                             _spec(small).knee_bytes, engine="kernel")),
            platform_kw={"datastore": store})
        counts = store.fetch_counts()
        out[arm] = rep
        print(f"10e balanced={arm}: makespan {rep.makespan!r} s, fetches "
              f"by node {json.dumps(counts)} (node 0 {BALANCE_DEGRADE}x "
              f"slower), speculative launches {rep.speculative_launches}, "
              f"prefetch {json.dumps(rep.prefetch_stats)} ({card})")
    _assert_bitwise(out["off"].result, out["on"].result,
                    "10e: balanced off vs on")
    print(f"10e: makespan balanced off {out['off'].makespan!r} s, on "
          f"{out['on'].makespan!r} s, ratio "
          f"{out['off'].makespan / out['on'].makespan!r}; bit for bit equal")


def main() -> None:
    _require_card()
    print(_card_line())
    kind = torch.cuda.get_device_name(0)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch import prng
    from repro_torch.core import subsample as ss
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import (flash_attention, rglru_scan, rwkv6_scan,
                                     subsample_gather, subsample_grid)
    from repro_torch.platform import MOMENTS, Platform
    from repro_torch.platform import compute as pc

    libraries = (subsample_gather.LIBRARY, subsample_gather.GATHER_LIBRARY,
                 rwkv6_scan.LIBRARY, rglru_scan.LIBRARY,
                 flash_attention.LIBRARY, subsample_grid.LIBRARY)

    # phase 2 — build, one nvcc for each source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.load) for lib in libraries]:
            fut.result()
    print(f"kernel libraries ready in {time.perf_counter() - t0!r} s")
    for lib in libraries:
        info = lib.info
        print(f"  {lib.source.name}: nvcc {info['seconds']!r} s, "
              f"{info['path']}")
        for line in info["log"].splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print("    ptxas:", line.strip())

    # phase 3 — each kernel against its plain version
    timing = check_kernel(ops, ref, prng, subsample_gather)
    rw_timing = check_rwkv6_kernel(ops, ref, rwkv6_scan)
    rg_timing = check_rglru_kernel(ops, ref)
    fa_timing = check_flash_kernel(ops, ref)
    sg_timing = check_gather_kernel(ops, ref)

    # phase 4 — the main path at real size
    t0 = time.perf_counter()
    samples, months = _netflix(17770)
    n_ratings = sum(a.shape[0] for a in samples.values())
    longest = max(a.shape[0] for a in samples.values())
    print(f"netflix: 17770 movies, {n_ratings} ratings, longest "
          f"{longest}, {n_ratings * 4} rating bytes, made in "
          f"{time.perf_counter() - t0!r} s")
    spec = _spec(samples)
    warm_ups = len(_plan_shapes(samples, months, MOMENTS, spec.knee_bytes,
                                engine="kernel"))
    draws_on_host = []
    randint = prng.randint

    def counted_randint(*args, **kwargs):
        draws_on_host.append(1)
        return randint(*args, **kwargs)

    prng.randint = counted_randint
    try:
        ops.reset_launch_count()
        t0 = time.perf_counter()
        wave = Platform(spec).run(samples, months, MOMENTS)
        wall = time.perf_counter() - t0
        launches = ops.launch_count()
        drawn = ops.launch_count("threefry_randint")
    finally:
        prng.randint = randint
    n_cols = int(np.asarray(wave.result["mean"]).shape[0])
    print(f"main path: {wave.n_tasks} tasks, makespan {wave.makespan!r} s, "
          f"run() wall {wall!r} s, phases {wave.phases}, "
          f"device_dispatches {wave.device_dispatches}, wave_sizes "
          f"{wave.wave_sizes}, arena {wave.bytes_uploaded!r} bytes, "
          f"subsample_stats launches {launches} ({len(wave.wave_sizes)} "
          f"waves + {warm_ups} warm-ups), threefry_randint launches {drawn}, "
          f"prng.randint calls {len(draws_on_host)}, D {n_cols}")
    if launches != len(wave.wave_sizes) + warm_ups or not wave.wave_sizes:
        raise AssertionError(f"the main path launched subsample_stats "
                             f"{launches} times for {len(wave.wave_sizes)} "
                             f"waves and {warm_ups} warm-ups")
    if drawn or draws_on_host:
        raise AssertionError("the main path drew indices outside the "
                             "kernel")
    _check_result(wave, n_cols)
    ids = sorted(samples)
    wave_anatomy(ops, prng, wave.n_tasks, 64, n_cols,
                 lambda: pc.build_block(samples, months, ids, range(64), 64,
                                        longest))
    traced_wave_run(Platform, spec, samples, months, MOMENTS)
    block, _ = pc.build_block(samples, months, ids, range(64), 64, longest)
    if block.shape != (64, n_cols):
        raise AssertionError(f"task block {block.shape} != (64, {n_cols})")
    sg_launches = netflix_block_gather(ops, prng, block)
    del block

    # phase 5 — invariants on the card
    t0 = time.perf_counter()
    per = Platform(_spec(samples, wave="off")).run(samples, months, MOMENTS)
    _assert_bitwise(wave.result, per.result, "wave vs per-task")
    print(f"per-task run: {per.n_tasks} tasks, makespan {per.makespan!r} s, "
          f"phases {per.phases}, device_dispatches {per.device_dispatches}; "
          f"bit-identical to the wave run ({time.perf_counter() - t0!r} s)")
    step4 = {"result": wave.result, "makespan": wave.makespan,
             "warm_ups": warm_ups, "n_cols": n_cols}
    del wave, per

    # phase 3f — subsample_grid on real blocks of the paper's datasets;
    # steps 4c and 4b — the paper's workloads through Platform.run
    t0 = time.perf_counter()
    eaglet = _eaglet_thesis_scale()
    e_block = _real_blocks(eaglet, ss.EAGLET, 1)[0]
    n_blocks = _real_blocks((samples, months), ss.NETFLIX_HIGH, 4)
    grid_timing = check_grid_kernel(ops, ref, prng, ss, subsample_grid,
                                    e_block, n_blocks)
    del e_block, n_blocks
    torch.cuda.empty_cache()
    print(f"phase 3f: {time.perf_counter() - t0!r} s with the EAGLET "
          "dataset's generation")
    grid_timing["job_shapes_ms"] = grid_split(
        ops, prng, ss, subsample_grid, (samples, months), eaglet)
    grid_launches, waved = paper_workload_jobs(ops, Platform, ss, samples,
                                               months, eaglet)

    # phase 10 — the data plane, faults and checkpoint/resume, on the same
    # catalogue and EAGLET dataset
    t0 = time.perf_counter()
    data_plane_and_recovery(ops, prng, Platform, ss, samples, months, eaglet,
                            step4, waved)
    print(f"phase 10: {time.perf_counter() - t0!r} s")
    del samples, months, eaglet, waved
    torch.cuda.empty_cache()

    small, small_months = _netflix(512)
    thr = Platform(_spec(small)).run(small, small_months, MOMENTS)
    sim = Platform(_spec(small, wave="off", backend="simulated")).run(
        small, small_months, MOMENTS)
    _assert_bitwise(thr.result, sim.result, "threaded vs simulated")
    cols = int(np.asarray(thr.result["mean"]).shape[0])
    _check_result(thr, cols)
    mean, var = _numpy_reference(
        small, int(round(thr.task_size_bytes / np.mean(
            [a.nbytes for a in small.values()]))), cols, 0, prng)
    np.testing.assert_allclose(thr.result["mean"], mean, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(thr.result["var"], var, rtol=RTOL, atol=ATOL)
    print(f"512 movies: threaded == simulated bitwise over {thr.n_tasks} "
          "tasks; mean/var match a float64 numpy reference "
          f"(rtol={RTOL}, atol={ATOL})")

    del small, small_months, thr, sim
    t0 = time.perf_counter()
    paper_workload_invariants(ops, Platform, ss)
    print(f"paper workloads' threaded == simulated: "
          f"{time.perf_counter() - t0!r} s")
    torch.cuda.empty_cache()

    # phase 6 — serving rwkv6-7b at full width; phase 7 — the invariant
    rw_launches = serve_full_width(ops)
    decode_invariant()

    # phase 8 — serving recurrentgemma-2b at full width; phase 9 — its
    # decode ≡ prefill invariant
    rg_launches = serve_recurrentgemma(ops)
    rg_decode_invariant()

    print(json.dumps({"kernels": [{
        "name": "subsample_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/subsample_stats.cu",
        "replaces": "src/repro/kernels/subsample_gather.py:138",
        "launches": launches, "library_ms": None, **timing}, {
        "name": "rwkv6_chunked", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:69",
        "launches": rw_launches, "library_ms": None, **rw_timing}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:47",
        "launches": rg_launches["rglru_scan"], "library_ms": None,
        "main_path_form": "gated (ops.rglru_gated_scan)", **rg_timing}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": rg_launches["flash_attention"], **fa_timing}, {
        "name": "subsample_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/subsample_gather.cu",
        "replaces": "src/repro/kernels/subsample_gather.py:64",
        "launches": sg_launches, "library_ms": None, **sg_timing}, {
        "name": "subsample_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/subsample_grid.cu",
        "replaces": "src/repro/core/subsample.py:53",
        "launches": grid_launches, "library_ms": None, **grid_timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
