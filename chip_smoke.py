"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and nvcc
(sm_90a).  It imports neither JAX nor the reference package ``repro``.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the seven CUDA kernel sources from ``src/repro_torch``
   (``subsample_stats``, ``subsample_gather``, ``rwkv6_chunked``,
   ``rglru_scan``, ``flash_attention``, ``subsample_grid`` and
   ``flash_attention_bwd``), one nvcc each, started together, and prints
   ptxas' registers, shared memory and spills; any spill in
   ``flash_attention_bwd``'s tensor-core kernels fails.
3. Holds each kernel against its plain PyTorch version on the card, at
   the shapes its main path gives it and at shapes that take its other
   branches, and times kernel, plain version, the bound and, where one
   PyTorch call computes the same function, that call (``index_select``
   beside ``subsample_gather`` is a floor for its gather alone);
   ``flash_attention`` also gives its TFLOP/s and share of its bound at
   two serving shapes (a ``recurrentgemma-2b`` local layer at HD 256 and
   a ``deepseek-7b`` layer at HD 128, causal, window 0, where
   ``scaled_dot_product_attention(is_causal=True)`` is the same function
   in one call), is held at ``internlm2-20b``'s group of 6, and a second
   launch at each serving shape must equal the first; the same
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
   Phase 3g holds ``flash_attention_bwd`` (the backward training takes
   through ``flash_attention``) against its plain version, fed the
   forward's own output and log-sum-exp (held first against the plain
   log-sum-exp), at ``musicgen-medium``'s microbatch shape (q ``[48, 2048,
   64]`` bf16, causal), at ``deepseek-7b``'s (q ``[128, 4064, 128]``, the
   plain version on 16 heads), at group 6, ragged lengths, fp32 and HD 32
   and 256, then at the tensor-core body's edges (group 8, Sq < Skv, Sq =
   1, Skv < 64, views off 16 bytes), each case naming the body its type
   and HD take (``flash_attention_bwd.BODY``); at both model shapes a
   second launch equals the first bit for bit, and the kernel is timed
   beside its bound, its plain version and the backward of
   ``scaled_dot_product_attention(is_causal=True)``, split by kernel (D,
   dK/dV, dQ) under the profiler, and the forward with and without its
   log-sum-exp.
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
13. After phase 9: serves ``deepseek-7b`` at full width (30 layers of
   full attention, d_model 4096, 32 heads of 128 on 32 KV heads, d_ff
   11008, vocab 102,400, the reference's int8 KV cache, bf16 weights from a
   seed) through ``ServingEngine.generate``: batch 4, a 4,064-token prompt,
   32 new tokens, so the cache ends at the model's 4,096-token context;
   prefill must launch ``flash_attention`` 30 times and nothing else of
   ``ops``.  Prints the cache's bytes against a bf16 cache's and checks
   every layer's int8 values and fp32 scales; one ``torch.profiler`` pass
   over a prefill and one over a decode step.  Then, fast:
   ``internlm2-20b`` at full width cut to 4 layers (a prefill of batch 4 at
   4,096 tokens, 4 flash_attention launches with group 6, and 4 decode
   steps); ``deepseek-7b``'s decode ≡ prefill at full width, 4 layers,
   fp32, the cache unquantized (within 1e-3); and the reference's int8
   bound at full width, 4 layers: the int8 cache's decode logits within a
   relative max of 0.15 of a bf16 cache's.
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
11. After phase 10, on the same datasets: the multi-tenant service
   (``PlatformService``, step 4's spec), each step's launches counted and
   no index drawn on the host.  11a registers both datasets; the first
   ``moments`` query (seed 0) builds its query class (arena and warm-ups)
   and equals step 4 bit for bit; 11b repeats it three times, bit for
   bit, uploading only slot and seed vectors (8 bytes a task) and
   launching no warm-up;
   11c runs four ``moments`` jobs, NETFLIX_HIGH and EAGLET at once under
   ``torch.profiler``, each equal to its seed alone on the same service
   (and the paper workloads to steps 4c and 4b), launches equal to the
   service's dispatches, and prints the fused dispatches, wave sizes,
   latencies, queue waits and the device's busy share; 11d stops a
   ``moments`` job early (epsilon 0.5) and cancels another mid-run beside
   a peer that stays equal to step 4; 11e closes the service and checks
   that the card's allocated memory is back within 64 MB.
12. After phase 11, on the same datasets: sharded waves
   (``mesh_devices``), each step's launches counted from 0 and no index
   drawn on the host.  12a step 4's spec at ``mesh_devices=1`` ≡ step 4
   bit for bit, one launch a wave (plus the warm-ups), its waves and its
   set-up and makespan beside step 4's and beside the unsharded job's
   rerun just after it (two workers cut a job's tail into waves by
   timing, so the counts may differ by a wave); 12b NETFLIX_HIGH
   (waved) and EAGLET at ``mesh_devices=1`` ≡ steps 4c and 4b; 12c below
   the driver, a ``ShardedBlockArena`` over a mesh of four streams of the
   one card holding step 4's plan and the catalogue's NETFLIX_HIGH plan:
   its physical layout checked on the card, every wave of the plan
   through ``run_map_wave_sharded`` ≡ ``run_map_wave`` bit for bit with
   one launch an occupied entry, then the waves again under
   ``torch.profiler`` (host ms, device ms and whether the streams'
   kernels overlapped, a wave); 12d the service at ``mesh_devices=1`` ≡
   11a; 12e ``mesh_devices=2`` raises ``ValueError`` on a machine with
   one card (with two or more, 12a runs at mesh 2); 12f the elastic
   pool's simulated session (``launch.elastic.demo_elastic_run``), its
   reports printed.  The kernel table gives each platform kernel's
   ``sharded_launches`` over 12a–12d.
14. After phase 13: training.  14a trains ``musicgen-medium`` whole (48
   layers, d_model 1536, bf16 parameters from a seed, fp32 moments and
   accumulation, remat full) through ``train()`` for 5 steps of batch 8 ×
   2,048 tokens from the subsampling pipeline (4 microbatches), the
   launch counts zeroed just before and read just after: 384
   ``flash_attention`` (the forward twice under remat) and 192
   ``flash_attention_bwd`` a step; prints step times, tokens/s, peak
   memory, one step's device time by kind under ``torch.profiler``, and
   checks that every parameter leaf has a finite non-zero gradient and
   changes within two steps.  14b one ``make_train_step`` on the card and
   on the CPU (plain versions) from the same fp32 state, full width at 2
   layers: the loss within 1e-4, gradients and parameters within their
   stated bounds.  14c ``deepseek-7b`` at full width cut to 4 layers, one
   step at batch 1 × 4,064 (the HD-128 backward at its real shape), every
   layer's wq, wk and wv with a gradient.  14d 4 steps straight against 2
   + a checkpoint + a resumed ``train()`` + 2, the losses equal bit for
   bit.  14e (run after 14a) one bf16 microbatch of ``musicgen-medium`` at
   full width cut to 2 layers, 2 × 2,048 tokens: its gradients with the
   backward kernel against those with attention's backward computed by
   ``ref.flash_attention_bwd_ref`` on the card, each leaf within 1e-2 of
   its largest entry, the losses equal.
15. After phase 14: the mixture-of-experts models and the patch
   frontend.  15a serves ``deepseek-moe-16b`` whole (28 layers, bf16
   weights from a seed, einsum dispatch) through ``ServingEngine.generate``
   at batch 4, a 3,072-token prompt (three segments of 1,024 positions, T
   = 4,096, capacity 480) and 32 new tokens: 28 ``flash_attention``
   launches and nothing else of ``ops``, prefill s, decode ms a step,
   peak memory, the share of (token, choice) pairs dropped, and one
   profiled prefill's device ms by kind (expert products, dispatch and
   combine, routing, attention, the rest).  15b one prefill at 4 × 4,064
   (unsegmented: capacity 1,912) and its peak memory.  15c one MoE layer
   at full width in fp32 (TF32 off), T = 4,096, both dispatch modes, the
   card against the CPU: expert indices equal where the k-th/(k+1)-th
   margin exceeds 1e-5, outputs within 1e-4 of the largest, two launches
   equal bit for bit; in bf16, tied router columns go to the lower index.
   15d ``arctic-480b`` at full width, one layer: a prefill at 1 × 2,048.
   15e ``flash_attention`` at group 7 (q ``[224, 1600, 128]``) against
   its plain version, then ``llava-next-34b`` at full width cut to 8
   layers: batch 4, 576 patches + 1,024 tokens, 32 new tokens, decode
   from position 1,600.  15f ``deepseek-moe-16b`` cut to 4 layers: two
   ``train()`` steps at batch 1 × 4,096 (four segments), launches of both
   attention kernels, the loss ``ce + 0.01 · aux`` with aux above 0,
   every leaf's gradient non-zero; and at 2 layers in fp32 the card
   against the CPU (loss and gradients within 1e-4, except experts a
   printed routing flip touches).  15g decode ≡ prefill within 1e-3 at 4
   layers, fp32, with a capacity factor that drops nothing.

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


def _busy_us(dev):
    """The union of the device operations' spans, ``dev`` sorted ``(start,
    end, name)`` in µs: the time the device was busy."""
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, _ in dev:
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return busy + cur_end - cur_start


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
    busy = _busy_us(dev)
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


def _sdpa_causal_ms(q, k, v, group=1):
    """The same function in one library call where there is no window:
    ``scaled_dot_product_attention(q, k, v, is_causal=True)`` with no mask
    tensor, so the library may take its flash backend; with a group, k and
    v are expanded to every query head before the clock starts."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if group > 1:
        k, v = (t.repeat_interleave(group, dim=0) for t in (k, v))
    qs, ks, vs = (t[None] for t in (q, k, v))
    return _time_ms(lambda: sdpa(qs, ks, vs, is_causal=True), reps=10)


# the dense decoders' prefill attention (phase 13): deepseek-7b at batch 4
# and a 4,064-token prompt (32 heads of 128 on 32), and internlm2-20b's
# group of 6 at 4,096 tokens (48 query heads on 8, batch 4); bh, sq, skv,
# hd, causal, window, group
DENSE_FA = (4 * 32, 4064, 4064, 128, True, 0, 1)
GQA6_FA = (4 * 48, 4096, 4096, 128, True, 0, 6)


def check_flash_kernel(ops, ref):
    """Phase 3d: ``flash_attention`` against its plain version on the card:
    at the local serving shape (one local layer's prefill of batch 4 at
    4,096 tokens: 40 query heads of 256 on 4 KV heads, window 2,048,
    bf16), at the dense serving shape (a ``deepseek-7b`` layer's prefill
    of batch 4 at 4,064 tokens: q, k, v ``[128, 4064, 128]``, causal,
    window 0, group 1, the ragged last tile of 64 rows) and at
    ``internlm2-20b``'s group of 6 (q ``[192, 4096, 128]``, k, v ``[32,
    4096, 128]``), at window 0 and group 1 causal and not (the TPU
    kernel's function), at HD 32 with a ragged Sq = Skv = 1,000, and in
    fp32 at HD 256; then bf16 (the tensor-core body) at HD 32 with Sq <
    Skv, at HD 64 with a window below one tile and Sq > Skv, at Sq = 1
    against 1,000 keys, and with q and k scaled by 8 (large score gaps for
    the online rescale).  At both serving shapes a second launch must
    equal the first bit for bit, and each is timed beside its plain
    version, its bound and ``scaled_dot_product_attention``: with a
    boolean mask, and at the dense shape also with ``is_causal=True``,
    the same function in one call."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    local = (40, 4096, 4096, 256, True, 2048, 10)
    cases = [  # bh, sq, skv, hd, causal, window, group, dtype, q and k scale
        local + (torch.bfloat16, 1),
        DENSE_FA + (torch.bfloat16, 1),
        GQA6_FA + (torch.bfloat16, 1),
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
    kept = {}
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
        del want
        shape = (bh, sq, skv, hd, causal, window, group)
        if shape in (local, DENSE_FA):
            kept[shape] = (q, k, v, out)
    torch.cuda.empty_cache()
    timings = {}
    for shape, (q, k, v, first) in kept.items():
        bh, sq, skv, hd, causal, window, group = shape
        again = ops.flash_attention(q, k, v, causal=causal, window=window,
                                    group=group)
        if not torch.equal(first, again):
            raise AssertionError(f"two flash_attention launches on the "
                                 f"inputs of {shape} differ")
        ms = _time_ms(lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window, group=group), reps=10)
        plain_ms = _time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, window=window, group=group), reps=3)
        torch.cuda.empty_cache()
        (bound_ms, bound_by), pairs = _flash_bound(q, k, causal, window,
                                                   group)
        mask_ms = _sdpa_ms(q, k, v, causal, window, group)
        causal_ms = (_sdpa_causal_ms(q, k, v)
                     if shape == DENSE_FA else None)
        tflops = 4.0 * hd * pairs / ms / 1e9
        print(f"flash_attention at q [{bh}, {sq}, {hd}] bf16, k, v "
              f"[{bh // group}, {skv}, {hd}], window {window}, group "
              f"{group} ({pairs} query-key pairs): kernel {ms!r} ms "
              f"({tflops!r} TFLOP/s, {bound_ms / ms!r} of its bound; a "
              f"second launch equal bit for bit), plain {plain_ms!r} ms, "
              f"bound {bound_ms!r} ms ({bound_by}), "
              f"scaled_dot_product_attention with a boolean mask "
              f"{mask_ms!r} ms"
              + ("" if causal_ms is None else
                 f", with is_causal=True {causal_ms!r} ms (kernel / "
                 f"library {ms / causal_ms!r})"))
        timings[shape] = {"ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": (mask_ms if causal_ms is None
                                         else causal_ms)}
        if causal_ms is not None:
            timings[shape]["library_mask_ms"] = mask_ms
    del kept
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, **timings[DENSE_FA],
            "local_hd256": timings[local]}


# flash_attention_bwd vs its plain version: both take the same bf16 (or
# fp32) inputs, the kernel's own out and lse, and sum in fp32; the sums run
# in other orders (over 2,048-4,064 rows or keys), so the fp32 gradients
# agree to ~1e-5 of their scale, and each bf16 gradient is one rounding of
# them: the two may part by one bf16 step (2^-8 relative, under 1e-2) plus
# the fp32 difference near zero
FA_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}
# the backward's main path: one musicgen-medium layer of a microbatch of 2
# sequences of 2,048 tokens (24 heads of 64); and deepseek-7b's layer shape
MUSICGEN_FA = (2 * 24, 2048, 2048, 64, True, 0, 1)
# heads of the deepseek-7b shape the plain version is held on (all 128 would
# take some 45 GB of fp32 score matrices)
DENSE_BWD_PLAIN_HEADS = 16


def _flash_bwd_bound(q, k, causal, group):
    """Least time for one backward: q, k, v, out, dout and lse read once,
    dq, dk and dv written once, over 3.35 TB/s, against five products of
    2·HD operations for every (query, key) pair the mask leaves (S, dP,
    dV, dK, dQ; the forward does two) over the tensor-core rate of the
    inputs' type."""
    from repro_torch.kernels import ref

    bh, sq, hd = q.shape
    skv = k.shape[1]
    esize = q.element_size()
    nbytes = ((4 * bh * sq * hd + 4 * (bh // group) * skv * hd) * esize
              + 4 * bh * sq)
    pairs = int(ref.attention_mask(sq, skv, causal=causal, window=0,
                                   device=q.device).sum()) * bh
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else TF32_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10.0 * hd * pairs / rate * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")), pairs


def _sdpa_bwd_ms(q, k, v, dout):
    """The library yardstick: the backward alone of autograd through
    ``scaled_dot_product_attention(is_causal=True)`` on the same tensors
    (group 1)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t[None].detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qs, ks, vs, is_causal=True)
    grad = dout[None]
    return _time_ms(lambda: torch.autograd.grad(
        out, (qs, ks, vs), grad, retain_graph=True), reps=10)


def _off_16_bytes(t):
    """A contiguous copy of ``t`` that starts one element past 16 bytes,
    a view into a larger buffer."""
    shifted = torch.empty(t.numel() + 1, dtype=t.dtype,
                          device=t.device)[1:].view(t.shape)
    shifted.copy_(t)
    return shifted


def _flash_bwd_split(fn, reps: int = 3):
    """Device ms a call of ``fn`` by the backward's three kernels (D,
    dK/dV, dQ), summed by ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {"D": 0.0, "dK/dV": 0.0, "dQ": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = ("dK/dV" if "flash_bwd_dkdv" in e.name else
                "dQ" if "flash_bwd_dq" in e.name else
                "D" if ("flash_bwd_rows" in e.name
                        or "flash_bwd_delta" in e.name) else None)
        if part is not None:
            split[part] += (e.time_range.end - e.time_range.start) / 1e3
    if not all(split.values()):
        raise AssertionError(f"the profiler missed a backward kernel: {split}")
    return {k: v / reps for k, v in split.items()}


def check_tensor_core_bwd_spills(log: str) -> None:
    """Phase 2: the registers and spills ptxas reports for each of
    ``flash_attention_bwd.cu``'s tensor-core kernels (``flash_bwd_*`` with
    ``wgmma`` or ``rows`` in its name); any spill fails."""
    import re

    entry, seen = None, {}
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        if entry is None or not ("wgmma" in entry or "rows" in entry):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            seen.setdefault(entry, {})["spill"] = (int(m.group(1)),
                                                   int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            seen.setdefault(entry, {})["registers"] = int(m.group(1))
    if len(seen) != 9:  # three kernels at HD 32, 64 and 128
        raise AssertionError(f"ptxas reported {len(seen)} tensor-core "
                             "backward kernels, not 9")
    for name, got in sorted(seen.items()):
        short = re.sub(r"^.*?(flash_bwd_\w+?_kernel)ILi(\d+)E.*$",
                       r"\1<\2>", name)
        print(f"  flash_attention_bwd tensor-core kernel {short}: "
              f"{got['registers']} registers at launch, spill stores and "
              f"loads {got['spill']} bytes")
        if got["spill"] != (0, 0):
            raise AssertionError(f"{short} spills {got['spill']} bytes")


def check_flash_bwd_kernel(ops, ref):
    """Phase 3g: ``flash_attention_bwd`` against its plain version
    (``ref.flash_attention_bwd_ref``) on the card, fed the kernel's own
    forward output and log-sum-exp, which are held first against the plain
    forward and ``ref.flash_attention_lse_ref``: at ``musicgen-medium``'s
    microbatch shape (q ``[48, 2048, 64]`` bf16, causal, the main path of
    phase 14), at ``deepseek-7b``'s (q ``[128, 4064, 128]`` bf16, causal;
    the plain version on 16 of its heads), at ``internlm2-20b``'s group of
    6, at ragged Sq and Skv, non-causal, fp32, and at HD 32 and 256; then
    the tensor-core body's edges (bf16 at HD 64 and 128): group 8, Sq <
    Skv not causal, Sq and Skv off 64 and 128, Sq = 1, Skv < 64, and q and
    dout views off 16 bytes.  Each line names the body its (type, HD)
    takes.  At both main shapes a second launch must equal the first bit
    for bit, and the kernel is timed beside its bound, its plain version
    and the backward alone of autograd through
    ``scaled_dot_product_attention(is_causal=True)``, split by kernel (D,
    dK/dV, dQ) under the profiler; the forward with and without its
    log-sum-exp is timed beside them."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    gen = torch.Generator(device="cuda").manual_seed(27)
    dense = DENSE_FA
    cases = [  # bh, sq, skv, hd, causal, window, group, dtype, views off 16
        MUSICGEN_FA + (torch.bfloat16, False),
        dense + (torch.bfloat16, False),
        (4 * 48, 1000, 1000, 128, True, 0, 6, torch.bfloat16, False),
        (12, 577, 577, 128, True, 0, 6, torch.float32, False),
        (8, 1000, 1000, 64, True, 0, 1, torch.float32, False),
        (6, 300, 500, 32, False, 0, 2, torch.float32, False),
        (8, 500, 300, 32, True, 0, 2, torch.bfloat16, False),
        (4, 129, 129, 256, True, 0, 2, torch.bfloat16, False),
        (4, 200, 77, 256, False, 0, 1, torch.float32, False),
        # the tensor-core body's edges
        (16, 577, 577, 128, True, 0, 8, torch.bfloat16, False),
        (12, 200, 257, 128, False, 0, 6, torch.bfloat16, False),
        (8, 333, 333, 64, True, 0, 2, torch.bfloat16, False),
        (6, 1, 1000, 64, False, 0, 1, torch.bfloat16, False),
        (4, 300, 40, 128, False, 0, 2, torch.bfloat16, False),
        (4, 100, 40, 64, True, 0, 1, torch.bfloat16, False),
        (6, 700, 700, 64, True, 0, 3, torch.bfloat16, True),
    ]
    worst = {"lse": 0.0, "grad": 0.0}
    timings = {}
    for bh, sq, skv, hd, causal, window, group, dtype, off in cases:
        shape = (bh, sq, skv, hd, causal, window, group)
        body = fab.BODY[(dtype, hd)]
        q = torch.randn((bh, sq, hd), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((bh // group, skv, hd), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        dout = torch.randn((bh, sq, hd), generator=gen,
                           device="cuda").to(dtype)
        if off:
            q, dout = _off_16_bytes(q), _off_16_bytes(dout)
        out, lse = fa.flash_attention(q, k, v, causal=causal, window=0,
                                      group=group, with_lse=True)
        plain_heads = (DENSE_BWD_PLAIN_HEADS if shape == dense else bh)
        hs, kvs = slice(0, plain_heads), slice(0, plain_heads // group)
        lse_want = ref.flash_attention_lse_ref(q[hs], k[kvs], causal=causal,
                                               group=group)
        torch.testing.assert_close(lse[hs], lse_want, rtol=1e-5, atol=1e-5)
        worst["lse"] = max(worst["lse"],
                           float((lse[hs] - lse_want).abs().max()))
        del lse_want
        ops.reset_launch_count()
        grads = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                        causal=causal, group=group)
        torch.cuda.synchronize()
        if ops.launch_count("flash_attention_bwd") != 1:
            raise AssertionError("flash_attention_bwd did not count its "
                                 "launch")
        want = ref.flash_attention_bwd_ref(
            q[hs], k[kvs], v[kvs], out[hs], lse[hs], dout[hs],
            causal=causal, group=group)
        rtol, atol = FA_BWD_TOL[dtype]
        errs = []
        for name, got, w in zip(("dq", "dk", "dv"), grads, want):
            got = got[hs] if name == "dq" else got[kvs]
            torch.testing.assert_close(got, w, rtol=rtol, atol=atol,
                                       msg=lambda m: f"{name} at {shape}: {m}")
            errs.append(float((got.float() - w.float()).abs().max()))
        worst["grad"] = max(worst["grad"], *errs)
        del want
        print(f"flash_attention_bwd check BH={bh} Sq={sq} Skv={skv} HD={hd} "
              f"causal={causal} group={group} {str(dtype).split('.')[-1]}"
              f"{' (q and dout off 16 bytes)' if off else ''}, body {body}"
              f"{'' if plain_heads == bh else f' (plain on {plain_heads} heads)'}"
              f": max_abs_err dq {errs[0]!r}, dk {errs[1]!r}, dv {errs[2]!r} "
              f"(rtol {rtol}, atol {atol}); lse against the plain lse "
              f"within 1e-5")
        if shape in (MUSICGEN_FA, dense):
            again = ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                            causal=causal, group=group)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"two flash_attention_bwd launches on "
                                     f"the inputs of {shape} differ")
            del again
            torch.cuda.empty_cache()
            ms = _time_ms(lambda: ops.flash_attention_bwd(
                q, k, v, out, lse, dout, causal=causal, group=group),
                reps=5)
            split = _flash_bwd_split(lambda: ops.flash_attention_bwd(
                q, k, v, out, lse, dout, causal=causal, group=group))
            plain_ms = _time_ms(lambda: ref.flash_attention_bwd_ref(
                q[hs], k[kvs], v[kvs], out[hs], lse[hs], dout[hs],
                causal=causal, group=group), reps=2)
            torch.cuda.empty_cache()
            fwd_ms = _time_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=0, group=group), reps=10)
            fwd_lse_ms = _time_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=0, group=group,
                with_lse=True), reps=10)
            library_ms = _sdpa_bwd_ms(q, k, v, dout)
            torch.cuda.empty_cache()
            (bound_ms, bound_by), pairs = _flash_bwd_bound(q, k, causal,
                                                           group)
            tflops = 10.0 * hd * pairs / ms / 1e9
            print(f"flash_attention_bwd at q [{bh}, {sq}, {hd}] bf16, causal "
                  f"({pairs} query-key pairs), body {body}: kernel {ms!r} ms "
                  f"({tflops!r} TFLOP/s, {bound_ms / ms!r} of its bound; a "
                  f"second launch equal bit for bit; by kernel under the "
                  f"profiler {json.dumps(split)} ms), plain {plain_ms!r} ms"
                  f"{'' if plain_heads == bh else f' on {plain_heads} of {bh} heads'}"
                  f", bound {bound_ms!r} ms ({bound_by}), the backward of "
                  f"scaled_dot_product_attention(is_causal=True) "
                  f"{library_ms!r} ms (kernel / library {ms / library_ms!r});"
                  f" the forward {fwd_ms!r} ms, with its lse {fwd_lse_ms!r} "
                  "ms")
            timings[shape] = {"ms": ms, "plain_ms": plain_ms,
                              "plain_heads": plain_heads, "body": body,
                              "split_ms": split,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": library_ms,
                              "forward_ms": fwd_ms,
                              "forward_lse_ms": fwd_lse_ms}
        del q, k, v, dout, out, lse, grads
        torch.cuda.empty_cache()
    return {"max_abs_err": worst["grad"], "lse_max_abs_err": worst["lse"],
            **timings[MUSICGEN_FA], "deepseek_7b": timings[dense]}


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


# phase 13 — the dense decoders
DENSE_PROMPT = 4064      # + 32 new tokens: deepseek-7b's 4,096 context
# int8 cache against a bf16 cache, the reference's own bound
# (tests/test_serving_consistency.py): relative max of the decode logits
INT8_REL_BOUND = 0.15


def _cache_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def serve_dense(ops):
    """Phase 13: ``deepseek-7b`` at full width (30 layers of full
    attention, d_model 4096, 32 heads of 128 on 32, d_ff 11008, vocab
    102,400, int8 KV cache), bf16 weights from a seed, through
    ``ServingEngine.generate`` at batch 4, a 4,064-token prompt and 32 new
    tokens; returns the launch counts of the measured run."""
    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine, grow_caches

    cfg = get_config("deepseek-7b")
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"deepseek-7b: {cfg.num_layers} layers of full attention, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim} on "
          f"{cfg.num_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, KV cache {cfg.kv_cache_dtype}: {n_params} bf16 "
          f"parameters ({cfg.param_count()} by the config's count) drawn on "
          f"the card in {time.perf_counter() - t0!r} s")
    engine = ServingEngine(model, params, max_new_tokens=32)
    batch = model.make_inputs(ShapeConfig("serve", "prefill", DENSE_PROMPT,
                                          4), model.generator(1))
    warm = engine.generate(batch, new_tokens=2)
    print(f"warm-up generate (2 new tokens): prefill "
          f"{warm.prefill_seconds!r} s, decode {warm.decode_seconds!r} s")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    out = engine.generate(batch, new_tokens=32)
    launches = {name: ops.launch_count(name) for name in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    print(f"serving deepseek-7b, batch 4, prompt {DENSE_PROMPT}, 32 new "
          f"tokens, int8 KV cache: prefill_seconds {out.prefill_seconds!r}, "
          f"decode_seconds {out.decode_seconds!r}, tokens_per_second "
          f"{out.tokens_per_second!r}, peak device memory {peak} bytes; "
          f"launches {json.dumps(launches)}")
    others = {n: c for n, c in launches.items()
              if n != "flash_attention" and c}
    if launches["flash_attention"] != cfg.num_layers or others:
        raise AssertionError(f"prefill launched flash_attention "
                             f"{launches['flash_attention']} times, not "
                             f"{cfg.num_layers}, and {others}")
    if out.tokens.shape != (4, 32) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"generated tokens: shape {out.tokens.shape}")
    with torch.inference_mode():
        logits, caches = _profiled(
            "deepseek-7b prefill", lambda: model.prefill(params, batch),
            ("flash_attention",), ran=("flash_attention",))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits are not finite")
        caches = model.prefill_to_decode(
            grow_caches(caches, DENSE_PROMPT + 32))
        _check_int8_caches(cfg, caches, DENSE_PROMPT + 32)
        int8_bytes = _cache_bytes(caches)
        values = sum(t.numel() for t in _leaves(caches)
                     if t.dtype == torch.int8)
        print(f"deepseek-7b decode caches at {DENSE_PROMPT + 32} positions: "
              f"{int8_bytes} bytes (int8 values and fp32 scales) against "
              f"{values * 2} bytes for a bf16 cache "
              f"({int8_bytes / (values * 2)!r})")
        tok = torch.argmax(logits, dim=-1)[:, None]
        logits, _ = _profiled(
            "deepseek-7b decode step", lambda: model.decode_step(
                params, tok, caches, DENSE_PROMPT), ("flash_attention",),
            absent=("flash_attention",))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("decode logits are not finite")
    del caches, engine, params
    torch.cuda.empty_cache()
    return launches


def _check_int8_caches(cfg, caches, seq):
    """Every layer's decode cache: int8 ``k``, ``v`` ``[4, seq, KV, HD]``
    and fp32 ``k_scale``, ``v_scale`` ``[4, seq, KV, 1]``."""
    want = {"k": (torch.int8, (4, seq, cfg.num_kv_heads, cfg.head_dim)),
            "v": (torch.int8, (4, seq, cfg.num_kv_heads, cfg.head_dim)),
            "k_scale": (torch.float32, (4, seq, cfg.num_kv_heads, 1)),
            "v_scale": (torch.float32, (4, seq, cfg.num_kv_heads, 1))}
    layers = [layer for block in caches["blocks_flat"] for layer in block]
    layers += caches["prefix"] + caches["tail"]
    if len(layers) != cfg.num_layers:
        raise AssertionError(f"{len(layers)} layer caches, not "
                             f"{cfg.num_layers}")
    for i, layer in enumerate(layers):
        got = {n: (t.dtype, tuple(t.shape)) for n, t in layer.items()}
        if got != want:
            raise AssertionError(f"layer {i}'s cache is {got}, not {want}")


def dense_fast_steps(ops):
    """Phase 13's fast steps: (a) ``internlm2-20b`` at full width, depth
    cut to 4 layers, bf16, a prefill of batch 4 at 4,096 tokens and 4
    decode steps, each prefill layer one ``flash_attention`` launch with
    group 6; (b) ``deepseek-7b``'s decode ≡ prefill invariant at full
    width, depth 4, fp32 weights, the cache unquantized; (c) the
    reference's int8 bound at full width, depth 4: the int8 cache's first
    decode logits within a relative max of 0.15 of a bf16 cache's on the
    same bf16 weights."""
    from repro_torch.config import get_config
    from repro_torch.models import Model
    from repro_torch.serving import grow_caches

    # (a) internlm2-20b, group 6
    cfg = dataclasses.replace(get_config("internlm2-20b"), num_layers=4)
    model = Model(cfg, device="cuda")
    params = model.init(model.generator(8))
    gen = model.generator(9)
    tokens = torch.randint(0, cfg.vocab_size, (4, 4100), generator=gen,
                           device="cuda")
    groups = []
    launch = ops.flash_attention

    def recorded(q, k, v, **kwargs):
        groups.append((tuple(q.shape), tuple(k.shape), kwargs["group"]))
        return launch(q, k, v, **kwargs)

    ops.reset_launch_count()
    ops.flash_attention = recorded
    try:
        with torch.inference_mode():
            logits, caches = model.prefill(params,
                                           {"tokens": tokens[:, :4096]})
            torch.cuda.synchronize()
            n_prefill = ops.launch_count("flash_attention")
            caches = model.prefill_to_decode(grow_caches(caches, 4100))
            steps = [logits]
            for i in range(4):
                logits, caches = model.decode_step(
                    params, tokens[:, 4096 + i:4097 + i], caches, 4096 + i)
                steps.append(logits)
            torch.cuda.synchronize()
    finally:
        ops.flash_attention = launch
    finite = all(bool(torch.isfinite(lg).all()) for lg in steps)
    print(f"internlm2-20b at full width, 4 layers, bf16: prefill of [4, "
          f"4096] and 4 decode steps, logits finite {finite}, "
          f"flash_attention launches {n_prefill} (q, k, group: "
          f"{groups[0] if groups else None}), after decode "
          f"{ops.launch_count('flash_attention')}")
    if (not finite or n_prefill != 4 or len(groups) != 4
            or ops.launch_count("flash_attention") != 4
            or any(g != ((4 * 48, 4096, 128), (4 * 8, 4096, 128), 6)
                   for g in groups)):
        raise AssertionError(f"internlm2-20b: launches {n_prefill}, calls "
                             f"{groups}, finite {finite}")
    del params, caches, model, steps
    torch.cuda.empty_cache()

    # (b) deepseek-7b's decode ≡ prefill, fp32, the cache unquantized
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("deepseek-7b"), num_layers=4,
                              dtype="float32", kv_cache_dtype="bfloat16")
    model = Model(cfg, device="cuda")
    gen = model.generator(10)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 301), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        _, caches = model.prefill(params, {"tokens": tokens[:, :300]})
        caches = model.prefill_to_decode(grow_caches(caches, 301))
        stepped, _ = model.decode_step(params, tokens[:, 300:], caches, 300)
        whole, _ = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    err = float((stepped - whole).abs().max())
    scale = float(whole.abs().max())
    print(f"deepseek-7b decode after prefill(P) vs prefill(P ++ [x]) at "
          f"full width, 4 layers, fp32, P=300: max_abs_err {err!r} on "
          f"logits up to {scale!r} (tolerance {INVARIANT_TOL}, relative and "
          f"absolute)")
    if not bool(torch.isfinite(whole).all()):
        raise AssertionError("invariant logits are not finite")
    torch.testing.assert_close(stepped, whole, rtol=INVARIANT_TOL,
                               atol=INVARIANT_TOL)
    del params, caches, model
    torch.cuda.empty_cache()

    # (c) int8 against bf16 caches on the same bf16 weights
    base = dataclasses.replace(get_config("deepseek-7b"), num_layers=4,
                               kv_cache_dtype="bfloat16")
    params = Model(base, device="cuda").init(torch.Generator(
        device="cuda").manual_seed(11))
    tokens = torch.randint(0, base.vocab_size, (2, 513), generator=torch.
                           Generator(device="cuda").manual_seed(12),
                           device="cuda")
    outs = {}
    for cache in ("bfloat16", "int8"):
        model = Model(dataclasses.replace(base, kv_cache_dtype=cache),
                      device="cuda")
        with torch.inference_mode():
            _, caches = model.prefill(params, {"tokens": tokens[:, :512]})
            caches = model.prefill_to_decode(grow_caches(caches, 513))
            outs[cache], _ = model.decode_step(params, tokens[:, 512:],
                                               caches, 512)
        dtypes = sorted({str(t.dtype) for t in _leaves(caches)})
        print(f"  {cache} cache: leaf types {dtypes}")
        del caches
    denom = max(float(outs["bfloat16"].abs().max()), 1e-3)
    rel = float((outs["int8"] - outs["bfloat16"]).abs().max()) / denom
    print(f"deepseek-7b int8 against bf16 KV cache at full width, 4 layers, "
          f"P=512: relative max difference of the decode logits {rel!r} "
          f"(bound {INT8_REL_BOUND})")
    if not 0.0 < rel < INT8_REL_BOUND:
        raise AssertionError(f"int8 cache: relative difference {rel!r}")
    del params, outs
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
        _prime_profiler()
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


def _prime_profiler():
    """Device work at the start of a profiler session, before the job it
    measures: the profiler has been seen on the card to lose a session's
    first device events (12c's first kernel; a paper-workload job's first
    device-to-host copy, which opens ``_execute_window``'s window).  These
    kernels copy nothing back, so the window still opens at the job's own
    first copy."""
    x = torch.zeros(1, device="cuda")
    for _ in range(8):
        x.add_(1)
    torch.cuda.synchronize()


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
          knee_count=64, mesh_devices=None, **kw):
    from repro_torch.platform import PlatformSpec, WaveOptions

    mean_bytes = float(np.mean([a.nbytes for a in samples.values()]))
    return PlatformSpec(platform="BTS", n_workers=2, backend=backend,
                        waves=WaveOptions(wave=wave, max_wave=16,
                                          mesh_devices=mesh_devices),
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
# that nearly cancel.  The plain version runs on the data widened to
# float64: in fp32 it adds with atomics in no fixed order, and its own
# rounding then comes near this tolerance at long rows and now and then
# past it.  The float64 host check holds the kernel to the same.
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
    version on the data widened to float64, two launches equal bit for bit, the first 3 tasks as a wave
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
        want = ref.subsample_grid_seeded_ref(data.double(), months, rows,
                                             seeds, **skw)
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
        err = _grid_close(got.double(), want, label)
        del want
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
        _prime_profiler()
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


# phase 11 — the multi-tenant service on the same catalogue and EAGLET

# 11d: the early-stopped moments job's error target: a CI half-width of
# 0.5 (ratings 1-5) once 32 tasks are in; a 2,048-movie catalogue on the
# CPU gave 0.18 at 32 tasks
SVC_EPSILON, SVC_MIN_TASKS = 0.5, 32
# 11e: what the allocator may keep above its level before phase 11
SVC_MEMORY_SLACK = 64 << 20
SVC_KERNELS = ("subsample_stats", "subsample_grid")
SVC_REPEATS = 3          # 11b: repeats of the first query


class _ServiceStep:
    """One step of phase 11: the launch counts zeroed on entry and read on
    exit, ``prng.randint`` counted in between; fails on exit if a step
    drew an index outside the kernels."""

    def __init__(self, ops, prng, label):
        self.ops, self.prng, self.label = ops, prng, label
        self.host_draws = 0
        self.launches = {}

    def __enter__(self):
        self._randint = self.prng.randint

        def counted(*args, **kwargs):
            self.host_draws += 1
            return self._randint(*args, **kwargs)

        self.prng.randint = counted
        torch.cuda.synchronize()
        self.ops.reset_launch_count()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prng.randint = self._randint
        self.launches = {k: self.ops.launch_count(k)
                         for k in SVC_KERNELS + ("threefry_randint",)}
        if exc[0] is None and (self.host_draws
                               or self.launches["threefry_randint"]):
            raise AssertionError(f"{self.label}: indices drawn outside the "
                                 "kernels")
        return False

    def total(self):
        return sum(self.launches[k] for k in SVC_KERNELS)


def _reduce_drain_s(n_leaves: int, n_cols: int):
    """Host seconds for a ``StreamingReduceTree`` to take ``n_leaves``
    ``moments`` partials of ``n_cols`` columns, offered at once, and give
    its root: plain (as ``Platform.run`` builds it without an error
    target) and with a ``SubsampleEstimator`` fed each leaf (as the
    service builds every job's)."""
    from repro_torch.core.estimator import SubsampleEstimator
    from repro_torch.platform.reduce import StreamingReduceTree

    rng = np.random.default_rng(0)
    stats = rng.standard_normal((16, 2, n_cols)).astype(np.float32)
    leaves = [{"sum": stats[i % 16, 0], "sumsq": stats[i % 16, 1],
               "count": np.float32(512.0)} for i in range(n_leaves)]
    out = {}
    for label, est in (("plain", None),
                       ("estimator", SubsampleEstimator("moments"))):
        tree = StreamingReduceTree(n_leaves, estimator=est)
        t0 = time.perf_counter()
        for i, leaf in enumerate(leaves):
            tree.offer(i, leaf)
        tree.result(timeout=600)
        out[label] = time.perf_counter() - t0
    return out


def service_on_the_card(ops, prng, ss, samples, months, eaglet, step4,
                        waved):
    """Phase 11: ``PlatformService`` with step 4's spec (threaded, 2
    workers, waves of 16, explicit knees) over the Netflix catalogue and
    EAGLET, each step's launches counted.  11a the first ``moments``
    query (plan, arena, warm-ups) ≡ step 4; 11b the same query again,
    uploading only slot and seed vectors and launching no warm-up; 11c
    four ``moments`` jobs, NETFLIX_HIGH and EAGLET at once, each ≡ its
    seed alone on the same service (and the paper workloads ≡ steps
    4c/4b), launches ≡ the service's dispatches, under
    ``torch.profiler``; 11d an early-stopped ``moments`` job and a
    cancelled one beside a peer that stays ≡ step 4; 11e ``close()``
    frees the card.  Returns each kernel's launches over 11a–11d."""
    import gc

    from repro_torch.platform import PlatformService

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    svc = PlatformService(_spec(samples))
    try:
        launches = _service_steps(ops, prng, ss, svc, samples, months, eaglet,
                                  step4, waved)
    finally:
        svc.close()

    # 11e — the card back: the handles (and their arenas) went with the
    # steps' frame
    del svc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem_after = torch.cuda.memory_allocated()
    print(f"11e: memory_allocated {mem_before} bytes before phase 11, "
          f"{mem_after} after close() and the handles dropped")
    if abs(mem_after - mem_before) > SVC_MEMORY_SLACK:
        raise AssertionError(f"11e: {mem_after - mem_before} bytes still "
                             "allocated after the service closed")
    return launches


def _service_steps(ops, prng, ss, svc, samples, months, eaglet, step4,
                   waved):
    """11a–11d on ``svc``; returns each kernel's launches over them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.platform import MOMENTS, ApproxOptions, CancelledError

    card = _card_line()
    e_samples, e_months = eaglet
    launches = dict.fromkeys(SVC_KERNELS, 0)
    netflix = svc.register_dataset(samples, months, name="netflix")
    eag = svc.register_dataset(e_samples, e_months, name="eaglet",
                               knee_bytes=_spec(e_samples).knee_bytes)

    # 11a — the first moments query builds the class (a ticket's latency
    # runs from the ticket, which submit() makes once the class is built:
    # the host wall around submit and result holds the build too)
    with _ServiceStep(ops, prng, "11a") as step:
        t0 = time.perf_counter()
        first = svc.submit(netflix, MOMENTS, seed=0)
        res = first.result(timeout=600)
        wall = time.perf_counter() - t0
    _assert_bitwise(step4["result"], res, "11a: the service's first query")
    n_tasks = first.n_tasks
    (mqc,) = netflix._classes.values()
    print(f"11a: moments seed 0 bit for bit equal to step 4; submit to "
          f"result {wall!r} s (the class's plan, arena pack and upload and "
          f"warm-up, then the job), the ticket's latency {first.latency!r} "
          f"s, against step 4's run() wall {step4['wall']!r} s; "
          f"bytes_uploaded {first.bytes_uploaded!r} (arena "
          f"{mqc.arena_bytes!r}), subsample_stats launches "
          f"{step.launches['subsample_stats']} ({first.device_dispatches} "
          f"waves + {step4['warm_ups']} warm-ups) ({card})")
    if (step.launches["subsample_stats"]
            != first.device_dispatches + step4["warm_ups"]
            or first.bytes_uploaded != mqc.arena_bytes + 8.0 * n_tasks):
        raise AssertionError("11a: launches or bytes off")
    for k in SVC_KERNELS:
        launches[k] += step.launches[k]

    # 11b — the same query again, three times: the class is cached.  Each
    # wave's host span (the class's wave call, as the service times it) is
    # recorded, so a repeat's latency splits into its waves and the rest
    spans = []
    run = mqc.wave_ctx.run

    def timed_run(tasks, seeds):
        t_wave = time.perf_counter()
        values = run(tasks, seeds)
        spans.append((t_wave, time.perf_counter()))
        return values

    mqc.wave_ctx.run = timed_run
    with _ServiceStep(ops, prng, "11b") as step:
        repeats = []
        for _ in range(SVC_REPEATS):
            del spans[:]
            t0 = time.perf_counter()
            again = svc.submit(netflix, MOMENTS, seed=0)
            res = again.result(timeout=600)
            t1 = time.perf_counter()
            waves_s = sorted(b - a for a, b in spans)
            repeats.append((t1 - t0, again, {
                "waves": len(spans), "wave_s_median":
                waves_s[len(waves_s) // 2], "wave_s_max": waves_s[-1],
                "first_wave_after_submit_s": min(a for a, _ in spans) - t0,
                "waves_span_s": max(b for _, b in spans) - min(
                    a for a, _ in spans),
                "result_after_last_wave_s": t1 - max(b for _, b in spans)}))
            _assert_bitwise(step4["result"], res, "11b: the repeated query")
    mqc.wave_ctx.run = run
    drain = _reduce_drain_s(n_tasks, step4["n_cols"])
    waves = sum(t.device_dispatches for _, t, _ in repeats)
    print(f"11b: {SVC_REPEATS} repeats, each bit for bit; submit to result "
          f"{[w for w, _, _ in repeats]!r} s, ticket latencies "
          f"{[t.latency for _, t, _ in repeats]!r} s, against step 4's "
          f"set-up {step4['setup']!r} s + makespan {step4['makespan']!r} s; "
          f"where a repeat's time goes (host): "
          f"{json.dumps([split for _, _, split in repeats])}; a reduce "
          f"tree's drain of {n_tasks} such leaves offered at once, host s "
          f"{json.dumps(drain)}; bytes_uploaded {[t.bytes_uploaded for _, t, _ in repeats]} (8 a "
          f"task), subsample_stats launches "
          f"{step.launches['subsample_stats']} for {waves} waves ({card})")
    if (any(t.bytes_uploaded != 8.0 * n_tasks for _, t, _ in repeats)
            or step.launches["subsample_stats"] != waves):
        raise AssertionError("11b: a repeat uploaded an arena or "
                             "launched a warm-up")
    for k in SVC_KERNELS:
        launches[k] += step.launches[k]

    # 11c — six jobs at once, each against its seed alone
    jobs = ([("moments", netflix, MOMENTS, s) for s in (1, 2, 3, 4)]
            + [("NETFLIX_HIGH", netflix, ss.NETFLIX_HIGH, 0),
               ("EAGLET", eag, ss.EAGLET, 0)])
    alone = {}
    for label, handle, wl, seed in jobs:
        ticket = svc.submit(handle, wl, seed=seed)
        alone[label, seed] = ticket.result(timeout=600)
        print(f"11c alone: {label} seed {seed}: latency "
              f"{ticket.latency!r} s, {ticket.device_dispatches} waves, "
              f"bytes_uploaded {ticket.bytes_uploaded!r}")
    for name in ("NETFLIX_HIGH", "EAGLET"):
        _assert_bitwise(waved[name].result, alone[name, 0],
                        f"11c: {name} against its Platform.run")
    before = svc.stats()
    with _ServiceStep(ops, prng, "11c") as step:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _prime_profiler()
            t0 = time.perf_counter()
            tickets = [(label, seed, svc.submit(handle, wl, seed=seed))
                       for label, handle, wl, seed in jobs]
            got = [t.result(timeout=600) for _, _, t in tickets]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    after = svc.stats()
    for (label, seed, _), result in zip(tickets, got):
        _assert_bitwise(alone[label, seed], result,
                        f"11c: {label} seed {seed} beside five others")
    dispatched = after["device_dispatches"] - before["device_dispatches"]
    fused = after["fused_dispatches"] - before["fused_dispatches"]
    sizes = list(after["wave_sizes"])[len(before["wave_sizes"]):]
    window_ms, busy_ms, by_kind = _execute_window(
        prof, "platform kernels", ("subsample_stats", "grid_partial_kernel",
                                   "sum_samples_kernel"))
    one_shot = (4 * (step4["setup"] + step4["makespan"])
                + sum(sum(waved[name].phases.get(p, 0.0) for p in (
                    "plan", "distribute", "compile"))
                      + waved[name].makespan
                      for name in ("NETFLIX_HIGH", "EAGLET")))
    print(f"11c: six jobs at once, each bit for bit its seed alone; wall "
          f"{wall!r} s (under the profiler) against {one_shot!r} s for "
          f"six one-shot jobs with their set-ups; {dispatched} "
          f"dispatches, {fused} fused ({fused / max(dispatched, 1)!r}), "
          f"wave_sizes {sizes}; launches {json.dumps(step.launches)}; "
          f"execute window {window_ms!r} ms, device busy {busy_ms!r} ms "
          f"(share {busy_ms / window_ms!r}), device ms by kind "
          f"{json.dumps(by_kind)} ({card})")
    for label, seed, t in tickets:
        print(f"11c {label} seed {seed}: {t.n_tasks} tasks, latency "
              f"{t.latency!r} s, queue wait {t.queue_wait!r} s, "
              f"{t.device_dispatches} waves")
    if step.total() != dispatched:
        raise AssertionError(f"11c: {step.total()} launches for "
                             f"{dispatched} dispatches")
    for k in SVC_KERNELS:
        launches[k] += step.launches[k]

    # 11d — early stop and cancel beside a peer
    with _ServiceStep(ops, prng, "11d") as step:
        peer = svc.submit(netflix, MOMENTS, seed=0)
        eps = svc.submit(netflix, MOMENTS, seed=5, approx=ApproxOptions(
            epsilon=SVC_EPSILON, min_tasks=SVC_MIN_TASKS))
        victim = svc.submit(netflix, MOMENTS, seed=6)
        deadline = time.monotonic() + 120
        while victim.progress()[0] == 0 and time.monotonic() < deadline:
            time.sleep(1e-3)
        at_cancel = victim.progress()[0]
        cancelled = svc.cancel(victim)
        res = peer.result(timeout=600)
        eps.result(timeout=600)
        try:
            victim.result(timeout=60)
        except CancelledError:
            pass
        else:
            raise AssertionError("11d: the cancelled job gave a result")
    _assert_bitwise(step4["result"], res, "11d: the peer")
    print(f"11d: the peer bit for bit equal to step 4; early stop: "
          f"{eps.tasks_executed} of {eps.n_tasks} tasks executed, "
          f"{eps.tasks_cancelled} cancelled, {eps.stop_reason!r}, final "
          f"CI half-width {eps.final_ci['half_width']!r} over "
          f"{eps.final_ci['tasks_in']} tasks; cancelled job: "
          f"{at_cancel} of {victim.n_tasks} leaves in at the cancel, "
          f"status {victim.status!r}; "
          f"launches {json.dumps(step.launches)}")
    if not (eps.tasks_executed < eps.n_tasks and eps.tasks_cancelled
            and "converged" in (eps.stop_reason or "")):
        raise AssertionError("11d: the epsilon job did not stop early")
    if (not cancelled or victim.status != "cancelled"
            or not 0 < at_cancel < victim.n_tasks):
        raise AssertionError("11d: the job was not cancelled mid-run")
    for k in SVC_KERNELS:
        launches[k] += step.launches[k]
    return launches


# phase 12 — sharded waves (mesh_devices) and the elastic pool

MESH_STREAMS = 4         # 12c: entries of one card in the wave mesh


def _setup_s(rep):
    """A job's set-up: its plan, distribute and compile phases."""
    return sum(rep.phases.get(p, 0.0)
               for p in ("plan", "distribute", "compile"))


def _plan_waves(plan, max_wave=16, n_exec=2):
    """The waves ``build_wave_context`` cuts a plan into when one worker
    claims at a time: each shape bucket in FIFO runs of its claim cap."""
    from repro_torch.platform import compute as pc

    by_key = {}
    for task in plan.tasks:
        by_key.setdefault(plan.task_shape(task), []).append(task)
    waves = []
    for group in by_key.values():
        cap = pc.pow2_ceil(min(max_wave, -(-len(group) // n_exec)))
        waves += [group[i:i + cap] for i in range(0, len(group), cap)]
    return waves


def _check_sharded_layout(sharded, plain, plan, label):
    """Each task's block on its entry at its local row is the plain
    arena's block of that task, and each tail row holds the block of
    logical slot ``unshard_slot(dev, local) % b`` (compared on the
    card)."""
    from repro_torch.platform import compute as pc

    by_key = {}
    for task in plan.tasks:
        by_key.setdefault(plan.task_shape(task), []).append(task)
    checked = 0
    for key, group in by_key.items():
        shards, shard_months = sharded.bucket(key)
        data, months = plain.bucket(key)
        per_dev = sharded._per_dev[key]
        for dev in range(sharded.n_dev):
            for local in range(per_dev):
                task = group[pc.unshard_slot(dev, local, sharded.n_dev)
                             % len(group)]
                _, row = plain._slot[task.task_id]
                same = torch.equal(shards[dev][local], data[row]) and (
                    months is None
                    or torch.equal(shard_months[dev][local], months[row]))
                if not same:
                    raise AssertionError(f"12c {label}: entry {dev} row "
                                         f"{local} is not task "
                                         f"{task.task_id}'s block")
                checked += 1
    return checked


def _profiled_waves(prof, kernel_names, occupied):
    """Per wave of a profiled run of sharded waves: the device ms of its
    kernels (summed) and whether two of its launches ran at once (two
    streams overlapping).  ``kernel_names[0]`` is the device function a
    launch runs once; the kernels from a wave's first such function to
    the next wave's are the wave's.  The trace starts with warm-up waves
    (their kernels, before the waves', are left out): the profiler can
    miss the first kernels after it starts."""
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and any(k in e.name for k in kernel_names))
    firsts = [k for k in kernels if kernel_names[0] in k[2]]
    if len(firsts) < sum(occupied):
        raise AssertionError(f"12c: the profiler saw {len(firsts)} "
                             f"{kernel_names[0]} kernels for "
                             f"{sum(occupied)} launches")
    firsts = firsts[len(firsts) - sum(occupied):]
    starts = np.cumsum([0] + list(occupied))
    out = []
    for k in range(len(occupied)):
        mine = firsts[starts[k]:starts[k + 1]]
        lo = mine[0][0]
        hi = firsts[starts[k + 1]][0] if k + 1 < len(occupied) else np.inf
        device_ms = sum(e - s for s, e, _ in kernels if lo <= s < hi) / 1e3
        overlap = any(mine[j][0] < max(m[1] for m in mine[:j])
                      for j in range(1, len(mine)))
        out.append((device_ms, overlap))
    return out


def sharded_below_the_driver(ops, ss, samples, months, spec):
    """12c: a ``ShardedBlockArena`` over a wave mesh of four streams on
    one card, holding step 4's plan (``moments``) and the catalogue's
    NETFLIX_HIGH plan: every wave of the plan through
    ``run_map_wave_sharded`` ≡ ``run_map_wave`` on a plain arena bit for
    bit, one launch an occupied entry, the physical layout checked on the
    card; then the same waves again under ``torch.profiler``.  Returns
    each kernel's launches in the compared runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.mesh import WaveMesh
    from repro_torch.platform import MOMENTS
    from repro_torch.platform import compute as pc
    from repro_torch.platform.driver import plan_job

    mesh = WaveMesh((torch.device("cuda", 0),) * MESH_STREAMS)
    card = _card_line()
    launches = dict.fromkeys(SVC_KERNELS, 0)
    for label, wl, engine, kernel, names in (
            ("moments", MOMENTS, "kernel", "subsample_stats",
             ("subsample_stats",)),
            ("NETFLIX_HIGH", ss.NETFLIX_HIGH, "torch", "subsample_grid",
             ("grid_partial_kernel", "sum_samples_kernel"))):
        t0 = time.perf_counter()
        plan = plan_job(samples, months, wl, sizing="kneepoint",
                        engine=engine, n_exec=2, knee_bytes=spec.knee_bytes)
        with_months = engine == "torch"
        sharded = pc.ShardedBlockArena.pack(plan.tasks, plan.task_shape,
                                            plan.build_block, mesh,
                                            with_months=with_months)
        t_sharded = time.perf_counter() - t0
        plain = pc.BlockArena.pack(plan.tasks, plan.task_shape,
                                   plan.build_block,
                                   with_months=with_months,
                                   device=mesh.devices[0])
        torch.cuda.synchronize()
        rows = _check_sharded_layout(sharded, plain, plan, label)
        waves = _plan_waves(plan)
        seeded = [(w, np.asarray([spec.seed + t.task_id for t in w],
                                 np.int32)) for w in waves]
        occupied, host_ms = [], []
        for wave, seeds in seeded:
            want = pc.run_map_wave(plain, wave, seeds, wl, engine)
            torch.cuda.synchronize()
            ops.reset_launch_count()
            got = pc.run_map_wave_sharded(sharded, wave, seeds, wl, engine)
            n = ops.launch_count(kernel)
            occupied.append(len(set(sharded.dev_slots(wave)[1].tolist())))
            if n != occupied[-1]:
                raise AssertionError(f"12c {label}: {n} launches for "
                                     f"{occupied[-1]} occupied entries")
            launches[kernel] += n
            for w, g in zip(want, got, strict=True):
                _assert_bitwise(w, g, f"12c {label}: sharded vs unsharded "
                                "wave")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the profiler can miss the first kernels after it starts: every
            # wave runs once before the timed ones
            for wave, seeds in seeded:
                pc.run_map_wave_sharded(sharded, wave, seeds, wl, engine)
            torch.cuda.synchronize()
            for wave, seeds in seeded:
                t_wave = time.perf_counter()
                pc.run_map_wave_sharded(sharded, wave, seeds, wl, engine)
                host_ms.append((time.perf_counter() - t_wave) * 1e3)
            torch.cuda.synchronize()
        per_wave = _profiled_waves(prof, names, occupied)
        overlapped = sum(1 for _, o in per_wave if o)
        print(f"12c {label}: {len(plan.tasks)} tasks over {MESH_STREAMS} "
              f"streams of cuda:0, per entry "
              f"{sorted(sharded._per_dev.values())} rows a bucket; sharded "
              f"pack {t_sharded!r} s; layout checked on {rows} rows; "
              f"{len(waves)} waves, each bit for bit the unsharded wave, "
              f"{sum(occupied)} launches = occupied entries "
              f"{occupied}; profiled: host ms a wave "
              f"{json.dumps(host_ms)}, device ms a wave "
              f"{json.dumps([d for d, _ in per_wave])}, waves whose streams' "
              f"kernels overlapped {overlapped} of {len(per_wave)} ({card})")
        del sharded, plain, seeded
        torch.cuda.empty_cache()
    return launches


def sharded_waves_on_the_card(ops, prng, ss, Platform, samples, months,
                              eaglet, step4, waved):
    """Phase 12: sharded waves on the card.  12a step 4's spec at
    ``mesh_devices=1`` ≡ step 4 (launches ≡ waves + warm-ups, every task
    in one wave of at most 16), beside the unsharded job rerun; 12b
    NETFLIX_HIGH and EAGLET at ``mesh_devices=1`` ≡ steps 4c and 4b;
    12c four streams on one card below the driver; 12d the service at
    ``mesh_devices=1`` ≡ 11a; 12e a mesh of more cards than
    the machine has raises (or, with two cards or more, 12a at mesh 2);
    12f the elastic pool's demo session.  Each step's launches are
    counted from 0; returns each kernel's launches over 12a–12d."""
    from repro_torch.launch.elastic import demo_elastic_run
    from repro_torch.platform import MOMENTS, PlatformService
    from repro_torch.platform import compute as pc

    card = _card_line()
    launches = dict.fromkeys(SVC_KERNELS, 0)

    # 12a — the main path on a 1-device mesh
    spec = _spec(samples, mesh_devices=1)
    with _ServiceStep(ops, prng, "12a") as step:
        rep = Platform(spec).run(samples, months, MOMENTS)
    _assert_bitwise(step4["result"], rep.result, "12a: mesh 1 vs step 4")
    n = step.launches["subsample_stats"]
    print(f"12a: moments at mesh_devices=1 bit for bit equal to step 4; "
          f"{rep.device_dispatches} waves (step 4: {step4['dispatches']}), "
          f"subsample_stats launches {n} ({len(rep.wave_sizes)} waves + "
          f"{step4['warm_ups']} warm-ups); set-up {_setup_s(rep)!r} s, "
          f"makespan {rep.makespan!r} s, against step 4's set-up "
          f"{step4['setup']!r} s, makespan {step4['makespan']!r} s ({card})")
    # two workers cut a job's tail into waves by timing (step 4's own
    # reruns take 18 or 19 waves), so the waves are held to the
    # partition's rules here, and equal dispatches at every mesh size
    # with one worker (tests/test_torch_sharded.py, the card tests)
    if (n != len(rep.wave_sizes) + step4["warm_ups"]
            or sum(rep.wave_sizes) != rep.n_tasks
            or max(rep.wave_sizes) > 16):
        raise AssertionError("12a: waves or launches off")
    # the unsharded job again at this point of the process, so that
    # mesh 1 is compared with a job run as late as itself
    again = Platform(_spec(samples)).run(samples, months, MOMENTS)
    _assert_bitwise(step4["result"], again.result, "12a: unsharded rerun")
    print(f"12a: the unsharded job rerun just after: set-up "
          f"{_setup_s(again)!r} s, makespan {again.makespan!r} s, "
          f"{again.device_dispatches} waves ({card})")
    for k in SVC_KERNELS:
        launches[k] += step.launches[k]

    # 12b — the paper's workloads on a 1-device mesh
    e_samples, e_months = eaglet
    for label, (smp, mo), wl in (
            ("NETFLIX_HIGH", (samples, months), ss.NETFLIX_HIGH),
            ("EAGLET", (e_samples, e_months), ss.EAGLET)):
        with _ServiceStep(ops, prng, "12b") as step:
            rep, _ = grid_job(ops, Platform, f"12b {label}", smp, mo, wl,
                              wave="on", spec_kw={"mesh_devices": 1})
        _assert_bitwise(waved[label].result, rep.result,
                        f"12b: {label} at mesh 1 vs step 4c/4b")
        print(f"12b: {label} at mesh_devices=1 bit for bit equal to its "
              f"step 4c/4b run; {rep.device_dispatches} waves (then "
              f"{waved[label].device_dispatches}), makespan "
              f"{rep.makespan!r} s (then {waved[label].makespan!r} s)")
        for k in SVC_KERNELS:
            launches[k] += step.launches[k]

    # 12c — four streams on one card, below the driver
    with _ServiceStep(ops, prng, "12c"):
        below = sharded_below_the_driver(ops, ss, samples, months,
                                         _spec(samples))
    for k in SVC_KERNELS:
        launches[k] += below[k]

    # 12d — the service on a 1-device mesh
    with _ServiceStep(ops, prng, "12d") as step:
        with PlatformService(_spec(samples, mesh_devices=1)) as svc:
            handle = svc.register_dataset(samples, months, name="netflix")
            ticket = svc.submit(handle, MOMENTS, seed=0)
            res = ticket.result(timeout=600)
            (qc,) = handle._classes.values()
            if not isinstance(qc.wave_ctx.arena, pc.ShardedBlockArena):
                raise AssertionError("12d: the class's arena is not sharded")
            del handle, qc
    _assert_bitwise(step4["result"], res, "12d: the service at mesh 1")
    print(f"12d: the service at mesh_devices=1 bit for bit equal to 11a "
          f"(step 4); {ticket.device_dispatches} waves, subsample_stats "
          f"launches {step.launches['subsample_stats']}, ticket latency "
          f"{ticket.latency!r} s")
    if step.launches["subsample_stats"] != (ticket.device_dispatches
                                             + step4["warm_ups"]):
        raise AssertionError("12d: launches off")
    for k in SVC_KERNELS:
        launches[k] += step.launches[k]

    # 12e — more cards than the machine has
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        few = {i: samples[i] for i in range(64)}
        try:
            Platform(_spec(few, mesh_devices=2)).run(
                few, {i: months[i] for i in few}, MOMENTS)
        except ValueError as err:
            print(f"12e: {n_cards} card(s); mesh_devices=2 raised "
                  f"ValueError: {err}")
        else:
            raise AssertionError("12e: mesh_devices=2 ran on one card")
    else:
        rep = Platform(_spec(samples, mesh_devices=2)).run(samples, months,
                                                           MOMENTS)
        _assert_bitwise(step4["result"], rep.result, "12e: mesh 2")
        print(f"12e: {n_cards} cards; moments at mesh_devices=2 bit for "
              f"bit equal to step 4, makespan {rep.makespan!r} s")

    # 12f — the elastic pool's simulated session, on the card's host
    out = demo_elastic_run([1e8, 1e9, 1e8], slo_seconds=30.0)
    print("12f: elastic demo reports " + json.dumps(out["reports"])
          + "; events " + json.dumps([[e.action, e.size, e.reason]
                                      for e in out["events"]]))
    if (not all(r["met_slo"] for r in out["reports"])
            or out["reports"][1]["restarts"] < 1):
        raise AssertionError("12f: the elastic session missed an SLO or "
                             "did not restart")
    return launches


# phase 14 — training
#
# 14b: the card (kernels) against the CPU (plain versions), fp32, full
# width at 2 layers: the loss within 1e-4 relative and each gradient leaf
# within 1e-4 of the leaf's largest entry (fp32 sums in other orders
# through two layers and a 2,048-way head).  The step is Adam's first
# (moments 0): it moves each parameter by lr · g / (|g| + eps) beside the
# weight decay, which is the same on both sides; so gradients that part by
# dg move it apart by up to lr · eps · dg / (|g| + eps)^2, at most 2 lr
# where |g| is near eps.  Each updated entry is held to that bound, with dg
# the gradient tolerance, plus 1e-4 of its leaf's largest parameter
TRAIN_TOL = 1e-4


def _train_run(cfg, batch, seq, **train_kw):
    from repro_torch.config import (MeshConfig, RunConfig, ShapeConfig,
                                    TrainConfig)
    return RunConfig(model=cfg, shape=ShapeConfig("train", "train", seq,
                                                  batch),
                     mesh=MeshConfig((1, 1), ("data", "model")),
                     train=TrainConfig(**train_kw))


def _train_batches(cfg, batch, seq, seed=0):
    """The subsampling input pipeline over a Zipfian corpus, as
    ``launch.train`` builds it."""
    from repro_torch.data import (PipelineConfig, SubsamplingBatchPipeline,
                                  lm_token_corpus)
    corpus = lm_token_corpus(1 << 20, cfg.vocab_size, shard_tokens=1 << 16)
    return SubsamplingBatchPipeline(
        corpus, PipelineConfig(batch_size=batch, seq_len=seq,
                               seed=seed)).batches(None)


def _attention_launches(cfg, n_mb):
    """``flash_attention`` and ``flash_attention_bwd`` launches a step:
    one of each a layer and microbatch, and a second forward for every
    layer under remat, which runs each block's forward again inside its
    backward."""
    from repro_torch.models import transformer as T
    plan = T.stack_plan(cfg)
    unrolled = len(plan.prefix) + len(plan.tail)
    blocks = plan.n_blocks * len(plan.pattern)
    again = 2 if cfg.remat != "none" else 1
    return ({"flash_attention": n_mb * (unrolled + again * blocks),
             "flash_attention_bwd": n_mb * (unrolled + blocks)})


def _kind_of(name):
    if "flash_attention" in name:
        return "flash_attention forward"
    if "flash_bwd" in name:
        return "flash_attention_bwd"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "nvjet",
                                       "sm90_", "cublas")):
        return "GEMM"
    return "elementwise and reductions"


def _profiled_step(step_fn, state, batch, label):
    """One training step under ``torch.profiler``: the device time by kind
    (GEMMs, the attention forward and backward, AdamW's update: the
    kernels launched inside ``adamw.update``, the rest: elementwise work
    and reductions) and the device's busy share of the step's wall
    time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.optim import adamw

    update = adamw.update

    def annotated(*args, **kwargs):
        with record_function("adamw.update"):
            return update(*args, **kwargs)

    torch.cuda.synchronize()
    adamw.update = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = step_fn(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        adamw.update = update
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    annotations = [e for e in on_device if e.name == "adamw.update"]
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in on_device if e.name != "adamw.update")
    if not dev:
        raise AssertionError(f"the profiler saw no device time in {label}")
    kinds = {}
    for start, end, name in dev:
        kinds[_kind_of(name)] = kinds.get(_kind_of(name), 0.0) + (
            end - start) / 1e3
    # AdamW's kernels are elementwise: move them to their own kind (the
    # device time of the kernels its range launched; where the profiler
    # attributes none, the span of its range on the device)
    opt_ms = sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
                 if e.name == "adamw.update"
                 and e.device_type != torch.autograd.DeviceType.CUDA) / 1e3
    if opt_ms <= 0.0:
        opt_ms = sum(e.time_range.end - e.time_range.start
                     for e in annotations) / 1e3
    if opt_ms > 0.0:
        kinds["AdamW"] = opt_ms
        kinds["elementwise and reductions"] -= opt_ms
    busy = _busy_us(dev)
    total = sum(kinds.values())
    by_name = {}
    for start, end, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"{label} under the profiler: wall {wall * 1e3!r} ms, device time "
          f"{total!r} ms by kind [ms, share] "
          + json.dumps({k: [v, v / total] for k, v in sorted(kinds.items())})
          + f", device busy {busy / 1e3!r} ms (share of the wall "
          f"{busy / 1e3 / (wall * 1e3)!r}); top device ms by name "
          + json.dumps([[n[:70], round(t, 3)] for n, t in top]))
    return out, kinds


def train_musicgen_whole(ops):
    """14a: ``musicgen-medium`` whole (48 layers, d_model 1536, 24 heads of
    64, d_ff 6144, vocab 2048; bf16 parameters from a seed), the
    reference's default ``TrainConfig`` precision (fp32 moments and
    accumulation, remat full) with a learning rate of 3e-3 and one warm-up
    step (the schedule's rate is 0 at step 0, and a bf16 norm scale of 1
    moves only for steps over 2e-3): batch 8 × 2,048 tokens from the
    subsampling pipeline, 4 microbatches by the config's 4,096-token
    kneepoint, 5 steps through ``train()``."""
    from repro_torch.config import get_config
    from repro_torch.models import Model
    from repro_torch.optim import adamw
    from repro_torch.train import loop, microbatch
    from repro_torch.tree import tree_leaves_with_path

    card = _card_line()
    cfg = get_config("musicgen-medium")
    run = _train_run(cfg, 8, 2048, learning_rate=3e-3, warmup_steps=1,
                     total_steps=5)
    n_mb = run.microbatches()
    if n_mb != 4:
        raise AssertionError(f"14a: {n_mb} microbatches, not 4")
    want = _attention_launches(cfg, n_mb)
    model = Model(cfg)
    stamps = []

    def timed(batches):
        for b in batches:
            stamps.append(time.perf_counter())
            yield b

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    report = loop.train(model, run, timed(_train_batches(cfg, 8, 2048)), 5,
                        log_every=100)
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = {k: ops.launch_count(k) for k in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip(stamps, stamps[1:] + [end])]
    tokens = 8 * 2048
    print(f"14a: 5 steps through train() in {report.seconds!r} s: losses "
          f"{report.losses}, step seconds {step_s}, tokens/s "
          f"{[tokens / s for s in step_s]}, peak memory {peak} bytes; "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}"
          f" in 5 steps, a step {json.dumps(want)} (4 microbatches x 48 "
          f"layers, the forward twice under remat) ({card})")
    if not all(np.isfinite(report.losses)):
        raise AssertionError(f"14a: a loss is not finite: {report.losses}")
    for k, n in want.items():
        if launches[k] != 5 * n:
            raise AssertionError(f"14a: {k} launched {launches[k]} times in "
                                 f"5 steps, not 5 x {n}")
    if any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"14a: other kernels launched: {launches}")

    # every leaf's gradient is non-zero, and every leaf moves: from the
    # same state again (init_state draws it from the run's seed)
    state0 = loop.init_state(model, run)
    batches = _train_batches(cfg, 8, 2048, seed=1)
    b1 = loop.to_device(next(batches), "cuda")
    _, _, grads = microbatch.accumulate_gradients(model.loss, state0.params,
                                                  b1, n_mb)
    norms = {"/".join(map(str, p)): float(torch.linalg.vector_norm(
        g.float())) for p, g in tree_leaves_with_path(grads)}
    bad = [k for k, v in norms.items() if not (np.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"14a: zero or non-finite gradients: {bad}")
    lr = adamw.lr_schedule(run.train, torch.ones((), dtype=torch.int32,
                                                 device="cuda"))
    opt_ms = _time_ms(lambda: adamw.update(grads, state0.opt, state0.params,
                                           lr, run.train), reps=1)
    del grads
    torch.cuda.empty_cache()
    step_fn = loop.make_train_step(model, run)
    s1, m1 = step_fn(state0, b1)
    (s2, m2), kinds = _profiled_step(step_fn, s1, loop.to_device(
        next(batches), "cuda"), "14a: step 2")
    moved = [k for (k, _), a, b in zip(
        tree_leaves_with_path(state0.params),
        (t for _, t in tree_leaves_with_path(state0.params)),
        (t for _, t in tree_leaves_with_path(s2.params)))
        if not torch.equal(a, b)]
    still = len(norms) - len(moved)
    print(f"14a: every one of {len(norms)} leaves has a finite non-zero "
          f"gradient (smallest norm {min(norms.values())!r}, the wq/wk/wv "
          f"norms {[norms[k] for k in sorted(norms) if k.endswith(('wq', 'wk', 'wv'))]}); "
          f"{len(moved)} of {len(norms)} leaves changed over two steps "
          f"(losses {float(m1['loss'])!r}, {float(m2['loss'])!r}); "
          f"adamw.update alone {opt_ms!r} ms ({card})")
    if still or not (np.isfinite(float(m1["loss"]))
                     and np.isfinite(float(m2["loss"]))):
        raise AssertionError(f"14a: {still} leaves did not change")
    del state0, s1, s2
    torch.cuda.empty_cache()
    return {"launches": launches, "want": want, "losses": report.losses,
            "step_s": step_s, "peak_bytes": peak, "kinds_ms": kinds,
            "adamw_ms": opt_ms}


def train_card_against_cpu():
    """14b: one ``make_train_step`` on the card (the kernels) and on the
    CPU (their plain versions) from the same fp32 parameters and batch:
    ``musicgen-medium`` at full width cut to 2 layers, batch 2 × 256, from
    step 1 (a learning rate of 1e-2)."""
    import dataclasses as dc

    from repro_torch.config import get_config
    from repro_torch.models import Model
    from repro_torch.train import loop, microbatch
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dc.replace(get_config("musicgen-medium"), num_layers=2,
                     dtype="float32")
    run = _train_run(cfg, 2, 256, learning_rate=1e-2, warmup_steps=1,
                     total_steps=5)
    cpu_model, card_model = Model(cfg, device="cpu"), Model(cfg)
    cpu_state = loop.init_state(cpu_model, run)
    cpu_state = cpu_state._replace(step=torch.ones((), dtype=torch.int32))
    card_state = tree_map(lambda t: t.to("cuda"), cpu_state)
    host = next(_train_batches(cfg, 2, 256, seed=2))
    results = {}
    for where, model, state in (("cpu", cpu_model, cpu_state),
                                ("cuda", card_model, card_state)):
        batch = loop.to_device(host, where)
        _, _, grads = microbatch.accumulate_gradients(
            model.loss, state.params, batch, run.microbatches())
        new, metrics = loop.make_train_step(model, run)(state, batch)
        results[where] = (tree_map(lambda t: t.cpu(), grads),
                          tree_map(lambda t: t.cpu(), new.params),
                          float(metrics["loss"]))
    (g_cpu, p_cpu, l_cpu), (g_card, p_card, l_card) = (results["cpu"],
                                                       results["cuda"])
    if abs(l_card - l_cpu) > TRAIN_TOL * abs(l_cpu):
        raise AssertionError(f"14b: loss {l_card!r} on the card, {l_cpu!r} "
                             "on the CPU")
    worst_g = worst_p = 0.0
    lr, eps = run.train.learning_rate, run.train.eps
    # the update sees the gradients clipped to a global norm of grad_clip
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g))
                                 for g in tree_leaves(g_cpu))))
    clip = min(1.0, run.train.grad_clip / gnorm)
    for gc, gk, pc_, pk in zip(tree_leaves(g_cpu), tree_leaves(g_card),
                               tree_leaves(p_cpu), tree_leaves(p_card)):
        scale = float(gc.abs().max())
        worst_g = max(worst_g, float((gk - gc).abs().max()) / scale)
        dg = clip * TRAIN_TOL * scale
        reach = torch.clamp(
            lr * eps * dg / torch.square(clip * gc.abs() + eps), max=2 * lr)
        tol = reach + TRAIN_TOL * float(pc_.abs().max())
        diff = (pk - pc_).abs()
        if bool((diff > tol).any()):
            raise AssertionError("14b: an updated parameter parts from the "
                                 f"CPU's by {float(diff.max())!r}")
        worst_p = max(worst_p, float(diff.max()))
    if worst_g > TRAIN_TOL:
        raise AssertionError(f"14b: gradients part by {worst_g!r} of their "
                             "leaves' largest")
    print(f"14b: musicgen-medium at full width, 2 layers, fp32, batch 2 x "
          f"256: loss {l_card!r} on the card, {l_cpu!r} on the CPU "
          f"(relative {abs(l_card - l_cpu) / abs(l_cpu)!r}, within "
          f"{TRAIN_TOL}); gradients within {worst_g!r} of each leaf's "
          f"largest; updated parameters within {worst_p!r} (each held to "
          "the reach of its gradient's tolerance)")


# 14e: a bf16 microbatch's gradients with flash_attention_bwd's kernel
# against the same microbatch with attention's backward computed by its
# plain version on the card.  The forward and the loss are the same
# kernels; each attention gradient of the kernel is within one bf16
# rounding of the plain version's (FA_BWD_TOL), and the layers below
# propagate those differences through bf16 products: each leaf's gradient
# is held to 1e-2 of its largest entry (2.5 bf16 steps)
TRAIN_BF16_BWD_TOL = 1e-2


def train_bf16_against_plain_bwd(ops, ref):
    """14e: ``musicgen-medium`` at full width cut to 2 layers, bf16
    parameters from a seed, one microbatch of 2 × 2,048 (q ``[48, 2048,
    64]``, the tensor-core body): ``accumulate_gradients`` with the kernel,
    then with ``ops.flash_attention_bwd`` swapped for
    ``ref.flash_attention_bwd_ref``; the losses equal bit for bit, each
    gradient leaf within ``TRAIN_BF16_BWD_TOL`` of its largest entry."""
    import dataclasses as dc

    from repro_torch.config import get_config
    from repro_torch.models import Model
    from repro_torch.train import loop, microbatch
    from repro_torch.tree import tree_leaves_with_path

    cfg = dc.replace(get_config("musicgen-medium"), num_layers=2)
    run = _train_run(cfg, 2, 2048, learning_rate=3e-3, warmup_steps=1,
                     total_steps=5)
    model = Model(cfg)
    state = loop.init_state(model, run)
    batch = loop.to_device(next(_train_batches(cfg, 2, 2048, seed=4)),
                           "cuda")
    kernel_bwd = ops.flash_attention_bwd

    def plain_bwd(q, k, v, out, lse, dout, *, causal=True, group=1):
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal, group=group)

    ops.reset_launch_count()
    loss_k, _, grads_k = microbatch.accumulate_gradients(
        model.loss, state.params, batch, 1)
    launched = ops.launch_count("flash_attention_bwd")
    ops.flash_attention_bwd = plain_bwd
    try:
        loss_p, _, grads_p = microbatch.accumulate_gradients(
            model.loss, state.params, batch, 1)
    finally:
        ops.flash_attention_bwd = kernel_bwd
    want = _attention_launches(cfg, 1)["flash_attention_bwd"]
    if launched != want or ops.launch_count(
            "flash_attention_bwd") != launched:
        raise AssertionError(f"14e: {launched} kernel backward launches, "
                             f"not {want}, or the plain pass "
                             "launched the kernel")
    worst, where = 0.0, None
    for (path, gk), (_, gp) in zip(tree_leaves_with_path(grads_k),
                                   tree_leaves_with_path(grads_p)):
        gk, gp = gk.float(), gp.float()
        scale = float(gp.abs().max())
        rel = float((gk - gp).abs().max()) / scale if scale else float(
            gk.abs().max())
        if not (np.isfinite(rel) and scale > 0):
            raise AssertionError(f"14e: leaf {path} has a zero or "
                                 "non-finite gradient")
        if rel > worst:
            worst, where = rel, "/".join(map(str, path))
    print(f"14e: musicgen-medium at full width, 2 layers, bf16, one "
          f"microbatch of 2 x 2048: loss {float(loss_k)!r} with the kernel, "
          f"{float(loss_p)!r} with the plain backward; gradients within "
          f"{worst!r} of each leaf's largest (worst {where}; bound "
          f"{TRAIN_BF16_BWD_TOL})")
    if not torch.equal(loss_k, loss_p) or worst > TRAIN_BF16_BWD_TOL:
        raise AssertionError("14e: the kernel's gradients part from the "
                             "plain backward's")


def train_deepseek_cut():
    """14c: ``deepseek-7b`` at full width (d_model 4096, 32 heads of 128,
    d_ff 11008, vocab 102,400) cut to 4 layers, bf16, one step at batch
    1 × 4,064: the loss finite and every layer's wq, wk and wv with a
    non-zero gradient."""
    import dataclasses as dc

    from repro_torch.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.train import loop, microbatch

    cfg = dc.replace(get_config("deepseek-7b"), num_layers=4)
    run = _train_run(cfg, 1, 4064, learning_rate=1e-2, warmup_steps=1,
                     total_steps=5)
    model = Model(cfg)
    state = loop.init_state(model, run)
    batch = loop.to_device(next(_train_batches(cfg, 1, 4064, seed=3)),
                           "cuda")
    ops.reset_launch_count()
    loss, _, grads = microbatch.accumulate_gradients(
        model.loss, state.params, batch, run.microbatches())
    counted = {k: ops.launch_count(k) for k in ("flash_attention",
                                                "flash_attention_bwd")}
    want = _attention_launches(cfg, run.microbatches())
    mix = grads["blocks"][0]["mix"]
    norms = {n: torch.linalg.vector_norm(mix[n].float(), dim=(1, 2)).tolist()
             for n in ("wq", "wk", "wv")}
    if counted != want or not np.isfinite(float(loss)) or not all(
            v > 0 and np.isfinite(v) for vs in norms.values() for v in vs):
        raise AssertionError(f"14c: loss {float(loss)!r}, launches "
                             f"{counted} (want {want}), norms {norms}")
    del grads
    t0 = time.perf_counter()
    _, metrics = loop.make_train_step(model, run)(state, batch)
    step_s = time.perf_counter() - t0
    print(f"14c: deepseek-7b, 4 layers at full width, batch 1 x 4064: loss "
          f"{float(loss)!r} (the step's {float(metrics['loss'])!r}, "
          f"{step_s!r} s), launches {counted}, per-layer gradient norms "
          f"{json.dumps(norms)}")
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError("14c: the step's loss is not finite")


def train_resume():
    """14d: checkpoint and resume on the card: ``musicgen-medium`` at full
    width cut to 2 layers, bf16, batch 2 × 512; 4 steps straight against
    2 steps, a checkpoint, a fresh ``train()`` that restores it and 2
    more steps on the pipeline's next batches: the losses equal bit for
    bit."""
    import dataclasses as dc
    import itertools
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import get_config
    from repro_torch.models import Model
    from repro_torch.train import loop

    cfg = dc.replace(get_config("musicgen-medium"), num_layers=2)
    run = _train_run(cfg, 2, 512, learning_rate=3e-3, warmup_steps=1,
                     total_steps=4)
    model = Model(cfg)
    straight = loop.train(model, run, _train_batches(cfg, 2, 512), 4,
                          log_every=100)
    where = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(where, keep=2)
        first = loop.train(model, run, _train_batches(cfg, 2, 512), 2,
                           checkpoint_manager=mgr, checkpoint_every=2,
                           log_every=100)
        rest = itertools.islice(_train_batches(cfg, 2, 512), 2, None)
        second = loop.train(model, run, rest, 4, checkpoint_manager=mgr,
                            log_every=100)
        saved = mgr.all_steps()
    finally:
        shutil.rmtree(where, ignore_errors=True)
    print(f"14d: 4 steps straight {straight.losses}; 2 steps "
          f"{first.losses}, resumed from step {saved[0]}, 2 steps "
          f"{second.losses}")
    if first.losses + second.losses != straight.losses:
        raise AssertionError("14d: the resumed run's losses differ from the "
                             "straight run's")


def train_on_the_card(ops, ref):
    """Phase 14: training, 14a–14e."""
    t0 = time.perf_counter()
    out = train_musicgen_whole(ops)
    print(f"14a: {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    train_bf16_against_plain_bwd(ops, ref)
    torch.cuda.empty_cache()
    print(f"train_bf16_against_plain_bwd: {time.perf_counter() - t0!r} s")
    for step in (train_card_against_cpu, train_deepseek_cut, train_resume):
        t0 = time.perf_counter()
        step()
        torch.cuda.empty_cache()
        print(f"{step.__name__}: {time.perf_counter() - t0!r} s")
    return out


# phase 15 — the mixture-of-experts models and the patch frontend
#
# 15a: deepseek-moe-16b whole at batch 4 and a 3,072-token prompt: three
# segments of 1,024 positions, T = 4,096 tokens a segment, capacity 480
MOE_BATCH = 4
MOE_PROMPT = 3072
MOE_SEG_CAPACITY = 480
# 15b: one prefill at 4 × 4,064, unsegmented (4,064 is no multiple of
# 1,024): T = 16,256, capacity 1,912
MOE_LONG = 4064
MOE_LONG_CAPACITY = 1912
# 15c: one MoE layer, fp32 with TF32 off, the card against the CPU.  A
# token's expert indices are held equal where the k-th and (k+1)-th
# probabilities part by more than MOE_MARGIN (the sums of 2,048 products
# in other orders move a logit by ~1e-6); the outputs of the tokens routed
# alike within MOE_LAYER_TOL of the largest (fp32 products of width 2,048
# and 1,408 added in other orders)
MOE_MARGIN = 1e-5
MOE_LAYER_TOL = 1e-4
# 15e: llava-next-34b cut in depth (the fp32 draw of its whole stacked wi,
# [60, 7168, 20480], would take 35 GB beside 68.8 GB of weights), and its
# prefill attention: 56 query heads on 8 KV heads, batch 4, 576 patches
# and 1,024 tokens
LLAVA_LAYERS = 8
LLAVA_TEXT = 1024
GROUP7_FA = (4 * 56, 576 + 1024, 576 + 1024, 128, True, 0, 7)


def _p15_config(name, **kw):
    from repro_torch.config import get_config
    return dataclasses.replace(get_config(name), **kw)


class _Slots:
    """Counts the (token, choice) pairs ``moe._slots`` keeps and drops, and
    the capacities it is called with, while installed."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe._slots
        self.kept, self.pairs, self.capacities = [], 0, set()

    def __enter__(self):
        def counted(cfg, idx, c):
            rows, keep = self.orig(cfg, idx, c)
            self.kept.append(keep.sum())
            self.pairs += keep.numel()
            self.capacities.add(c)
            return rows, keep

        self.moe._slots = counted
        return self

    def __exit__(self, *exc):
        self.moe._slots = self.orig

    def dropped_share(self):
        kept = int(sum(k.item() for k in self.kept))
        return (self.pairs - kept) / max(1, self.pairs)


MOE_PARTS = ("moe.route", "moe.dispatch", "moe.experts", "moe.shared")


def _moe_owner(spans, t):
    """The MoE range whose device span holds time ``t``, the innermost
    first (the expert products run inside the dispatch's range), or
    None."""
    import bisect
    for name in ("moe.experts", "moe.shared", "moe.route", "moe.dispatch"):
        starts, ends = spans.get(name, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ends[i]:
            return name
    return None


def _moe_prefill_split(model, params, batch, label):
    """One prefill under ``torch.profiler`` with the MoE functions in
    ``record_function`` ranges: the device ms of the routing (``_route``),
    the expert products (``_expert_ffn`` and the shared experts), dispatch
    and combine (the rest of ``_dispatch_einsum``: slots, the combine
    tensor, the row gather and the combine product), ``flash_attention``
    and the rest (the dense layer, projections, norms, the head).  Each
    kernel goes to the innermost range whose span on the device holds its
    start; a trace without device spans for the four ranges fails."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe

    names = dict(zip(MOE_PARTS, ("_route", "_dispatch_einsum", "_expert_ffn",
                                 "_shared_ffn")))
    originals = {n: getattr(moe, f) for n, f in names.items()}

    def ranged(label_, fn):
        def call(*args, **kwargs):
            with record_function(label_):
                return fn(*args, **kwargs)
        return call

    torch.cuda.synchronize()
    for n, f in names.items():
        setattr(moe, f, ranged(n, originals[n]))
    try:
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for n, f in names.items():
            setattr(moe, f, originals[n])
    events = prof.events()
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in on_device if e.name not in MOE_PARTS]
    if not kernels:
        raise AssertionError(f"the profiler saw no device time in {label}")
    total = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    spans = {}
    for n in MOE_PARTS:
        ss = sorted((e.time_range.start, e.time_range.end)
                    for e in on_device if e.name == n)
        if ss:
            spans[n] = ([a for a, _ in ss], [b for _, b in ss])
    kind_of = {"moe.experts": "expert products",
               "moe.shared": "expert products",
               "moe.route": "routing", "moe.dispatch": "dispatch and combine"}
    kinds = dict.fromkeys(("expert products", "dispatch and combine",
                           "routing", "flash_attention", "the rest"), 0.0)
    if len(spans) != len(MOE_PARTS):
        raise AssertionError(f"{label}: the trace has device spans for "
                             f"{sorted(spans)}, not for all of {MOE_PARTS}")
    by_name = {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        owner = _moe_owner(spans, e.time_range.start)
        kind = (kind_of[owner] if owner else "flash_attention"
                if "flash_attention" in e.name else "the rest")
        kinds[kind] += ms
        key = (e.name[:60], kind)
        by_name[key] = by_name.get(key, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    busy = _busy_us(sorted((e.time_range.start, e.time_range.end, e.name)
                           for e in kernels))
    print(f"{label} under the profiler: host wall {wall * 1e3!r} ms, device "
          f"time {total!r} ms by kind [ms, share] "
          + json.dumps({k: [v, v / total] for k, v in kinds.items()})
          + f" (from the device spans), device busy {busy / 1e3!r} ms "
          f"(share of "
          f"the wall {busy / 1e3 / (wall * 1e3)!r}); top device ms by name "
          f"and kind "
          + json.dumps([[n, k, round(t, 3)] for (n, k), t in top]))
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: logits are not finite")
    return kinds


def serve_moe_whole(ops):
    """15a and 15b: ``deepseek-moe-16b`` whole (28 layers: a dense first
    layer of d_ff 10,944, then 27 MoE layers of 64 experts of 1,408, top
    6, two shared experts; d_model 2048, 16 heads of 128; vocab 102,400),
    bf16 weights from a seed, einsum dispatch, through
    ``ServingEngine.generate``; returns what the kernel table reads."""
    from repro_torch.config import ShapeConfig
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine, grow_caches

    cfg = _p15_config("deepseek-moe-16b")
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"15a: deepseek-moe-16b, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_experts} experts of {cfg.moe_d_ff} top "
          f"{cfg.moe_top_k} + {cfg.num_shared_experts} shared, dispatch "
          f"{cfg.moe_dispatch}: {n_params} bf16 parameters "
          f"({cfg.param_count()} by the config's count) drawn in "
          f"{time.perf_counter() - t0!r} s")
    engine = ServingEngine(model, params, max_new_tokens=32)
    batch = model.make_inputs(ShapeConfig("serve", "prefill", MOE_PROMPT,
                                          MOE_BATCH), model.generator(1))
    warm = engine.generate(batch, new_tokens=2)
    print(f"15a: warm-up generate (2 new tokens): prefill "
          f"{warm.prefill_seconds!r} s, decode {warm.decode_seconds!r} s")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    out = engine.generate(batch, new_tokens=32)
    launches = {name: ops.launch_count(name) for name in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    with _Slots() as slots, torch.inference_mode():
        logits, _ = model.prefill(params, batch)
        dropped = slots.dropped_share()
    print(f"15a: serving deepseek-moe-16b, batch {MOE_BATCH}, prompt "
          f"{MOE_PROMPT}, 32 new tokens: prefill_seconds "
          f"{out.prefill_seconds!r}, decode_seconds {out.decode_seconds!r} "
          f"({out.decode_seconds / 32 * 1e3!r} ms a step), "
          f"tokens_per_second {out.tokens_per_second!r}, peak device memory "
          f"{peak} bytes; launches {json.dumps(launches)}; a prefill's "
          f"(token, choice) pairs dropped: {dropped!r} of {slots.pairs} "
          f"(capacities {sorted(slots.capacities)}) ({_card_line()})")
    others = {n: c for n, c in launches.items()
              if n != "flash_attention" and c}
    if launches["flash_attention"] != cfg.num_layers or others:
        raise AssertionError(f"15a: flash_attention launched "
                             f"{launches['flash_attention']} times, not "
                             f"{cfg.num_layers}, and {others}")
    if slots.capacities != {MOE_SEG_CAPACITY}:
        raise AssertionError(f"15a: capacities {slots.capacities}")
    if out.tokens.shape != (MOE_BATCH, 32) or not (
            (out.tokens >= 0) & (out.tokens < cfg.vocab_size)).all():
        raise AssertionError(f"15a: generated tokens {out.tokens.shape}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("15a: prefill logits are not finite")
    kinds = _moe_prefill_split(model, params, batch, "15a: deepseek-moe-16b "
                               "prefill")
    with torch.inference_mode():
        logits, caches = model.prefill(params, batch)
        caches = model.prefill_to_decode(grow_caches(caches,
                                                     MOE_PROMPT + 32))
        tok = torch.argmax(logits, dim=-1)[:, None]
        step_logits, _ = _profiled(
            "15a: deepseek-moe-16b decode step", lambda: model.decode_step(
                params, tok, caches, MOE_PROMPT), ("flash_attention",),
            absent=("flash_attention",))
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError("15a: decode logits are not finite")
    del engine, logits, caches, step_logits
    torch.cuda.empty_cache()

    # 15b: the unsegmented prefill
    long_batch = model.make_inputs(ShapeConfig("serve", "prefill", MOE_LONG,
                                               MOE_BATCH), model.generator(2))
    torch.cuda.reset_peak_memory_stats()
    with _Slots() as slots, torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, long_batch)
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t0
        long_dropped = slots.dropped_share()
    long_peak = torch.cuda.max_memory_allocated()
    print(f"15b: one deepseek-moe-16b prefill at {MOE_BATCH} x {MOE_LONG} "
          f"(unsegmented, capacities {sorted(slots.capacities)}): "
          f"{long_s!r} s, peak device memory {long_peak} bytes, pairs "
          f"dropped {long_dropped!r}")
    if slots.capacities != {MOE_LONG_CAPACITY} or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"15b: capacities {slots.capacities}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del params, caches, logits, model
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": out.prefill_seconds,
            "decode_s": out.decode_seconds, "peak_bytes": peak,
            "dropped": dropped, "kinds_ms": kinds, "long_s": long_s,
            "long_peak_bytes": long_peak}


def _moe_layer_params(cfg, seed):
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import init_params
    return init_params(moe.moe_defs(cfg), torch.float32, torch.device("cpu"),
                       torch.Generator().manual_seed(seed))


def moe_layer_card_against_cpu():
    """15c: one MoE layer at ``deepseek-moe-16b``'s full width (64 experts
    of 1,408, top 6, two shared; d_model 2048), fp32 with TF32 off, x [4,
    1024, 2048] (T = 4,096, capacity 480), both dispatch modes, on the card
    against the CPU; then the card's tie-break in bf16."""
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    cfg = _p15_config("deepseek-moe-16b")
    cpu = _moe_layer_params(cfg, 21)
    card = tree_map(lambda t: t.to("cuda"), cpu)
    x = torch.randn((4, 1024, cfg.d_model),
                    generator=torch.Generator().manual_seed(22))
    xc = x.to("cuda")
    k = cfg.moe_top_k
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            i_cpu, _, aux_cpu, p_cpu = moe._route(cfg, cpu,
                                                  x.reshape(-1, cfg.d_model))
            i_card = moe._route(cfg, card, xc.reshape(-1, cfg.d_model))[0]
            top = torch.sort(p_cpu, dim=-1, descending=True).values
            margin = top[:, k - 1] - top[:, k]
            clear = margin > MOE_MARGIN
            alike = (i_card.cpu() == i_cpu).all(-1)
            print(f"15c: routing of {x.shape[0] * x.shape[1]} tokens: "
                  f"{int((~clear).sum())} with a k-th/(k+1)-th margin at "
                  f"or below {MOE_MARGIN} (smallest {float(margin.min())!r}), "
                  f"{int((~alike).sum())} routed otherwise on the card")
            if not torch.equal(i_card.cpu()[clear], i_cpu[clear]):
                raise AssertionError("15c: expert indices differ on a "
                                     "clear margin")
            for mode in ("einsum", "scatter"):
                y_cpu, a_cpu = moe.moe_apply(cfg, cpu, x, dispatch=mode)
                y, a = moe.moe_apply(cfg, card, xc, dispatch=mode)
                again, _ = moe.moe_apply(cfg, card, xc, dispatch=mode)
                ms = _time_ms(lambda: moe.moe_apply(cfg, card, xc,
                                                    dispatch=mode), reps=3)
                scale = float(y_cpu.abs().max())
                diff = (y.cpu() - y_cpu).reshape(-1, cfg.d_model)[alike]
                err = float(diff.abs().max())
                print(f"15c: {mode}: output within {err / scale!r} of its "
                      f"largest {scale!r} on the tokens routed alike (bound "
                      f"{MOE_LAYER_TOL}), aux {float(a)!r} on the card, "
                      f"{float(a_cpu)!r} on the CPU, two launches equal "
                      f"{torch.equal(y, again)}; the layer in fp32 {ms!r} ms "
                      f"on the card")
                if err > MOE_LAYER_TOL * scale or not torch.equal(y, again):
                    raise AssertionError(f"15c: {mode}: error {err!r}, or "
                                         "two launches differ")
                if abs(float(a) - float(a_cpu)) > 1e-5 * abs(float(a_cpu)):
                    raise AssertionError(f"15c: {mode}: aux {float(a)!r} "
                                         f"against {float(a_cpu)!r}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    del cpu, card

    # the tie-break in bf16: router columns equal in fours, then all equal
    g = torch.Generator().manual_seed(23)
    xb = torch.randn((4096, cfg.d_model), generator=g).to("cuda",
                                                          torch.bfloat16)
    cols = torch.randn((cfg.d_model, cfg.num_experts // 4), generator=g)
    router = cols.repeat_interleave(4, dim=1).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        idx, _, _, probs = moe._route(cfg, {"router": router}, xb)
        same = router[:, :1].expand(-1, cfg.num_experts).contiguous()
        idx_same = moe._route(cfg, {"router": same}, xb)[0]
    chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, idx, True)
    chosen = chosen.view(-1, cfg.num_experts // 4, 4).int()
    fours = probs.view(-1, cfg.num_experts // 4, 4)
    partial = int(((chosen.sum(-1) % 4) != 0).any(-1).sum())
    lower = bool((chosen[..., 1:] <= chosen[..., :-1]).all())
    first_k = torch.equal(idx_same, torch.arange(
        k, device=idx_same.device).expand_as(idx_same))
    print(f"15c: bf16 ties: router columns equal in fours, {partial} of "
          f"{xb.shape[0]} tokens cut a tied four at the top {k}, the lower "
          f"indices taken {lower}; all columns equal: every token's top {k} "
          f"is 0..{k - 1} {first_k}")
    if not (torch.equal(fours, fours[..., :1].expand_as(fours)) and lower
            and first_k and partial == xb.shape[0]):
        raise AssertionError("15c: the card broke a top-k tie to a higher "
                             "index")


def arctic_one_layer(ops):
    """15d: ``arctic-480b`` at full width cut to one layer (d_model 7168,
    56 heads of 128 on 8, 128 experts of 4,864 top 2 beside a dense
    residual FFN of 4,864; vocab 32,000), bf16 from a seed: a prefill at
    batch 1 × 2,048 (T = 2,048, capacity 40)."""
    from repro_torch.models import Model

    cfg = _p15_config("arctic-480b", num_layers=1)
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(model.generator(30))
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    tokens = torch.randint(0, cfg.vocab_size, (1, 2048),
                           generator=model.generator(31), device="cuda")
    with torch.inference_mode():
        model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_count()
        with _Slots() as slots:
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            dropped = slots.dropped_share()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"15d: arctic-480b at full width, 1 layer ({n_params} bf16 "
          f"parameters; peak {init_peak} bytes while drawing them): a "
          f"prefill of [1, 2048] in {prefill_s!r} s, peak device memory "
          f"{peak} bytes, flash_attention launches "
          f"{ops.launch_count('flash_attention')}, capacities "
          f"{sorted(slots.capacities)}, pairs dropped {dropped!r}")
    if (ops.launch_count("flash_attention") != 1
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError("15d: launches or logits")
    del params, logits, model
    torch.cuda.empty_cache()
    return {"prefill_s": prefill_s, "peak_bytes": peak}


def check_group7_flash(ops, ref):
    """15e's first step: ``flash_attention`` against its plain version at
    ``llava-next-34b``'s prefill shape, q ``[224, 1600, 128]`` bf16, k, v
    ``[32, 1600, 128]``, causal, group 7; a second launch equal bit for
    bit; timed beside its bound and two library calls: the causal one
    (``is_causal=True`` on k and v expanded to the 224 query heads) and
    the one with a boolean mask."""
    bh, sq, skv, hd, causal, window, group = GROUP7_FA
    gen = torch.Generator(device="cuda").manual_seed(40)
    q = torch.randn((bh, sq, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((bh // group, skv, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
            for _ in range(2))
    ops.reset_launch_count()
    out = ops.flash_attention(q, k, v, causal=causal, group=group)
    want = ref.flash_attention_ref(q, k, v, causal=causal, group=group)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    rtol, atol = FA_TOL[torch.bfloat16]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)
    again = ops.flash_attention(q, k, v, causal=causal, group=group)
    if not torch.equal(out, again):
        raise AssertionError("15e: two group-7 launches differ")
    ms = _time_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                              group=group), reps=10)
    plain_ms = _time_ms(lambda: ref.flash_attention_ref(
        q, k, v, causal=causal, group=group), reps=3)
    (bound_ms, bound_by), pairs = _flash_bound(q, k, causal, window, group)
    mask_ms = _sdpa_ms(q, k, v, causal, window, group)
    library_ms = _sdpa_causal_ms(q, k, v, group)
    print(f"15e: flash_attention at q [{bh}, {sq}, {hd}] bf16, k, v "
          f"[{bh // group}, {skv}, {hd}], causal, group {group}: max_abs_err "
          f"{err!r} (rtol {rtol}, atol {atol}), a second launch equal bit "
          f"for bit; kernel {ms!r} ms, plain {plain_ms!r} ms, bound "
          f"{bound_ms!r} ms ({bound_by}), scaled_dot_product_attention with "
          f"is_causal=True on k, v expanded {library_ms!r} ms (kernel / "
          f"library {ms / library_ms!r}), with a boolean mask {mask_ms!r} "
          f"ms")
    del q, k, v, out, want, again
    torch.cuda.empty_cache()
    return {"q": [bh, sq, hd], "group": group, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_mask_ms": mask_ms}


def serve_llava(ops):
    """15e: ``llava-next-34b`` at full width (d_model 7168, 56 heads of 128
    on 8, d_ff 20,480, vocab 64,000, patch embeddings of 1,024 projected
    by ``frontend.proj``) cut to 8 layers, bf16 from a seed, through
    ``ServingEngine.generate``: batch 4, 576 patch embeddings and 1,024
    tokens, 32 new tokens; the first decode step at position 1,600."""
    from repro_torch.config import ShapeConfig
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine

    cfg = _p15_config("llava-next-34b", num_layers=LLAVA_LAYERS)
    model = Model(cfg, device="cuda")
    params = model.init(model.generator(41))
    n = cfg.num_patches + LLAVA_TEXT
    batch = model.make_inputs(ShapeConfig("serve", "prefill", n, MOE_BATCH),
                              model.generator(42))
    engine = ServingEngine(model, params, max_new_tokens=32)
    engine.generate(batch, new_tokens=2)
    calls, positions = [], []
    launch, step = ops.flash_attention, model.decode_step

    def recorded(q, k, v, **kwargs):
        calls.append((tuple(q.shape), tuple(k.shape), kwargs.get("group")))
        return launch(q, k, v, **kwargs)

    def stepped(params_, tokens, caches, pos):
        positions.append(pos)
        return step(params_, tokens, caches, pos)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    ops.flash_attention, model.decode_step = recorded, stepped
    try:
        out = engine.generate(batch, new_tokens=32)
    finally:
        ops.flash_attention = launch
        del model.decode_step
    launches = ops.launch_count("flash_attention")
    peak = torch.cuda.max_memory_allocated()
    want = ((MOE_BATCH * cfg.num_heads, n, cfg.head_dim),
            (MOE_BATCH * cfg.num_kv_heads, n, cfg.head_dim),
            cfg.num_heads // cfg.num_kv_heads)
    print(f"15e: serving llava-next-34b at full width, {LLAVA_LAYERS} "
          f"layers, batch {MOE_BATCH}, {cfg.num_patches} patches + "
          f"{LLAVA_TEXT} tokens, 32 new tokens: prefill_seconds "
          f"{out.prefill_seconds!r}, decode_seconds {out.decode_seconds!r}, "
          f"tokens_per_second {out.tokens_per_second!r}, peak device memory "
          f"{peak} bytes; flash_attention launches {launches} (q, k, group "
          f"{calls[0] if calls else None}); decode positions "
          f"{positions[0] if positions else None}..{positions[-1] if positions else None}")
    if (launches != LLAVA_LAYERS or any(c != want for c in calls)
            or positions[0] != n or out.tokens.shape != (MOE_BATCH, 32)):
        raise AssertionError(f"15e: launches {launches}, calls {calls[:1]}, "
                             f"positions {positions[:1]}")
    del params, engine, model
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": out.prefill_seconds,
            "decode_s": out.decode_seconds, "peak_bytes": peak}


def train_moe_cut(ops):
    """15f: ``deepseek-moe-16b`` at full width cut to 4 layers (the dense
    first layer and 3 MoE layers), bf16 parameters, fp32 moments, remat
    full: one ``train()`` step at batch 1 × 4,096 (four segments); then
    from the same state the loss, its parts and every leaf's gradient."""
    from repro_torch.models import Model
    from repro_torch.train import loop, microbatch
    from repro_torch.tree import tree_leaves_with_path

    cfg = _p15_config("deepseek-moe-16b", num_layers=4)
    seq = 4096
    run = _train_run(cfg, 1, seq, learning_rate=1e-3, warmup_steps=1,
                     total_steps=5)
    n_mb = run.microbatches()
    want = _attention_launches(cfg, n_mb)
    model = Model(cfg, device="cuda")
    stamps = []

    def timed(batches):
        for b in batches:
            stamps.append(time.perf_counter())
            yield b

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_count()
    report = loop.train(model, run, timed(_train_batches(cfg, 1, seq,
                                                         seed=5)), 2,
                        log_every=100)
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = {k: ops.launch_count(k) for k in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip(stamps, stamps[1:] + [end])]
    print(f"15f: deepseek-moe-16b at full width, 4 layers ({cfg.param_count()}"
          f" parameters), batch 1 x {seq} ({seq // cfg.moe_seq_chunk} "
          f"segments), {n_mb} microbatch: two train() steps, step seconds "
          f"{step_s}, tokens/s {[seq / t for t in step_s]}, losses "
          f"{report.losses}, peak device memory {peak} bytes; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} (a step "
          f"{json.dumps(want)}) ({_card_line()})")
    if {k: launches[k] for k in want} != {k: 2 * n for k, n in want.items()} \
            or any(v for k, v in launches.items() if k not in want) \
            or not all(np.isfinite(report.losses)):
        raise AssertionError(f"15f: launches {launches}, not 2 x {want}, or "
                             f"losses {report.losses}")
    state = loop.init_state(model, run)
    batch = loop.to_device(next(_train_batches(cfg, 1, seq, seed=6)),
                           "cuda")
    loss, metrics, grads = microbatch.accumulate_gradients(
        model.loss, state.params, batch, n_mb)
    ce, aux = float(metrics["ce"]), float(metrics["aux"])
    norms = {"/".join(map(str, p)): float(torch.linalg.vector_norm(
        g.float())) for p, g in tree_leaves_with_path(grads)}
    bad = [k for k, v in norms.items() if not (np.isfinite(v) and v > 0)]
    print(f"15f: loss {float(loss)!r} = ce {ce!r} + {cfg.router_aux_weight} x "
          f"aux {aux!r}; {len(norms) - len(bad)} of {len(norms)} leaves with "
          f"a finite non-zero gradient (router norms "
          f"{[v for k, v in sorted(norms.items()) if k.endswith('router')]})")
    if (bad or not (np.isfinite(aux) and aux > 0)
            or abs(float(loss) - (ce + cfg.router_aux_weight * aux))
            > 1e-5 * abs(float(loss))):
        raise AssertionError(f"15f: loss {float(loss)!r}, ce {ce!r}, aux "
                             f"{aux!r}, zero gradients {bad}")
    del state, grads, model
    torch.cuda.empty_cache()
    return {"launches": {k: v // 2 for k, v in launches.items()},
            "step_s": step_s, "peak_bytes": peak}


def train_moe_card_against_cpu():
    """15f, second part: ``deepseek-moe-16b`` at full width cut to 2 layers
    (the dense layer and one MoE layer), fp32 with TF32 off, batch 1 ×
    1,024 (T = 1,024, capacity 120): the loss on the card within 1e-4 of
    the CPU's, each gradient leaf within 1e-4 of its largest entry, except
    the experts that a token routed otherwise on the two sides touches
    (printed)."""
    from repro_torch.models import Model, moe
    from repro_torch.train import loop, microbatch
    from repro_torch.tree import tree_leaves_with_path, tree_map

    cfg = _p15_config("deepseek-moe-16b", num_layers=2, dtype="float32")
    run = _train_run(cfg, 1, 1024, learning_rate=1e-3, warmup_steps=1,
                     total_steps=5)
    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(cpu_model.generator(8))
    host = next(_train_batches(cfg, 1, 1024, seed=7))
    route = moe._route
    results = {}
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for where, model in (("cpu", cpu_model),
                             ("cuda", Model(cfg, device="cuda"))):
            routed = []

            def recorded(cfg_, params, xf):
                out = route(cfg_, params, xf)
                routed.append(out[0].detach().cpu())
                return out

            params = tree_map(lambda t: t.to(where), cpu_params)
            moe._route = recorded
            try:
                loss, metrics, grads = microbatch.accumulate_gradients(
                    model.loss, params, loop.to_device(host, where),
                    run.microbatches())
            finally:
                moe._route = route
            results[where] = (float(loss), float(metrics["aux"]),
                              tree_map(lambda t: t.cpu(), grads), routed)
            del params, grads
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    (l_cpu, a_cpu, g_cpu, r_cpu), (l_card, a_card, g_card, r_card) = (
        results["cpu"], results["cuda"])
    # remat full routes each MoE layer twice (forward, recomputation)
    touched = set()
    for a, b in zip(r_cpu, r_card):
        differ = (a != b).any(-1)
        touched |= set(a[differ].flatten().tolist())
        touched |= set(b[differ].flatten().tolist())
    worst, where_worst = 0.0, None
    for (path, gc), (_, gk) in zip(tree_leaves_with_path(g_cpu),
                                   tree_leaves_with_path(g_card)):
        scale = float(gc.abs().max())
        diff = (gk - gc).abs()
        if path[-1] in ("we_i", "we_g", "we_d") and touched:
            keep = torch.ones(diff.shape[0], dtype=torch.bool)
            keep[sorted(touched)] = False
            diff = diff[keep]
        rel = float(diff.max()) / scale if scale else float("inf")
        if rel > worst:
            worst, where_worst = rel, "/".join(map(str, path))
    print(f"15f: deepseek-moe-16b at full width, 2 layers, fp32, batch 1 x "
          f"1024: loss {l_card!r} on the card, {l_cpu!r} on the CPU "
          f"(relative {abs(l_card - l_cpu) / abs(l_cpu)!r}), aux {a_card!r} "
          f"/ {a_cpu!r}; routing flips touch experts {sorted(touched)}; "
          f"gradients within {worst!r} of each leaf's largest (worst "
          f"{where_worst}; bound {TRAIN_TOL})")
    if abs(l_card - l_cpu) > TRAIN_TOL * abs(l_cpu) or worst > TRAIN_TOL:
        raise AssertionError("15f: the card's loss or gradients part from "
                             "the CPU's")


def moe_decode_invariant():
    """15g: decode ≡ prefill for ``deepseek-moe-16b`` at full width cut to
    4 layers, fp32 with TF32 off, a capacity factor of 64 (the expert
    count: C ≥ T · k, so no pair drops in either prefill), batch 2, P =
    300."""
    from repro_torch.models import Model, moe
    from repro_torch.serving import grow_caches

    cfg = _p15_config("deepseek-moe-16b", num_layers=4, dtype="float32",
                      capacity_factor=64.0)
    if moe.capacity(cfg, 2 * 301) < 2 * 301 * cfg.moe_top_k:
        raise AssertionError("15g: the capacity factor leaves a drop")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = Model(cfg, device="cuda")
        gen = model.generator(50)
        params = model.init(gen)
        tokens = torch.randint(0, cfg.vocab_size, (2, 301), generator=gen,
                               device="cuda")
        with torch.inference_mode(), _Slots() as slots:
            _, caches = model.prefill(params, {"tokens": tokens[:, :300]})
            caches = model.prefill_to_decode(grow_caches(caches, 301))
            stepped, _ = model.decode_step(params, tokens[:, 300:], caches,
                                           300)
            whole, _ = model.prefill(params, {"tokens": tokens})
            dropped = slots.dropped_share()
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    err = float((stepped - whole).abs().max())
    print(f"15g: deepseek-moe-16b decode after prefill(P) vs prefill(P ++ "
          f"[x]) at full width, 4 layers, fp32, P=300, capacity factor 64 "
          f"(pairs dropped {dropped!r}): max_abs_err {err!r} on logits up "
          f"to {float(whole.abs().max())!r} (tolerance {INVARIANT_TOL})")
    if dropped or not bool(torch.isfinite(whole).all()):
        raise AssertionError("15g: pairs dropped or logits not finite")
    torch.testing.assert_close(stepped, whole, rtol=INVARIANT_TOL,
                               atol=INVARIANT_TOL)
    del params, caches, model
    torch.cuda.empty_cache()


def moe_and_patch_on_the_card(ops, ref):
    """Phase 15: 15a–15g."""
    out = {}
    t0 = time.perf_counter()
    out["moe"] = serve_moe_whole(ops)
    print(f"15a-b: {time.perf_counter() - t0!r} s")
    for name, step in (("layer", moe_layer_card_against_cpu),
                       ("arctic", lambda: arctic_one_layer(ops)),
                       ("group7", lambda: check_group7_flash(ops, ref)),
                       ("llava", lambda: serve_llava(ops)),
                       ("train", lambda: train_moe_cut(ops)),
                       ("train_cpu", train_moe_card_against_cpu),
                       ("invariant", moe_decode_invariant)):
        t0 = time.perf_counter()
        out[name] = step()
        torch.cuda.empty_cache()
        print(f"phase 15 {name}: {time.perf_counter() - t0!r} s")
    return out


def main() -> None:
    _require_card()
    print(_card_line())
    kind = torch.cuda.get_device_name(0)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch import prng
    from repro_torch.core import subsample as ss
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     rglru_scan, rwkv6_scan,
                                     subsample_gather, subsample_grid)
    from repro_torch.platform import MOMENTS, Platform
    from repro_torch.platform import compute as pc

    libraries = (subsample_gather.LIBRARY, subsample_gather.GATHER_LIBRARY,
                 rwkv6_scan.LIBRARY, rglru_scan.LIBRARY,
                 flash_attention.LIBRARY, subsample_grid.LIBRARY,
                 flash_attention_bwd.LIBRARY)

    # phase 2 — build, one nvcc for each source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(lib.load) for lib in libraries]:
            fut.result()
    print(f"kernel libraries ready in {time.perf_counter() - t0!r} s")
    for lib in libraries:
        info = lib.info
        built = ("built before, its log read back" if info["seconds"] is None
                 else f"nvcc {info['seconds']!r} s")
        print(f"  {lib.source.name}: {built}, {info['path']}")
        for line in info["log"].splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print("    ptxas:", line.strip())
    check_tensor_core_bwd_spills(flash_attention_bwd.LIBRARY.info["log"])

    # phase 3 — each kernel against its plain version
    timing = check_kernel(ops, ref, prng, subsample_gather)
    rw_timing = check_rwkv6_kernel(ops, ref, rwkv6_scan)
    rg_timing = check_rglru_kernel(ops, ref)
    fa_timing = check_flash_kernel(ops, ref)
    fab_timing = check_flash_bwd_kernel(ops, ref)
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
             "warm_ups": warm_ups, "n_cols": n_cols, "wall": wall,
             "dispatches": wave.device_dispatches,
             "setup": sum(wave.phases.get(p, 0.0)
                          for p in ("plan", "distribute", "compile"))}
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

    # phase 11 — the multi-tenant service on the same datasets
    t0 = time.perf_counter()
    svc_launches = service_on_the_card(ops, prng, ss, samples, months, eaglet,
                                       step4, waved)
    print(f"phase 11: {time.perf_counter() - t0!r} s")

    # phase 12 — sharded waves and the elastic pool, on the same datasets
    t0 = time.perf_counter()
    sharded_launches = sharded_waves_on_the_card(
        ops, prng, ss, Platform, samples, months, eaglet, step4, waved)
    print(f"phase 12: {time.perf_counter() - t0!r} s")
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

    # phase 13 — serving deepseek-7b at full width (full attention, int8
    # KV cache), then internlm2-20b's group of 6, deepseek-7b's decode ≡
    # prefill and the int8 bound at cut depth
    t0 = time.perf_counter()
    dense_launches = serve_dense(ops)
    dense_fast_steps(ops)
    print(f"phase 13: {time.perf_counter() - t0!r} s")

    # phase 14 — training: musicgen-medium whole, the card against the
    # CPU, deepseek-7b cut in depth, checkpoint and resume
    t0 = time.perf_counter()
    trained = train_on_the_card(ops, ref)
    print(f"phase 14: {time.perf_counter() - t0!r} s")

    # phase 15 — the mixture-of-experts models and the patch frontend:
    # deepseek-moe-16b whole, one MoE layer card against CPU, arctic-480b
    # one layer, llava-next-34b cut in depth (group 7), MoE training and
    # the MoE decode ≡ prefill
    t0 = time.perf_counter()
    p15 = moe_and_patch_on_the_card(ops, ref)
    print(f"phase 15: {time.perf_counter() - t0!r} s")

    print(json.dumps({"kernels": [{
        "name": "subsample_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/subsample_stats.cu",
        "replaces": "src/repro/kernels/subsample_gather.py:138",
        "launches": launches, "library_ms": None,
        "service_launches": svc_launches["subsample_stats"],
        "sharded_launches": sharded_launches["subsample_stats"], **timing}, {
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
        "launches": dense_launches["flash_attention"],
        "main_path": "deepseek-7b prefill (phase 13), q [128, 4064, 128] "
                     "bf16, causal, window 0, group 1",
        "local_launches": rg_launches["flash_attention"],
        "train_launches": trained["launches"]["flash_attention"],
        "forward_with_lse_ms": fab_timing["deepseek_7b"]["forward_lse_ms"],
        "moe_launches": p15["moe"]["launches"]["flash_attention"],
        "moe_main_path": "deepseek-moe-16b prefill (phase 15a), q [64, "
                         "3072, 128] bf16, causal, group 1",
        "patch_launches": p15["llava"]["launches"],
        "group7": p15["group7"],
        **fa_timing}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:112",
        "replaces_note": "no TPU kernel: the reference trains through "
                         "XLA's gradient of the jnp _attend_block there; "
                         "src/repro/kernels/flash_attention.py:77 has no "
                         "backward",
        "launches": trained["launches"]["flash_attention_bwd"],
        "main_path": "musicgen-medium training (phase 14a), q [48, 2048, "
                     "64] bf16, causal, group 1, 5 steps",
        "moe_train_launches": p15["train"]["launches"]["flash_attention_bwd"],
        **fab_timing}, {
        "name": "subsample_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/subsample_gather.cu",
        "replaces": "src/repro/kernels/subsample_gather.py:64",
        "launches": sg_launches, "library_ms": None, **sg_timing}, {
        "name": "subsample_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/subsample_grid.cu",
        "replaces": "src/repro/core/subsample.py:53",
        "launches": grid_launches, "library_ms": None,
        "service_launches": svc_launches["subsample_grid"],
        "sharded_launches": sharded_launches["subsample_grid"],
        **grid_timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
