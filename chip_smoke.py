"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and nvcc
(sm_90a).  It imports neither JAX nor the reference package ``repro``.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the ``subsample_stats`` CUDA kernel from ``src/repro_torch``.
3. Holds the kernel against its plain PyTorch version on the card, at the
   main path's shape and at shapes that take its other branches, and
   times kernel, plain version and the byte bound.
4. Runs the main path at real size: the full Netflix Prize catalogue
   (17,770 movies, its published mean of 5,654 ratings per movie) through
   ``Platform.run`` with the ``moments`` workload, BTS sizing with a
   64-movie task block, threaded backend, waves of 16.  The launch count
   is zeroed just before and read just after this run.  Then it times
   each stage of one wave, and the per-task path's block build and
   upload, on the host; and reruns the job traced (telemetry and
   ``torch.profiler``) for each wave's host time inside the job and the
   device's busy share.
5. Reruns that job per task (``wave="off"``) and asserts the result is
   bit-identical; runs a 512-movie job on the threaded and the simulated
   backend and asserts they are bit-identical and agree with a float64
   numpy reference computed from the same draws.

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

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-4        # kernel vs plain: same rows, fp32 sums


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


def _bound(data: torch.Tensor, idx: torch.Tensor):
    """Least time for this call: every gathered row read once (the rows
    this run's indices touch), every index read once, the stats written
    once, against 3 fp32 operations per gathered element."""
    b, _, d = data.shape
    t = idx.shape[1]
    rows = sum(int(torch.unique(idx[k]).numel()) for k in range(b))
    nbytes = rows * d * 4 + b * t * 4 + b * 2 * d * 4
    flops = 3.0 * b * t * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(ops, ref, prng):
    """Phase 3: the kernel against its plain version, on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [(16, 64, 65536, 512),    # the main path's wave
             (3, 40, 96, 13),         # T not a multiple of 8
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
        print(f"kernel check B={b} N={n} D={d} T={t}: max_abs_err={err!r} "
              "wave == single launches bitwise")
        if (b, n, d, t) == cases[0]:
            main = (data, idx)
    data, idx = main
    ms = _time_ms(lambda: ops.subsample_stats(data, idx))
    plain_ms = _time_ms(lambda: ref.subsample_stats_ref(data, idx), reps=3)
    bound_ms, bound_by = _bound(data, idx)
    print(f"subsample_stats at [16, 64, 65536] x T=512: kernel {ms!r} ms, "
          f"plain {plain_ms!r} ms, bound {bound_ms!r} ms ({bound_by}); "
          "no single PyTorch call computes this function, so library_ms "
          "is null")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    (``compute._moments_wave``), on an arena of the main path's shape,
    and of the per-task path's block build and upload."""
    from repro_torch.platform import compute as pc

    arena = torch.empty((n_tasks, count, length), device="cuda").normal_()
    rows = np.arange(16, dtype=np.int64)
    seeds = np.arange(16, dtype=np.int32)
    state = {}

    def upload():
        state["rows"] = torch.from_numpy(rows).to("cuda")
        state["seeds"] = torch.from_numpy(seeds).to("cuda")

    def gather():
        state["data"] = arena.index_select(0, state["rows"])

    def draw():
        state["idx"] = prng.randint(prng.PRNGKey(state["seeds"]), (512,), 0,
                                    count)

    def kernel():
        state["stats"] = ops.subsample_stats(state["data"], state["idx"])

    def copy_back():
        state["host"] = state["stats"].cpu().numpy()

    def whole():
        pc._moments_wave(arena, rows.astype(np.int32), seeds, n_idx=512)

    block = np.ones((count, length), np.float32)
    stages = {name: _host_ms(fn) for name, fn in (
        ("slot_upload", upload), ("index_select", gather),
        ("prng_randint", draw), ("kernel", kernel),
        ("stats_to_host", copy_back), ("whole_wave", whole),
        ("per_task_block_build", build_block),
        ("per_task_block_upload",
         lambda: torch.from_numpy(block).to("cuda")))}
    print("wave anatomy (host ms per stage, 16-task wave of [64, 65536] "
          "blocks, 512 draws a task): " + json.dumps(stages))
    del arena, state


def traced_wave_run(Platform, spec, samples, months, workload):
    """A separate traced run of the main path (telemetry on, under
    ``torch.profiler``): the host seconds of each wave inside the job,
    and the device's busy share over the execute phase, taken as the span
    from the end of the warm-up wave's stats copy (the first device→host
    copy) to the end of the last one."""
    from torch.profiler import ProfilerActivity, profile

    plat = Platform(dataclasses.replace(spec, telemetry=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = plat.run(samples, months, workload)
    wave_s = sorted(e.fields["seconds"]
                    for e in plat.telemetry.events("wave_dispatched"))
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    d2h = [end for _, end, name in dev if "DtoH" in name]
    lo, hi = d2h[0], d2h[-1]
    busy, cur_start, cur_end = 0.0, None, None
    by_kind = {"subsample_stats": 0.0, "memcpy": 0.0, "other": 0.0}
    for start, end, name in dev:
        if start < lo or end > hi:
            continue
        kind = ("subsample_stats" if "subsample_stats" in name
                else "memcpy" if "Memcpy" in name else "other")
        by_kind[kind] += (end - start) / 1e3
        if cur_end is None or start > cur_end:
            busy += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += 0.0 if cur_end is None else cur_end - cur_start
    window_ms = (hi - lo) / 1e3
    print(f"traced run: makespan {rep.makespan!r} s, {len(wave_s)} waves, "
          f"host seconds per wave median {wave_s[len(wave_s) // 2]!r} max "
          f"{wave_s[-1]!r}; execute window {window_ms!r} ms, device busy "
          f"{busy / 1e3!r} ms (share {busy / 1e3 / window_ms!r}), device "
          f"ms by kind {json.dumps(by_kind)}")


def _netflix(n_movies: int):
    from repro_torch.data import NetflixSpec, netflix_dataset

    return netflix_dataset(NetflixSpec(n_movies=n_movies, mean_ratings=5654))


def _spec(samples, *, wave="on", backend="threaded", device="cuda"):
    from repro_torch.platform import PlatformSpec, WaveOptions

    mean_bytes = float(np.mean([a.nbytes for a in samples.values()]))
    return PlatformSpec(platform="BTS", n_workers=2, backend=backend,
                        waves=WaveOptions(wave=wave, max_wave=16),
                        knee_bytes=64 * mean_bytes, device=device)


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


def main() -> None:
    _require_card()
    print(_card_line())
    kind = torch.cuda.get_device_name(0)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch import prng
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import subsample_gather as sg
    from repro_torch.platform import MOMENTS, Platform
    from repro_torch.platform import compute as pc

    # phase 2 — build
    t0 = time.perf_counter()
    sg.library()
    print(f"kernel library ready in {time.perf_counter() - t0!r} s "
          f"(nvcc {sg.build_info['seconds']!r} s): {sg.build_info['path']}")
    for line in sg.build_info["log"].splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print("  ptxas:", line.strip())

    # phase 3 — kernel against its plain version
    timing = check_kernel(ops, ref, prng)

    # phase 4 — the main path at real size
    t0 = time.perf_counter()
    samples, months = _netflix(17770)
    n_ratings = sum(a.shape[0] for a in samples.values())
    longest = max(a.shape[0] for a in samples.values())
    print(f"netflix: 17770 movies, {n_ratings} ratings, longest "
          f"{longest}, {n_ratings * 4} rating bytes, made in "
          f"{time.perf_counter() - t0!r} s")
    ops.reset_launch_count()
    t0 = time.perf_counter()
    wave = Platform(_spec(samples)).run(samples, months, MOMENTS)
    wall = time.perf_counter() - t0
    launches = ops.launch_count()
    n_cols = int(np.asarray(wave.result["mean"]).shape[0])
    print(f"main path: {wave.n_tasks} tasks, makespan {wave.makespan!r} s, "
          f"run() wall {wall!r} s, phases {wave.phases}, "
          f"device_dispatches {wave.device_dispatches}, wave_sizes "
          f"{wave.wave_sizes}, arena {wave.bytes_uploaded!r} bytes, "
          f"kernel launches {launches}, D {n_cols}")
    if launches < 1:
        raise AssertionError("the main path launched no subsample_stats "
                             "kernel")
    _check_result(wave, n_cols)
    ids = sorted(samples)
    wave_anatomy(ops, prng, wave.n_tasks, 64, n_cols,
                 lambda: pc.build_block(samples, months, ids, range(64), 64,
                                        longest))
    traced_wave_run(Platform, _spec(samples), samples, months, MOMENTS)

    # phase 5 — invariants on the card
    t0 = time.perf_counter()
    per = Platform(_spec(samples, wave="off")).run(samples, months, MOMENTS)
    _assert_bitwise(wave.result, per.result, "wave vs per-task")
    print(f"per-task run: {per.n_tasks} tasks, makespan {per.makespan!r} s, "
          f"phases {per.phases}, device_dispatches {per.device_dispatches}; "
          f"bit-identical to the wave run ({time.perf_counter() - t0!r} s)")
    del samples, months, wave, per

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

    print(json.dumps({"kernels": [{
        "name": "subsample_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/subsample_stats.cu",
        "replaces": "src/repro/kernels/subsample_gather.py:138",
        "launches": launches, "library_ms": None, **timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
