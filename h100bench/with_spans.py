"""Run one cell once, traced, with the port's spans read, and print what
they give.

    python3 h100bench/with_spans.py --workload <name> --seed <n> --seconds <s>

from the root of a checkout, on a machine with the card.  The run is the
cell's ``--trace 1`` run (``run.py``) with ``trace.read``'s reading widened
by ``program.read`` and its idle gaps named by ``program.breakdown``.  The
last line of standard output is one JSON object:

  correct       as the cell's result line decides it
  metrics       the cell's per-layer metrics and ``program.READERS``
  profiled_s    the profiled part's host seconds: the traced call's
                ``prefill`` and ``decode`` phases (serving) or the profiled
                ``steps`` (training)
  busy_s        the device's busy seconds in the same parts
  idle_s        the device's idle time in the decode phase (serving) or
                the profiled steps (training) by the innermost program span
                that covers most of each gap (``-`` where none does):
                [seconds, gaps]
  spans         each program span on the main thread: [count, host s,
                device s of the kernels launched under it]
  waits         each blocking runtime call on the main thread: [count, s]
  runtime       each runtime call on the main thread in the decode phase or
                the profiled steps: [count, s]
  program_ops   the device operations named after a program span (0: the
                spans stay on the host)
  breakdown     the cell's breakdown, its gaps named by the program's spans
  device        the card's name

On a checkout whose program records no spans, the program's entries are
empty and the breakdown is the cell's own.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _runtime(prof) -> dict:
    """Every host runtime call (``cu...``) as ``(name, start, end,
    thread)``, under ``runtime``."""
    import torch
    return {"runtime": [(e.name, e.time_range.start, e.time_range.end,
                         e.thread) for e in prof.events()
                        if e.device_type != torch.autograd.DeviceType.CUDA
                        and e.name.startswith("cu")]}


@contextlib.contextmanager
def widened_trace():
    """``trace.read`` and ``trace.breakdown`` replaced by the program-span
    reading (and the runtime calls) for the body."""
    from h100bench import program, trace
    read, breakdown = trace.read, trace.breakdown
    trace.read = lambda prof: dict(read(prof), **program.read(prof),
                                   **_runtime(prof))
    trace.breakdown = program.breakdown
    try:
        yield
    finally:
        trace.read, trace.breakdown = read, breakdown


def _sums(rows, parts=()) -> dict:
    """Rows ``(name, start, end, ...)`` summed by name: [count, seconds,
    then each column of ``parts`` in seconds]."""
    out: dict = {}
    for r in rows:
        got = out.setdefault(r[0], [0, 0.0] + [0.0] * len(parts))
        got[0] += 1
        got[1] += (r[2] - r[1]) / 1e6
        for i, p in enumerate(parts):
            got[2 + i] += r[p] / 1e6
    return out


def profile_cell(bench, workload: str, seed: int, seconds: float,
                 device: str, t0: float) -> dict:
    """One traced run of ``workload`` with the program's spans read."""
    from h100bench import core, program, trace

    cell = bench.workload(workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    job = core.Job(bench=bench, config=config, mix=mix,
                   limits=bench.limits(workload), seed=int(seed),
                   seconds=float(seconds), trace=True, device=device, t0=t0)
    with widened_trace():
        try:
            out = bench.driver(mix["kind"]).run(job)
        finally:
            gc.unfreeze()
    ctx = dict(out.layer, config=config, mix=mix, bench=bench)
    metrics = {}
    for m in bench.per_layer(workload):
        value = bench.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = float(value)
    for name, reader in program.READERS.items():
        value = reader(ctx)
        if value is not None:
            metrics[name] = float(value)

    t = out.layer.get("trace") or {}
    parts = dict(t.get("phases") or {"steps": t.get("window")})
    idle_part = parts.get("decode") or parts["steps"]
    idle: dict = {}
    for name, us in program.idle_gaps(dict(t, spans={}), *idle_part, "-"):
        got = idle.setdefault(name, [0.0, 0])
        got[0] += us / 1e6
        got[1] += 1
    lo, hi = idle_part
    runtime = [r for r in program.on_main(t, "runtime")
               if lo <= r[1] and r[2] <= hi]
    return {
        "correct": bool(core.checks_pass(out.checks) and out.failed == 0
                        and out.attempted > 0),
        "metrics": metrics,
        "profiled_s": {k: (hi - lo) / 1e6 for k, (lo, hi) in parts.items()},
        "busy_s": {k: trace.busy_us(t["ops"], lo, hi) / 1e6
                   for k, (lo, hi) in parts.items()},
        "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1][0])),
        "spans": _sums(program.on_main(t, "program"), [4]),
        "waits": _sums(program.on_main(t, "waits")),
        "runtime": _sums(runtime),
        "program_ops": sum(1 for _, _, n in t.get("ops") or ()
                           if n.startswith(program.PREFIX)),
        "breakdown": out.breakdown,
        "device": core._device_kind(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from h100bench import core, run

    run._caches_in_checkout()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    if not torch.cuda.is_available():
        print("h100bench: no CUDA device is available", file=sys.stderr)
        return 3
    line = profile_cell(core.Bench(ROOT), args.workload, args.seed,
                        args.seconds, "cuda", T0)
    found = core.loaded_forbidden()
    if found:
        print(f"h100bench: the run loaded {found}", file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
