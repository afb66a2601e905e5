"""The port's own spans and the host's waits in a profiled reading.

The port names its host work with function-scope profiler ranges,
``repro_torch.<name>`` (``src/repro_torch/spans.py``): recorded on the host
only, so they never enter :func:`h100bench.trace.read`'s device
operations.  :func:`read` takes them from a stopped profiler beside the
host's runtime calls that block on the device, as three keys that widen
``trace.read``'s reading:

  program      each ``repro_torch.*`` range as ``(name, start, end, thread,
               device_us)``, ``name`` without the prefix and ``device_us``
               the profiler's ``device_time_total`` (the kernels launched
               under it on its thread)
  waits        each blocking runtime call as ``(name, start, end, thread)``
  main_thread  the thread of the marks

:func:`breakdown` names an idle gap by the innermost program span on the
main thread that covers most of it; on a reading with no program spans it
gives what :func:`h100bench.trace.breakdown` gives.  ``READERS`` are the
per-layer readings of the spans, each ``read(ctx) -> float | None`` as a
metric's reader (None where the reading holds no program spans).
``with_spans.py`` runs a cell with the reading widened and prints them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from h100bench import trace

PREFIX = "repro_torch."
# the runtime calls with which the host waits for the device (a pageable
# copy to the card and ``.item()`` end in a stream synchronise)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(prof) -> Dict:
    """``program``, ``waits`` and ``main_thread`` of a stopped profiler
    (times in µs, on ``trace.read``'s clock)."""
    program: List[Tuple[str, float, float, int, float]] = []
    waits: List[Tuple[str, float, float, int]] = []
    main: Optional[int] = None
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        r = e.time_range
        if e.name == trace.MARK:
            main = e.thread
        elif e.name.startswith(PREFIX):
            program.append((e.name[len(PREFIX):], r.start, r.end, e.thread,
                            float(e.device_time_total)))
        elif e.name in WAITS:
            waits.append((e.name, r.start, r.end, e.thread))
    program.sort(key=lambda s: (s[1], -s[2]))
    waits.sort(key=lambda w: w[1])
    return {"program": program, "waits": waits, "main_thread": main}


def on_main(reading: Dict, key: str) -> list:
    """The reading's ``program`` or ``waits`` on its main thread (all of
    them where it names none)."""
    main = reading.get("main_thread")
    return [x for x in reading.get(key) or ()
            if main is None or x[3] == main]


def _innermost(program, gaps) -> List[Optional[str]]:
    """For each gap ``(a, b)`` (in time order) the innermost span of the
    nested ``program`` (sorted by start) that covers more than half of
    it, or None.  Such a span holds the gap's midpoint, and the spans that
    hold a point nest, so one sweep keeps them on a stack."""
    out: List[Optional[str]] = []
    stack: list = []
    i = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(program) and program[i][1] <= mid:
            while stack and stack[-1][2] < program[i][1]:
                stack.pop()
            stack.append(program[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = None
        for s in reversed(stack):
            if min(b, s[2]) - max(a, s[1]) > (b - a) / 2:
                name = s[0]
                break
        out.append(name)
    return out


def idle_gaps(reading: Dict, lo: float, hi: float,
              default: str) -> List[Tuple[str, float]]:
    """``trace.idle_gaps``, a gap named by its innermost program span
    (:func:`_innermost`) where one covers most of it."""
    busy = trace.merged(reading["ops"], lo, hi)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    named = []
    for (a, b), inner in zip(gaps, _innermost(on_main(reading, "program"),
                                              gaps)):
        name = inner
        if name is None:
            best, name = 0.0, default
            for what, rs in reading["spans"].items():
                cover = sum(max(0.0, min(b, e) - max(a, s)) for s, e in rs)
                if cover > best:
                    best, name = cover, what
        named.append((name, b - a))
    named.sort(key=lambda g: -g[1])
    return named


def breakdown(reading: Dict, default: str) -> Dict[str, list]:
    """``trace.breakdown`` with the idle gaps named by :func:`idle_gaps`:
    the same to the byte where the reading has no program spans."""
    lo, hi = reading["window"]
    by_name = trace.op_seconds(reading["ops"], lo, hi)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = idle_gaps(reading, lo, hi, default)[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}


def _spans(reading: Dict, name: str) -> list:
    return [s for s in on_main(reading, "program") if s[0] == name]


def _waits_in(reading: Dict, s) -> list:
    return [w for w in on_main(reading, "waits")
            if s[1] <= w[1] and w[2] <= s[2]]


def host_syncs(reading: Dict, name: str) -> Optional[float]:
    """Blocking waits on the main thread a ``name`` span."""
    got = _spans(reading, name)
    if not got:
        return None
    return sum(len(_waits_in(reading, s)) for s in got) / len(got)


def launch_ms(reading: Dict, name: str) -> Optional[float]:
    """Host ms of a ``name`` span less the waits inside it: the time to
    enqueue its work (under the profiler)."""
    got = _spans(reading, name)
    if not got:
        return None
    return sum((s[2] - s[1]) - sum(w[2] - w[1] for w in _waits_in(reading, s))
               for s in got) / len(got) / 1e3


def device_ms(reading: Dict, name: str, per: str) -> Optional[float]:
    """Device ms of the kernels launched under ``name`` spans, a ``per``
    span."""
    n = len(_spans(reading, per))
    if not n:
        return None
    return sum(s[4] for s in _spans(reading, name)) / n / 1e3


def host_ms(reading: Dict, name: str, per: str) -> Optional[float]:
    """Host ms inside ``name`` spans, a ``per`` span."""
    n = len(_spans(reading, per))
    if not n:
        return None
    return sum(s[2] - s[1] for s in _spans(reading, name)) / n / 1e3


def _of(fn, *args):
    return lambda ctx: fn(ctx.get("trace") or {}, *args)


READERS = {
    "host_syncs.decode": _of(host_syncs, "serve.decode_step"),
    "launch_ms.decode": _of(launch_ms, "serve.decode_step"),
    "host_syncs.train": _of(host_syncs, "train.step"),
    "adamw_ms.train": _of(device_ms, "train.optimizer", "train.step"),
    "input_wait_ms.train": _of(host_ms, "pipeline.wait", "train.step"),
}
