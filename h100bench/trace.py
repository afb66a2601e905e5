"""Reading a profiled part of a run's window.

The harness starts ``torch.profiler`` on a bounded, steady part of the
window (some training steps, one serving call), marks its two ends with
:func:`mark`, and names what the host was doing with ``record_function``
spans of its own (``h100bench.<what>``).  :func:`read` keeps, in memory,
the device operations, the marked window and those spans; nothing is
written to disk.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

MARK = "h100bench.mark"
SPAN = "h100bench."


def start(device: str):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def mark() -> None:
    with torch.profiler.record_function(MARK):
        pass


def span(what: str):
    """A host span the idle gaps are named by (a no-op when no profiler
    runs, but for its small cost)."""
    return torch.profiler.record_function(SPAN + what)


@contextlib.contextmanager
def window(device: str):
    """Profile the body, marked at both ends; yields a dict that holds the
    reading (:func:`read`) once the body has closed."""
    got: Dict = {}
    if device == "cuda":
        torch.cuda.synchronize()
    prof = start(device)
    mark()
    try:
        yield got
    finally:
        if device == "cuda":
            torch.cuda.synchronize()
        mark()
        prof.stop()
        got.update(read(prof))


def read(prof) -> Dict:
    """``ops`` the device operations ``(start, end, name)`` in µs, sorted;
    ``window`` ``(start, end)`` between the first and last mark; ``spans``
    each ``h100bench.<what>`` host span by ``what``."""
    ops: List[Tuple[float, float, str]] = []
    marks: List[Tuple[float, float]] = []
    spans: Dict[str, List[Tuple[float, float]]] = {}
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(SPAN):
                ops.append((r[0], r[1], e.name))
        elif e.name == MARK:
            marks.append(r)
        elif e.name.startswith(SPAN):
            spans.setdefault(e.name[len(SPAN):], []).append(r)
    ops.sort()
    lo = min(m[0] for m in marks)
    hi = max(m[1] for m in marks)
    return {"ops": ops, "window": (lo, hi), "spans": spans}


def merged(ops, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the operations' spans, clipped to ``[lo, hi]``."""
    out: List[List[float]] = []
    for s, e, _ in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(a, b) for a, b in out]


def busy_us(ops, lo: float, hi: float) -> float:
    return sum(b - a for a, b in merged(ops, lo, hi))


def idle_gaps(ops, lo: float, hi: float,
              spans: Dict[str, List[Tuple[float, float]]],
              default: str) -> List[Tuple[str, float]]:
    """Every stretch of ``[lo, hi]`` with no device operation, in µs,
    named by the host span that overlaps it most (``default`` where none
    does), longest first."""
    busy = merged(ops, lo, hi)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    named = []
    for a, b in gaps:
        best, name = 0.0, default
        for what, rs in spans.items():
            cover = sum(max(0.0, min(b, e) - max(a, s)) for s, e in rs)
            if cover > best:
                best, name = cover, what
        named.append((name, b - a))
    named.sort(key=lambda g: -g[1])
    return named


def op_seconds(ops, lo: float, hi: float) -> Dict[str, float]:
    """Device seconds by operation name inside ``[lo, hi]``."""
    out: Dict[str, float] = {}
    for s, e, name in ops:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def breakdown(reading: Dict, default: str) -> Dict[str, list]:
    """The ten device operations that took most time and the ten longest
    idle gaps of the marked window, in seconds, for the result line."""
    lo, hi = reading["window"]
    by_name = op_seconds(reading["ops"], lo, hi)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = idle_gaps(reading["ops"], lo, hi, reading["spans"], default)[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}


def device_busy(reading: Dict) -> Tuple[float, float]:
    """(busy seconds, window seconds) of the marked window."""
    lo, hi = reading["window"]
    return busy_us(reading["ops"], lo, hi) / 1e6, (hi - lo) / 1e6
