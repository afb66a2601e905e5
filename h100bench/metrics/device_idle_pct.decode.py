"""Device: the share of a call's decode phase in which no operation ran on
the card.  The operations are the profiled call's (from the end of its
prefill phase on the host clock to the call's end), the phase's length
the mean decode phase of the window's calls outside the profiler.
Decode is paced in part by the host's launches, and the profiler's own
cost a launch lengthens the profiled call's decode (PERF.md, section 5),
while the device's work a call is the same in every call."""

from h100bench import trace


def read(ctx):
    t = ctx.get("trace") or {}
    steps = ctx.get("decode_step_s") or []
    if not t.get("ops") or "phases" not in t or not steps:
        return None
    lo, hi = t["phases"]["decode"]
    phase_us = 1e6 * sum(steps) / len(steps) * ctx["mix"]["new_tokens"]
    return 100.0 * (1.0 - trace.busy_us(t["ops"], lo, hi) / phase_us)
