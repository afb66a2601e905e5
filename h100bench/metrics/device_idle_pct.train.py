"""Device: the share of the profiled training steps' wall time in which
no operation ran on the card."""

from h100bench import trace


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("ops"):
        return None
    busy, wall = trace.device_busy(t)
    return 100.0 * (1.0 - busy / wall)
