"""Serving engine, decode: the least bytes of a decode step (the
configuration's count file: the weights read once, the int8 cache and its
scales as far as filled) over the mean decode step of the window's calls
outside the profiler, as a share of the card's bandwidth."""

from h100bench import peaks


def read(ctx):
    steps = ctx.get("decode_step_s") or []
    if not steps:
        return None
    counts = ctx["bench"].counts(ctx["config"]["architecture"])
    nbytes = counts.decode_step_bytes(ctx["config"], ctx["mix"])
    return 100.0 * nbytes / (sum(steps) / len(steps)) / peaks.HBM_BYTES_PER_S
