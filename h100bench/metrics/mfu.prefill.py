"""Serving engine, prefill: a prefill's model FLOPs (the configuration's
count file) over the mean prefill phase of the window's calls outside
the profiler (``GenerationResult.prefill_seconds``), as a share of the
card's bf16 peak."""

from h100bench import peaks


def read(ctx):
    times = ctx.get("prefill_s") or []
    if not times:
        return None
    counts = ctx["bench"].counts(ctx["config"]["architecture"])
    flops = counts.prefill_flops(ctx["config"], ctx["mix"])
    return 100.0 * flops / (sum(times) / len(times)) / peaks.PEAK_FLOPS_BF16
