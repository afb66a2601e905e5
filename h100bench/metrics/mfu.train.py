"""Training step: model FLOPs of a step (the configuration's count file)
over the mean host time of the window's steps outside the profiler, as a
share of the card's bf16 peak."""

from h100bench import peaks


def read(ctx):
    steps = ctx.get("step_s") or []
    if not steps:
        return None
    counts = ctx["bench"].counts(ctx["config"]["architecture"])
    flops = counts.train_flops(ctx["config"], ctx["mix"])
    return 100.0 * flops / (sum(steps) / len(steps)) / peaks.PEAK_FLOPS_BF16
