"""Input pipeline: host milliseconds a window step spends inside the
pipeline's ``next()`` (the benchmark's wrapper around the iterator that
``train()`` reads): the time a step waits for its batch."""


def read(ctx):
    waits = ctx.get("pipeline_s") or []
    return 1e3 * sum(waits) / len(waits) if waits else None
