"""Named ranges of the port's host work, for a running ``torch.profiler``.

``with span("train.step"):`` records a range named ``repro_torch.train.step``
on the calling thread while a profiler runs, and is a shared null context
otherwise: a read of the profiler's flag is all it costs then.  The range is
a function-scope one, recorded on the host only (no user annotation, which
the CUDA profiler would also return as a device event over its kernels): it
nests like any operator, and its ``device_time_total`` counts the kernels
launched under it on its thread.  There is no switch, no state and no file:
whoever runs the profiler reads the ranges from its events.

The module imports nothing of torch, so that the packages that use it (the
control plane's prefetch) load no torch either: where torch's profiler
module is not loaded, no profiler runs.
"""

from __future__ import annotations

import contextlib
import sys

PREFIX = "repro_torch."

_NULL = contextlib.nullcontext()


def span(name: str):
    """A range named ``repro_torch.<name>`` while a profiler runs, else a
    shared null context."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return _NULL
    from torch._C._profiler import _RecordFunctionFast
    return _RecordFunctionFast(PREFIX + name)
