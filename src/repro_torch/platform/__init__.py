"""``repro_torch.platform`` — the end-to-end tiny-task platform driver,
ported to PyTorch.

Composes kneepoint task sizing → two-phase dynamic scheduler → streaming
reduce behind :class:`Platform`, with threaded (real wall time) and
simulated (virtual-time) execution backends, and runs each map task of the
``moments`` workload through the hand-written CUDA ``subsample_stats``
kernel on ``PlatformSpec.device``.  The multi-tenant service, the
datastore, faults, checkpoints and sharded waves come in later slices.
"""

from repro_torch.core.blockcache import CacheOptions
from repro_torch.platform import compute
from repro_torch.platform.compute import MOMENTS, MomentsSpec
from repro_torch.platform.driver import (
    ApproxOptions,
    FaultOptions,
    JobReport,
    Platform,
    PlatformSpec,
    ScheduleOptions,
    WaveOptions,
)
from repro_torch.platform.monitor import MonitorOptions
from repro_torch.platform.telemetry import TelemetryConfig

__all__ = [
    "Platform",
    "PlatformSpec",
    "JobReport",
    "MomentsSpec",
    "MOMENTS",
    "compute",
    "WaveOptions",
    "ScheduleOptions",
    "ApproxOptions",
    "FaultOptions",
    "CacheOptions",
    "MonitorOptions",
    "TelemetryConfig",
]
