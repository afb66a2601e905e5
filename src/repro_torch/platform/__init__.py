"""``repro_torch.platform`` — the end-to-end tiny-task platform driver,
ported to PyTorch.

Composes kneepoint task sizing → two-phase dynamic scheduler → streaming
reduce behind :class:`Platform`, with threaded (real wall time) and
simulated (virtual-time) execution backends, and runs each map task on
``PlatformSpec.device`` through a hand-written CUDA kernel: the
``moments`` workload through ``subsample_stats``, the paper's EAGLET and
Netflix workloads (``repro_torch.core.subsample``) through
``subsample_grid``.  A job can take a replicated datastore with balanced
scheduling and prefetch (:class:`~repro_torch.core.datastore.ReplicatedDataStore`),
a seeded fault plan (:mod:`repro_torch.platform.faults`),
checkpoint/resume, and sharded waves over a wave mesh
(``mesh_devices``, :mod:`repro_torch.launch.mesh`).  The multi-tenant
service (:class:`PlatformService`, :mod:`repro_torch.platform.service`)
registers datasets once, keeps one device-resident arena a query class
and fuses waves of several jobs into one launch.

This module is the import surface of the reference's ``repro.platform``:
``__all__`` is its curated public API, and the plumbing it re-exports is
re-exported here too (all but ``measure_per_sample_cost``, a calibration
helper nothing in the port calls).
"""

from repro_torch.platform import compute  # noqa: F401
from repro_torch.core.blockcache import BlockCache, CacheOptions  # noqa: F401
from repro_torch.platform.backend import (  # noqa: F401
    BackendOutcome,
    PlatformBackend,
    PoolJob,
    ServicePool,
    SimulatedBackend,
    ThreadedBackend,
)
from repro_torch.platform.compute import (  # noqa: F401
    MOMENTS,
    BlockArena,
    DispatchStats,
    MomentsSpec,
    build_block,
    pad_to_common,
    resolve_engine,
    run_map_task,
    run_map_wave,
    wave_supported,
)
from repro_torch.platform.driver import (  # noqa: F401
    BASH_STARTUP,
    PLATFORMS,
    ApproxOptions,
    FaultOptions,
    JobPlan,
    JobReport,
    Platform,
    PlatformConfig,
    PlatformSpec,
    ScheduleOptions,
    WaveContext,
    WaveOptions,
    build_wave_context,
    make_tasks,
    measure_kneepoint,
    plan_job,
    resolve_platform_config,
    wave_enabled,
)
from repro_torch.platform.monitor import (  # noqa: F401
    SLO,
    MonitorOptions,
    PlatformMonitor,
    SLOPolicy,
    TimeSeriesStore,
    render_monitor_report,
    resolve_monitor_options,
    write_alerts_jsonl,
    write_monitor_report,
)
from repro_torch.platform.reduce import (  # noqa: F401
    StreamingReduceTree,
    finalize_stats,
    tree_add,
)
from repro_torch.platform.service import (  # noqa: F401
    AdmissionError,
    AdmissionPolicy,
    CancelledError,
    DatasetHandle,
    JobTicket,
    PartialEstimate,
    PlatformService,
    QueryClass,
)
from repro_torch.platform.telemetry import (  # noqa: F401
    EVENT_KINDS,
    Event,
    MetricsRegistry,
    TelemetryBus,
    TelemetryConfig,
    TelemetrySampler,
    build_trace,
    null_bus,
    render_report,
    resolve_telemetry_config,
    write_report,
    write_trace,
)

# The curated facade, the reference's list: star-imports and API docs
# follow it; additions are append-only.
__all__ = [
    # driver: one-shot jobs
    "Platform",
    "PlatformSpec",
    "JobReport",
    # grouped platform options
    "WaveOptions",
    "ScheduleOptions",
    "ApproxOptions",
    "FaultOptions",
    "CacheOptions",
    # multi-tenant service
    "PlatformService",
    "AdmissionPolicy",
    "DatasetHandle",
    "JobTicket",
    "PartialEstimate",
    # telemetry configuration
    "TelemetryConfig",
    # SLO monitor / critical-path / diagnosis (DESIGN.md §15)
    "MonitorOptions",
    "PlatformMonitor",
    "SLO",
]
