"""The thesis' control plane, copied from the reference package with only
its import paths changed: tiny-task sizing (kneepoint), the two-phase
dynamic scheduler, the adaptive-replication data plane, job-level
recovery, the estimator behind approximate queries, SLO pool sizing, the
block cache and prefetch.

Unlike the reference's ``core/__init__.py`` this one imports no engine,
so importing the package loads neither JAX nor torch."""

from repro_torch.core.kneepoint import (
    CurvePoint,
    KneepointResult,
    amat_curve,
    find_kneepoint,
    measure_curve,
    pack_tasks,
    timed_task,
)
from repro_torch.core.scheduler import (
    JobFailure,
    SchedulerConfig,
    SimOutcome,
    SimParams,
    SimWorker,
    Task,
    TaskResult,
    ThreadedRunner,
    TwoPhaseScheduler,
    simulate_job,
)
from repro_torch.core.datastore import (
    DataNode,
    ReplicatedDataStore,
    ReplicationPolicy,
)
from repro_torch.core.estimator import (
    EstimateSnapshot,
    ReplayStopper,
    StoppingController,
    SubsampleEstimator,
    normal_ppf,
    z_for_confidence,
)
from repro_torch.core.prefetch import PrefetchPipeline
from repro_torch.core.recovery import (
    JobRunner,
    decide_policy,
    expected_failures,
    min_cluster_for_task_level,
    recovery_overhead_budget,
)
from repro_torch.core import slo

# NOTE: repro_torch.core.tiny_task is intentionally NOT imported here — it
# is a facade over repro_torch.platform (which itself imports
# repro_torch.core); importing it eagerly would create a package-level
# cycle.  `from repro_torch.core import tiny_task` still works as a plain
# submodule import.
