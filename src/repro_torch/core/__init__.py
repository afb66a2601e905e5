"""The thesis' control plane, copied from the reference package with only
its import paths changed: tiny-task sizing (kneepoint), the two-phase
dynamic scheduler, job-level recovery, the estimator behind approximate
queries, SLO pool sizing, the block cache and prefetch.

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
