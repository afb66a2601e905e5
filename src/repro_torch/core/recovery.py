"""Job-level vs task-level recovery cost model (thesis §3.3).

Expected failures during one job execution:

    f_w = β · N · P(w) / mttf

with N nodes, SLO/worst-case running time P(w), mean time to failure mttf,
and β capturing correlated heavy-tail failures.  Task-level recovery (per-
task monitoring + replication) slows every task by ``cost_tl``; it only
pays off when the expected failure loss of restarting whole jobs exceeds
that standing tax.  With the thesis' numbers (N=100, P=10 min, mttf=4.3
months, β=1.5): f_w ≈ 0.0078 ⇒ monitoring overhead must be < 1% to be
justified — hence the platform defaults to job-level recovery.

``JobRunner`` implements job-level recovery for arbitrary callables; for
training jobs, "restart" resumes from the last *job-level* checkpoint
(``repro_torch.checkpoint``), which is the paper's model applied at step
granularity instead of map-task granularity.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

MONTH_SECONDS = 30 * 24 * 3600.0

# The thesis' §3.3 parameterization.
THESIS_DEFAULTS = dict(n_nodes=100, slo_seconds=600.0,
                       mttf_seconds=4.3 * MONTH_SECONDS, beta=1.5)


def expected_failures(n_nodes: int, slo_seconds: float,
                      mttf_seconds: float, beta: float = 1.5) -> float:
    """f_w = β·N·P(w)/mttf."""
    return beta * n_nodes * slo_seconds / mttf_seconds


def recovery_overhead_budget(n_nodes: int, slo_seconds: float,
                             mttf_seconds: float, beta: float = 1.5) -> float:
    """Maximum per-task monitoring overhead that task-level recovery can
    justify: on each failure, task-level recovery saves ≈ the job running
    time, so its budget is f_w (fraction of a job per job)."""
    return expected_failures(n_nodes, slo_seconds, mttf_seconds, beta)


def decide_policy(*, n_nodes: int, slo_seconds: float,
                  mttf_seconds: float, beta: float = 1.5,
                  cost_tl: float = 0.20) -> str:
    """Return "task" iff the monitoring tax is under the failure budget.

    The thesis measured cost_tl ≈ 20% on Hadoop (Fig 6) and computes that
    clusters need > ~30K nodes before that is justified for 10-minute jobs.
    """
    budget = recovery_overhead_budget(n_nodes, slo_seconds, mttf_seconds,
                                      beta)
    return "task" if cost_tl < budget else "job"


def min_cluster_for_task_level(*, cost_tl: float, slo_seconds: float,
                               mttf_seconds: float, beta: float = 1.5) -> int:
    """Smallest N at which task-level recovery pays (thesis: ~30K nodes for
    the 21% startup overhead measured in Fig 5)."""
    return int(cost_tl * mttf_seconds / (beta * slo_seconds)) + 1


# ---------------------------------------------------------------------------
# Straggler speculation cost model (the §3.3 rule applied per clone)
# ---------------------------------------------------------------------------

# A speculative clone re-executes one task, so its standing tax is ≈ one
# exec-EMA of worker capacity (the analogue of cost_tl for task-level
# monitoring, but paid per *clone*, not per task).
SPECULATION_CLONE_TAX = 1.0


def speculation_gain(age_seconds: float, exec_ema: float) -> float:
    """Expected makespan saving from cloning a straggler *now*.  Under a
    heavy-tail straggler model the expected remaining time of a task that
    has already run ``age_seconds`` is at least its age so far; the clone
    finishes in ≈ one exec-EMA, so the gain is their difference."""
    return age_seconds - exec_ema


def should_speculate(age_seconds: float, exec_ema: Optional[float], *,
                     straggler_factor: float = 2.0,
                     clone_tax: float = SPECULATION_CLONE_TAX) -> bool:
    """Clone a straggler iff (a) it qualifies — its age exceeds
    ``straggler_factor ×`` the pool exec-EMA — and (b) the §3.3 economics
    hold per clone: the expected saving (:func:`speculation_gain`) must
    exceed the clone's standing tax (``clone_tax ×`` exec-EMA of wasted
    capacity if the original wins the race).  This is the job-vs-task
    trade-off of :func:`decide_policy` applied at clone granularity:
    redundancy must beat what it costs."""
    if not exec_ema or exec_ema <= 0.0:
        return False
    if age_seconds <= straggler_factor * exec_ema:
        return False
    return speculation_gain(age_seconds, exec_ema) > clone_tax * exec_ema


# ---------------------------------------------------------------------------
# Failure taxonomy + retry policy (shared by datastore / runner / pool)
# ---------------------------------------------------------------------------


class WorkerCrash(RuntimeError):
    """A worker thread died (injected or detected) while holding claimed
    tasks.  The runner/pool reclaims the worker's claims back to the
    scheduler and respawns the thread; first-completion-wins dedup keeps
    settlement at-most-once, so recovery is bit-identical."""


class DegradedJobError(RuntimeError):
    """A job can no longer complete exactly: failures exhausted every
    replica (or the retry budget) for some task's data.  Carries a
    structured partial-result report so callers see exactly how far the
    job got instead of a bare traceback."""

    def __init__(self, message: str, *, reason: str = "",
                 n_tasks: int = 0, completed: int = 0,
                 completed_ids: Optional[list] = None,
                 partial: Any = None):
        super().__init__(message)
        self.reason = reason or message
        self.n_tasks = n_tasks
        self.completed = completed
        self.completed_ids = list(completed_ids or [])
        self.partial = partial

    def report(self) -> Dict[str, Any]:
        return {"reason": self.reason, "n_tasks": self.n_tasks,
                "completed": self.completed,
                "completed_ids": sorted(self.completed_ids)}


#: exception types that retrying cannot fix — fail fast instead of
#: burning the budget (mirrors the transient/permanent split every
#: lease-based scheduler draws between "node flaked" and "task is wrong")
PERMANENT_ERRORS = (KeyError, TypeError, ValueError, AssertionError,
                    DegradedJobError)


def is_permanent(err: BaseException) -> bool:
    """True when retrying the operation cannot succeed: programming /
    lookup errors, or an error explicitly marked permanent by the raiser
    (``err.permanent = True`` — the datastore tags replica-exhaustion
    this way so callers stop retrying a dead sample)."""
    if getattr(err, "permanent", False):
        return True
    return isinstance(err, PERMANENT_ERRORS)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Unified bounded-retry policy: exponential backoff with seeded
    jitter and permanent-vs-transient classification.  ``base_delay=0``
    (the default) keeps the legacy immediate-retry behavior of the
    datastore's old ad-hoc loops — failover to another replica should
    not sleep — while remote-fetch callers can opt into real backoff."""

    max_attempts: int = 3
    base_delay: float = 0.0          # seconds before attempt 2
    backoff_factor: float = 2.0
    max_delay: float = 1.0
    jitter: float = 0.0              # +- fraction of the delay

    def delay(self, attempt: int, rng: Optional[random.Random] = None
              ) -> float:
        """Backoff before retry ``attempt`` (1-based count of failures
        so far).  Deterministic for a seeded ``rng``."""
        if self.base_delay <= 0.0:
            return 0.0
        d = min(self.base_delay * self.backoff_factor ** (attempt - 1),
                self.max_delay)
        if self.jitter > 0.0 and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)

    def call(self, fn: Callable[[], Any], *,
             rng: Optional[random.Random] = None,
             budget: Optional["RetryBudget"] = None,
             sleep: Callable[[float], None] = time.sleep) -> Any:
        """Run ``fn`` under this policy.  Permanent errors propagate
        immediately; transient ones retry up to ``max_attempts`` total
        attempts, spending one unit of ``budget`` per retry."""
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.max_attempts)):
            try:
                return fn()
            except BaseException as e:      # noqa: BLE001
                last = e
                if is_permanent(e) or attempt + 1 >= max(1, self.max_attempts):
                    raise
                if budget is not None and not budget.spend():
                    raise
                d = self.delay(attempt + 1, rng)
                if d > 0.0:
                    sleep(d)
        raise last  # pragma: no cover — loop always returns or raises


class RetryBudget:
    """Thread-safe per-job retry allowance.  Every retry anywhere in the
    job's data path spends one unit; exhaustion turns the next transient
    error permanent, so a job drowning in flaky fetches degrades
    promptly instead of head-of-line blocking the pool."""

    def __init__(self, limit: Optional[int] = None):
        self.limit = limit
        self._spent = 0
        self._lock = threading.Lock()

    def spend(self, n: int = 1) -> bool:
        with self._lock:
            if self.limit is not None and self._spent + n > self.limit:
                return False
            self._spent += n
            return True

    @property
    def spent(self) -> int:
        with self._lock:
            return self._spent


@dataclasses.dataclass
class JobOutcome:
    value: Any
    attempts: int
    wasted_seconds: float


class JobRunner:
    """Run a job under job-level recovery: any failure restarts the whole
    job (optionally from a checkpoint the job itself persisted)."""

    def __init__(self, max_restarts: int = 3,
                 on_restart: Optional[Callable[[int], None]] = None):
        self.max_restarts = max_restarts
        self.on_restart = on_restart

    def run(self, job: Callable[[], Any]) -> JobOutcome:
        wasted = 0.0
        for attempt in range(self.max_restarts + 1):
            t0 = time.perf_counter()
            try:
                value = job()
                return JobOutcome(value, attempt + 1, wasted)
            except Exception as e:      # noqa: BLE001
                wasted += time.perf_counter() - t0
                logger.warning("job attempt %d failed: %s", attempt + 1, e)
                if self.on_restart is not None:
                    self.on_restart(attempt + 1)
        raise RuntimeError(
            f"job failed after {self.max_restarts + 1} attempts "
            f"({wasted:.3f}s wasted)")
