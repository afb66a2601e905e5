"""Cross-task confidence estimation for online aggregation (DESIGN.md §10).

The thesis motivates subsampling as *interactive* statistics — an answer
"in real time, in interactive fashion" — and Politis' *scalable
subsampling* observation makes that cheap: a job's result is an average
of per-task subsample estimates, and the **spread of those per-task
estimates is itself a variance estimate** of the aggregated statistic.
Nothing extra is computed on the device: every map task already returns
its subsample estimate, so after ``k`` tasks the platform holds ``k``
i.i.d.-ish draws θ̂₁..θ̂ₖ of the statistic and can report

    θ̄ₖ = mean(θ̂ᵢ)           (the running online-aggregation estimate)
    CI  = θ̄ₖ ± z(confidence) · s(θ̂ᵢ) / √k      (CLT across tasks)

per component.  Vector statistics (a 64-cell ALOD curve, 120 monthly
means) get a **simultaneous** band: the per-component critical value is
Bonferroni-corrected over the D supported components (z at
1 − (1−confidence)/(2·D)), so "the whole answer curve lies inside the
reported band" holds at the stated confidence — not per-component 95%
that is jointly almost never true at D=64.  When the band's half-width
falls under a caller-supplied ``epsilon``, the remaining tasks cannot
change the answer beyond the caller's tolerance — the job can DRAIN
(cancel its queued tasks) and return early
(:class:`StoppingController`).

Determinism: per-task estimates are keyed by task id and reduced in
sorted-id order, so for a given *set* of completed tasks the snapshot is
bit-identical whatever order they completed in (threads cannot reorder
the float reductions).

Plug-in scalarization exists for the repo's statistics (``moments``,
``monthly_mean``, ``alod`` — each task partial carries enough to recover
the task's own estimate).  Unknown statistics get the conservative
fallback: no estimate, never converged, the job always runs to
completion — approximation is strictly opt-in per workload.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Normal quantile (no scipy in the image; Acklam's rational approximation,
# |relative error| < 1.15e-9 over (0, 1) — far below any CI use here)
# ---------------------------------------------------------------------------

_PPF_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
_PPF_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
_PPF_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
_PPF_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)


def normal_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam approximation)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    a, b, c, d = _PPF_A, _PPF_B, _PPF_C, _PPF_D
    p_low, p_high = 0.02425, 1.0 - 0.02425
    if p < p_low:
        q = math.sqrt(-2.0 * math.log(p))
        return ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5])
                / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0))
    if p > p_high:
        q = math.sqrt(-2.0 * math.log(1.0 - p))
        return -((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                  * q + c[5])
                 / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1.0))
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
            * r + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3])
                                * r + b[4]) * r + 1.0)


def z_for_confidence(confidence: float) -> float:
    """Two-sided normal critical value, e.g. 0.95 → 1.9600."""
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")
    return normal_ppf(0.5 + confidence / 2.0)


def validate_error_target(epsilon: Optional[float],
                          confidence: float) -> None:
    """Fail-fast validation for caller-supplied error targets.  Entry
    points (``Platform.run``, ``PlatformService.submit``) call this
    BEFORE reserving any resource — a ValueError surfacing later, e.g.
    after the service admitted the job, would leak the admission slot
    and hang the ticket."""
    if epsilon is not None and epsilon <= 0:
        raise ValueError(f"epsilon must be positive, got {epsilon}")
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1), got {confidence}")


# ---------------------------------------------------------------------------
# Per-statistic task-estimate extraction
# ---------------------------------------------------------------------------


def _theta_moments(partial: Dict[str, Any]) -> np.ndarray:
    """Each moments task draws the same count, so the task's column-mean
    IS its subsample estimate (and the full reduce equals the equal-weight
    mean of these)."""
    count = float(np.asarray(partial["count"]))
    return np.asarray(partial["sum"], np.float64) / max(count, 1.0)


def _theta_monthly_mean(partial: Dict[str, Any]) -> np.ndarray:
    """Per-month mean of the task's subsampled ratings; months this task
    never drew are NaN (masked out of the CI componentwise)."""
    sums = np.asarray(partial["sum"], np.float64)
    cnts = np.asarray(partial["count"], np.float64)
    return np.where(cnts > 0, sums / np.maximum(cnts, 1.0), np.nan)


def _theta_alod(partial: Dict[str, Any]) -> np.ndarray:
    """Per-cell mean |z| score of the task's draws; unhit cells are NaN."""
    curve = np.asarray(partial["sum_curve"], np.float64)
    hits = np.asarray(partial["hits"], np.float64)
    return np.where(hits > 0, curve / np.maximum(hits, 1.0), np.nan)


EXTRACTORS: Dict[str, Callable[[Dict[str, Any]], np.ndarray]] = {
    "moments": _theta_moments,
    "monthly_mean": _theta_monthly_mean,
    "alod": _theta_alod,
}


@dataclasses.dataclass(frozen=True)
class EstimateSnapshot:
    """One online-aggregation checkpoint: the running estimate with its
    componentwise confidence interval.  ``half_width`` is the max over
    components with full cross-task support (NaN components — e.g. a
    month no completed task drew — are excluded); ``inf`` until at least
    two tasks are in (no variance estimate exists yet)."""

    value: np.ndarray          # mean of per-task estimates, per component
    ci_low: np.ndarray         # NaN where a component lacks support
    ci_high: np.ndarray
    half_width: float
    tasks_in: int
    confidence: float

    def as_dict(self) -> Dict[str, Any]:
        return {"value": self.value, "ci_low": self.ci_low,
                "ci_high": self.ci_high, "half_width": self.half_width,
                "tasks_in": self.tasks_in, "confidence": self.confidence}

    def contains(self, answer: np.ndarray, *,
                 slack: float = 0.0) -> bool:
        """Componentwise coverage check (NaN components skipped): does
        ``answer`` lie inside this CI?  The accuracy-gate primitive."""
        answer = np.asarray(answer, np.float64).reshape(-1)
        lo = np.asarray(self.ci_low, np.float64).reshape(-1) - slack
        hi = np.asarray(self.ci_high, np.float64).reshape(-1) + slack
        ok = np.isnan(lo) | np.isnan(hi) | ((answer >= lo) & (answer <= hi))
        return bool(np.all(ok))


class SubsampleEstimator:
    """Incremental cross-task estimate accumulator.

    ``observe(task_id, partial)`` may be called from any thread (the
    reduce tree's combiner, the simulator's replay); ``estimate()``
    reduces the per-task estimates in sorted-task-id order so the
    snapshot depends only on the *set* of observed tasks, never their
    completion order.  Duplicate observations of a task id (speculative
    clones) overwrite idempotently — clones are bit-identical by seed.
    """

    def __init__(self, statistic: str, confidence: float = 0.95):
        self.statistic = statistic
        self.confidence = confidence
        self._z = z_for_confidence(confidence)
        self._extract = EXTRACTORS.get(statistic)
        self._theta: Dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    @property
    def supported(self) -> bool:
        """False ⇒ conservative fallback: no estimates, never converges."""
        return self._extract is not None

    def observe(self, task_id: int, partial: Any) -> None:
        if self._extract is None or not isinstance(partial, dict):
            return
        try:
            theta = np.asarray(self._extract(partial),
                               np.float64).reshape(-1)
        except (KeyError, TypeError, ValueError):
            return                      # malformed partial: stay conservative
        with self._lock:
            self._theta[task_id] = theta

    def tasks_in(self) -> int:
        with self._lock:
            return len(self._theta)

    def reset(self) -> None:
        """Forget every observation (job-level restart: the platform
        discards and re-executes all completions, so the estimate must
        track the retry's completions, not the dead run's)."""
        with self._lock:
            self._theta.clear()

    def estimate(self) -> Optional[EstimateSnapshot]:
        """The current snapshot, or ``None`` before the first usable
        task (or for an unsupported statistic)."""
        with self._lock:
            if not self._theta:
                return None
            thetas = np.stack([self._theta[i] for i in sorted(self._theta)])
        k = thetas.shape[0]
        # a component only has a variance estimate when EVERY observed
        # task produced it; partially-supported components stay NaN
        value = thetas.mean(axis=0)
        if k < 2:
            half = np.full_like(value, np.inf)
        else:
            sd = thetas.std(axis=0, ddof=1)
            # simultaneous band: Bonferroni over the D valid components
            # (D=1 reduces to the plain two-sided z)
            d = int(np.count_nonzero(~np.isnan(sd)))
            z = (normal_ppf(1.0 - (1.0 - self.confidence) / (2.0 * d))
                 if d else self._z)
            half = z * sd / math.sqrt(k)
        valid = ~np.isnan(half)
        width = float(np.max(half[valid])) if valid.any() else math.inf
        return EstimateSnapshot(
            value=value, ci_low=value - half, ci_high=value + half,
            half_width=width, tasks_in=k, confidence=self.confidence)


# ---------------------------------------------------------------------------
# Stopping rule (the DRAINING trigger)
# ---------------------------------------------------------------------------


class StoppingController:
    """The error-bounded stopping rule, checked at wave settlement.

    ``should_stop()`` is monotone: once the CI half-width has fallen
    under ``epsilon`` (with at least ``min_tasks`` tasks in), it latches
    True and records ``stop_reason``/``final`` — the drivers flip the
    job to DRAINING exactly once and let in-flight work settle.  With
    ``epsilon=None`` (or an unsupported statistic) it never fires and
    every existing path is untouched.
    """

    def __init__(self, estimator: SubsampleEstimator,
                 epsilon: Optional[float], *, min_tasks: int = 8):
        if epsilon is not None and epsilon <= 0:
            raise ValueError(f"epsilon must be positive, got {epsilon}")
        self.estimator = estimator
        self.epsilon = epsilon
        self.min_tasks = max(int(min_tasks), 2)   # CI needs ≥2 estimates
        self.stopped = False
        self.stop_reason: Optional[str] = None
        self.final: Optional[EstimateSnapshot] = None
        self._last_checked = -1        # dedupe snapshots per task count

    def on_complete(self, task_id: int) -> None:
        """Completion hook for drivers that feed the estimator out of
        band (the virtual-time replay overrides this)."""

    def reset(self) -> None:
        """Job-level restart: the run's completions are discarded and
        re-executed, so both the latch and the estimator's observations
        must start over — a stale latched stop would drain the retry at
        its first settlement, returning an answer far thinner than the
        recorded ``final`` claims."""
        self.stopped = False
        self.stop_reason = None
        self.final = None
        self._last_checked = -1
        self.estimator.reset()

    def should_stop(self) -> bool:
        if self.stopped:
            return True
        if self.epsilon is None or not self.estimator.supported:
            return False
        # cheap pre-checks before the O(k·D) snapshot: callers hold the
        # scheduler/pool lock here, and the observed-task SET can only
        # grow — same count means same set, nothing to re-evaluate
        k = self.estimator.tasks_in()
        if k < self.min_tasks or k == self._last_checked:
            return False
        self._last_checked = k
        snap = self.estimator.estimate()
        if snap is None or snap.tasks_in < self.min_tasks:
            return False
        if snap.half_width <= self.epsilon:
            self.stopped = True
            self.final = snap
            self.stop_reason = (
                f"converged: ci_half_width {snap.half_width:.4g} <= "
                f"epsilon {self.epsilon:.4g} at {snap.confidence:.0%} "
                f"confidence after {snap.tasks_in} tasks")
            return True
        return False

    def force_stop(self, reason: str) -> None:
        """Latch the stop NOW with whatever CI has been achieved — the
        graceful-degradation path: injected/real failures shrank capacity
        past feasibility, so an epsilon-capable job drains at the
        achieved confidence interval instead of hanging.  Idempotent; a
        job that already converged keeps its converged reason."""
        if self.stopped:
            return
        self.stopped = True
        self.stop_reason = reason
        self.final = self.estimator.estimate()

    def snapshot(self) -> Optional[EstimateSnapshot]:
        """Latest estimate (the latched ``final`` once stopped)."""
        return self.final if self.final is not None \
            else self.estimator.estimate()


class ReplayStopper(StoppingController):
    """Virtual-time variant: the simulated backend computes every task's
    partial up front (its calibration pass), then *replays* completions
    in simulated order — :meth:`on_complete` feeds the estimator from
    the captured partials so the stopping decision happens at the same
    task count a real cluster would reach it at."""

    def __init__(self, estimator: SubsampleEstimator,
                 epsilon: Optional[float], *,
                 partials: Dict[int, Any], min_tasks: int = 8):
        super().__init__(estimator, epsilon, min_tasks=min_tasks)
        self._partials = partials

    def on_complete(self, task_id: int) -> None:
        partial = self._partials.get(task_id)
        if partial is not None:
            self.estimator.observe(task_id, partial)
