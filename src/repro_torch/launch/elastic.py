"""Elastic scaling controller for the tiny-task platform, ported.

Workers may join or leave *between jobs* freely (the scheduler is
constructed per job) and leave *during* a job under the recovery model
(job-level restart on survivors, or task-level reclamation).  This module
adds the control loop the thesis implies in §4.2.3: scale the worker pool
per job to the SLO using measured throughput profiles, and keep a warm
standby so a failure mid-job restarts at full width.

The port holds the reference's controller with its import paths changed:
the same decisions, events and demo reports for the same inputs.  Its
training-side elasticity (a restart at another data-parallel width from a
mesh-agnostic checkpoint) waits for the port's training loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Sequence

from repro_torch.core.scheduler import SimParams, SimWorker, simulate_job
from repro_torch.core.slo import ScaleDecision, choose_cores


@dataclasses.dataclass
class PoolEvent:
    time: float
    action: str              # "grow" | "shrink" | "restart"
    size: int
    reason: str


class ElasticWorkerPool:
    """Tracks desired vs available workers and produces scale decisions
    per submitted job."""

    def __init__(self, core_options: Sequence[int],
                 throughput: Callable[[int, float], float],
                 startup: Callable[[int], float]):
        self.core_options = sorted(core_options)
        self.throughput = throughput
        self.startup = startup
        self.size = self.core_options[0]
        self.events: List[PoolEvent] = []

    def plan_job(self, job_bytes: float, slo_seconds: float
                 ) -> ScaleDecision:
        decision = choose_cores(
            self.core_options,
            throughput=lambda c: self.throughput(c, job_bytes),
            startup=self.startup,
            slo_seconds=slo_seconds)
        if decision.cores != self.size:
            action = "grow" if decision.cores > self.size else "shrink"
            self.events.append(PoolEvent(time.time(), action,
                                         decision.cores, decision.reason))
            self.size = decision.cores
        return decision

    def on_failure(self, lost: int) -> int:
        """A node died mid-job: job-level recovery restarts on survivors;
        the pool immediately requests a replacement for the next job."""
        self.size = max(1, self.size - lost)
        self.events.append(PoolEvent(time.time(), "restart", self.size,
                                     f"lost {lost} worker(s)"))
        return self.size


def demo_elastic_run(job_sizes: Sequence[float], slo_seconds: float,
                     per_byte_cost: float = 1e-8) -> Dict[str, object]:
    """Simulated elastic session: plan + run each job, inject one failure."""
    def tp(cores: int, job_bytes: float) -> float:
        return cores * 1e8                     # 100 MB/s/core steady state

    pool = ElasticWorkerPool((4, 8, 16, 32), tp,
                             startup=lambda c: 0.05 + 0.002 * c)
    reports = []
    for i, size in enumerate(job_sizes):
        decision = pool.plan_job(size, slo_seconds)
        from repro_torch.core.scheduler import SchedulerConfig, Task
        n_tasks = max(8, int(size / 2**20))
        tasks = [Task(t, (t,), size / n_tasks) for t in range(n_tasks)]
        workers = [SimWorker(w, fail_at=(0.01 if (i == 1 and w == 0)
                                         else None))
                   for w in range(decision.cores)]
        out = simulate_job(
            tasks, workers,
            SimParams(exec_time=lambda t: t.size_bytes * per_byte_cost,
                      fetch_time=lambda t: 0.0,
                      startup_time=pool.startup(decision.cores)),
            SchedulerConfig(recovery="job"))
        if out.restarts:
            pool.on_failure(1)
        reports.append({"job": i, "cores": decision.cores,
                        "makespan": out.makespan,
                        "restarts": out.restarts,
                        "met_slo": out.makespan <= slo_seconds})
    return {"reports": reports, "events": pool.events}
