"""The port's copied control plane behaves as the reference's.

``repro_torch.core.{scheduler,kneepoint}`` are copies of the reference
modules with only their import paths changed.  A representative subset
of ``tests/test_core_scheduler.py`` and ``tests/test_core_kneepoint.py``
runs here against both packages (parametrised by module), and where the
outcome is deterministic the two packages must agree exactly."""

import numpy as np
import pytest

from repro.core import kneepoint as ref_kp
from repro.core import scheduler as ref_sch
from repro_torch.core import kneepoint as port_kp
from repro_torch.core import scheduler as port_sch

SCH = pytest.mark.parametrize("sch", [ref_sch, port_sch],
                              ids=["reference", "port"])
KP = pytest.mark.parametrize("kp", [ref_kp, port_kp],
                             ids=["reference", "port"])


def mk_tasks(sch, n, size=1.0):
    return [sch.Task(i, (i,), size) for i in range(n)]


def uniform_params(sch, exec_s=0.01, fetch_s=0.0):
    return sch.SimParams(exec_time=lambda t: exec_s,
                         fetch_time=lambda t: fetch_s,
                         launch_overhead=0.0, startup_time=0.0)


@SCH
def test_phase1_assigns_one_probe_task_per_worker(sch):
    initial = sch.TwoPhaseScheduler(4, mk_tasks(sch, 100)).initial_assignments()
    assert len(initial) == 4
    assert sorted({w for w, _ in initial}) == [0, 1, 2, 3]


@SCH
def test_queue_depth_grows_with_fetch_to_exec_ratio(sch):
    deep = sch.TwoPhaseScheduler(2, mk_tasks(sch, 10))
    deep._observe(sch.TaskResult(0, 0, 0, fetch_time=0.10, exec_time=0.01))
    shallow = sch.TwoPhaseScheduler(2, mk_tasks(sch, 10))
    shallow._observe(sch.TaskResult(0, 0, 0, fetch_time=0.001,
                                    exec_time=0.01))
    assert deep.queue_depth() > shallow.queue_depth()


@SCH
def test_linear_scaling_with_workers(sch):
    times = {n: sch.simulate_job(mk_tasks(sch, 512),
                                 [sch.SimWorker(i) for i in range(n)],
                                 uniform_params(sch)).makespan
             for n in (2, 4, 8)}
    assert times[4] < 0.6 * times[2]
    assert times[8] < 0.6 * times[4]


@SCH
def test_task_level_recovery_reclaims_and_finishes(sch):
    workers = [sch.SimWorker(i, fail_at=0.05 if i == 0 else None)
               for i in range(4)]
    out = sch.simulate_job(mk_tasks(sch, 400), workers, uniform_params(sch),
                           sch.SchedulerConfig(recovery="task"))
    assert out.restarts == 0
    assert {r.task_id for r in out.results} == set(range(400))


@SCH
def test_threaded_runner_executes_everything(sch):
    runner = sch.ThreadedRunner(3, lambda t: t.task_id)
    results = runner.run_job(mk_tasks(sch, 50))
    assert sorted(r.value for r in results) == list(range(50))


@pytest.mark.parametrize("n_workers,n_tasks,seed",
                         [(1, 0, 0), (3, 37, 1), (8, 300, 2), (16, 5, 3)])
def test_simulation_identical_across_packages(n_workers, n_tasks, seed):
    """Conservation (every task once) in both, and the same virtual-time
    outcome: same makespan, same completion order, same workers."""
    outs = []
    for sch in (ref_sch, port_sch):
        rng = np.random.default_rng(seed)
        workers = [sch.SimWorker(i, speed=float(rng.uniform(0.5, 2.0)))
                   for i in range(n_workers)]
        params = sch.SimParams(
            exec_time=lambda t: 0.001 + (t.task_id % 7) * 1e-4,
            fetch_time=lambda t: (t.task_id % 3) * 1e-4)
        out = sch.simulate_job(mk_tasks(sch, n_tasks), workers, params,
                               sch.SchedulerConfig(seed=seed))
        assert sorted(r.task_id for r in out.results) == list(range(n_tasks))
        outs.append(out)
    ref, port = outs
    assert port.makespan == ref.makespan
    assert [(r.task_id, r.worker_id) for r in port.results] == \
        [(r.task_id, r.worker_id) for r in ref.results]


@KP
def test_flat_then_step_curve_knees_before_step(kp):
    sizes = [0.5, 1.0, 2.0, 2.5, 4.0, 8.0, 16.0, 25.0]
    costs = [1.0, 1.0, 1.01, 1.01, 3.0, 6.0, 12.0, 35.0]
    res = kp.find_kneepoint([kp.CurvePoint(s, c)
                             for s, c in zip(sizes, costs)])
    assert res.task_size == 2.5, res


@KP
def test_monotone_flat_curve_prefers_largest_task(kp):
    res = kp.find_kneepoint([kp.CurvePoint(s, 1.0) for s in (1, 2, 4, 8)])
    assert res.task_size == 8


@KP
def test_amat_curve_has_knee_at_cache_capacity(kp):
    ws = np.geomspace(2**18, 2**26, 24)
    res = kp.find_kneepoint(kp.amat_curve(ws, kp.SANDY_BRIDGE_HIERARCHY),
                            tolerance=0.3)
    assert res.task_size <= 4 * 2**20


@pytest.mark.parametrize("seed", range(6))
def test_pack_tasks_identical_partition(seed):
    """The packing is a partition (every sample once, order kept, no task
    over the knee unless a singleton outlier), and both packages cut the
    same tasks — the task partition of ``Platform.run`` rests on it."""
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 10_000, int(rng.integers(1, 200)))]
    knee = float(rng.uniform(1.0, 50_000.0))
    tasks = port_kp.pack_tasks(sizes, knee)
    assert [i for t in tasks for i in t] == list(range(len(sizes)))
    for t in tasks:
        assert sum(sizes[i] for i in t) <= knee or len(t) == 1
    assert tasks == ref_kp.pack_tasks(sizes, knee)
    assert port_kp.pack_tasks_by_count(sizes, knee) == \
        ref_kp.pack_tasks_by_count(sizes, knee)
