"""The elastic worker-pool controller of the port
(``repro_torch.launch.elastic``) against the reference's
(``repro.launch.elastic``): the reference's own elastic tests on the port,
and the port's decisions, events (their wall-clock times aside) and demo
reports equal to the reference's on the same inputs.  Both are host code
over the same simulator; nothing is approximate, so every comparison is
exact."""

import dataclasses

import pytest

from repro.launch import elastic as ref_elastic
from repro_torch.launch import elastic as port_elastic
from repro_torch.launch.elastic import ElasticWorkerPool, demo_elastic_run

CORES = (4, 8, 16, 32)


def _pools(throughput=lambda c, b: c * 1e8,
           startup=lambda c: 0.05 + 0.002 * c):
    return (ref_elastic.ElasticWorkerPool(CORES, throughput, startup),
            port_elastic.ElasticWorkerPool(CORES, throughput, startup))


def _events(events):
    """Each event but its wall-clock time."""
    return [(e.action, e.size, e.reason) for e in events]


def test_elastic_pool_scales_with_job_size():
    pool = ElasticWorkerPool(
        CORES, throughput=lambda c, b: c * 1e8,
        startup=lambda c: 0.05 + 0.002 * c)
    small = pool.plan_job(1e6, slo_seconds=0.2)
    big = pool.plan_job(1e10, slo_seconds=60.0)
    assert big.cores >= small.cores
    assert any(e.action == "grow" for e in pool.events)


def test_elastic_demo_session_recovers_and_meets_slos():
    out = demo_elastic_run([1e8, 1e9, 1e8], slo_seconds=30.0)
    reports = out["reports"]
    assert len(reports) == 3
    assert all(r["met_slo"] for r in reports)
    # job 1 had an injected failure → job-level restart happened
    assert reports[1]["restarts"] >= 1
    assert any(e.action == "restart" for e in out["events"])


@pytest.mark.parametrize("jobs", [
    [(1e6, 0.2), (1e10, 60.0)],
    [(1e10, 60.0), (1e6, 0.2), (5e8, 2.0)],
    [(1e9, 0.05), (1e9, 10.0), (1e12, 5.0), (1e3, 1.0)],
])
def test_plan_job_decisions_equal_the_reference(jobs):
    """The same sequence of jobs gives the same decisions (cores,
    throughput, data within the SLO, reason), the same pool size after
    each, and the same grow/shrink events; a failure then restarts both
    pools alike."""
    ref, port = _pools()
    for job_bytes, slo in jobs:
        want = ref.plan_job(job_bytes, slo)
        got = port.plan_job(job_bytes, slo)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert port.size == ref.size
    assert port.on_failure(3) == ref.on_failure(3)
    assert _events(port.events) == _events(ref.events)
    assert [type(e).__name__ for e in port.events] == \
        ["PoolEvent"] * len(port.events)


@pytest.mark.parametrize("sizes,slo", [
    ([1e8, 1e9, 1e8], 30.0),
    ([1e7, 1e10, 3e8, 1e6], 0.5),
    ([2e9], 1.0),
])
def test_demo_reports_equal_the_reference(sizes, slo):
    want = ref_elastic.demo_elastic_run(sizes, slo)
    got = port_elastic.demo_elastic_run(sizes, slo)
    assert got["reports"] == want["reports"]
    assert _events(got["events"]) == _events(want["events"])
