"""The controls, at a size a test run can hold: the plain reference put in
the program's place in fp8, and with half of each batch left out, comes
out as not correct against the tiny cells' limits, which sound runs pass
(``test_h100bench_faults.py``).  ``h100bench/controls.py`` reads the same
on the card at the cells' own sizes; the card test here runs it on one
seed of each real cell."""

from __future__ import annotations

import pytest
import torch

import _tiny
from h100bench import controls, core


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return core.Bench(_tiny.make_root(tmp_path_factory.mktemp("controls")))


def _fails(reading, limits):
    return any(reading[k] > limits[k] for k in limits)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 5, 9_000_000_001])
def test_training_controls_fail_the_limits(bench, seed):
    cell = "rwkv6-tiny.train-tiny"
    got = controls.readings(bench, cell, seed, "cpu")
    limits = bench.limits(cell)
    assert _fails(got["control_fp8"], limits), got
    assert _fails(got["half_batch"], limits), got


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 5, 9_000_000_001])
def test_serving_control_fails_the_limit(bench, seed):
    cell = "llama-tiny.serve-tiny"
    got = controls.readings(bench, cell, seed, "cpu")
    limits = bench.limits(cell)
    assert _fails(got["control_fp8"], limits), got
    assert not _fails(got["program"], limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["rwkv6-7b.train-4k",
                                  "deepseek-7b.serve-4k"])
def test_controls_fail_at_the_cells_own_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells' own sizes")
    bench = core.Bench(_tiny.REPO)
    got = controls.readings(bench, cell, 2 ** 31 + 21, "cuda")
    limits = bench.limits(cell)
    for name in ("control_fp8",):
        assert _fails(got[name], limits), got
