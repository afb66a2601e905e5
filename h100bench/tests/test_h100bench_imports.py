"""No module that a run loads has the top-level name ``jax`` (or
``jaxlib``, ``flax``) or ``repro``, the JAX package, compared whole: the
port's ``repro_torch`` begins with ``repro`` and is allowed.  The plain
references load neither, nor anything of ``repro_torch``.  Without a card,
and in a directory that holds only the benchmark, a run prints no result
and exits non-zero."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from _tiny import HERE, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _python(code: str, cwd=REPO) -> set:
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_each_cell_loads_no_jax_and_no_jax_package(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {str(HERE / 'tests')!r})
import _tiny
root = _tiny.make_root({str(tmp_path)!r})
for cell in _tiny.TINY_CELLS:
    for trace in (False, True):
        _tiny.run(root, cell, trace=trace)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    tops = _python(code)
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN


def test_the_references_load_nothing_of_the_program():
    code = f"""
import json, sys, torch
sys.path.insert(0, {str(REPO)!r})
from h100bench.core import load_module
for name in ("rwkv6", "llama"):
    load_module(__import__("pathlib").Path({str(HERE)!r}) / "reference" / (name + ".py"))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    tops = _python(code)
    assert not tops & (FORBIDDEN | {"repro_torch"})


def _run(cwd, workload="rwkv6-7b.train-4k"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_a_card_a_run_prints_no_result():
    out = _run(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_with_only_the_benchmark_a_run_prints_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
