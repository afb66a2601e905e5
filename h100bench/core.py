"""The benchmark's loader and its result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under the benchmark's root,
found by the name that ``BENCHMARK.json`` gives it:

  configs/<config>.json        the sizes as run, ``architecture`` naming
                               reference/<architecture>.py (the plain fp32
                               model) and counts/<architecture>.py (its
                               FLOPs and bytes)
  mixes/<traffic>.json         a traffic mix; its ``kind`` names the general
                               driver drivers/<kind>.py that reads it
  limits/<workload>.json       the limits of a cell's correctness numbers
  metrics/<metric>.py          one per-layer metric's reader:
                               ``read(ctx) -> float | None``

A driver sets a cell up, measures its window, frees the program's state
and compares what the timed path produced with the plain reference.  This
module turns what it returns into the one JSON line the run prints.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

# top-level module names that no run of the port may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path):
    """The Python file at ``path`` as a module (names may hold ``-`` and
    ``.``, so they are loaded by path, not imported by name)."""
    name = "h100bench_file_" + hashlib.sha1(
        str(path).encode()).hexdigest()[:16]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``: the
    same seed and tag always give the same number, another tag another."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self.home = self.root / self.spec["paths"][0]

    def workload(self, name: str) -> Dict[str, Any]:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for cfg in self.spec["configs"]:
            if cfg["name"] == name:
                with open(self.root / cfg["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def _json(self, folder: str, name: str) -> Dict[str, Any]:
        with open(self.home / folder / f"{name}.json") as f:
            return json.load(f)

    def mix(self, traffic: str) -> Dict[str, Any]:
        return self._json("mixes", traffic)

    def limits(self, workload: str) -> Dict[str, float]:
        return self._json("limits", workload)

    def reference(self, architecture: str):
        return load_module(self.home / "reference" / f"{architecture}.py")

    def counts(self, name: str):
        return load_module(self.home / "counts" / f"{name}.py")

    def driver(self, kind: str):
        return load_module(self.home / "drivers" / f"{kind}.py")

    def reader(self, metric: str):
        return load_module(self.home / "metrics" / f"{metric}.py")

    def _of(self, section: str, workload: str) -> List[Dict[str, Any]]:
        cell = self.workload(workload)
        out = []
        for m in self.spec[section]:
            # an end-to-end metric without cells is every cell's; a
            # per-layer metric always names its cells
            cells = m.get("workloads")
            if (cells is None and section == "end_to_end") or (
                    cells is not None and cell["name"] in cells):
                out.append(m)
        return out

    def end_to_end(self, workload: str) -> List[Dict[str, Any]]:
        return self._of("end_to_end", workload)

    def per_layer(self, workload: str) -> List[Dict[str, Any]]:
        return self._of("per_layer", workload)


@dataclasses.dataclass
class Job:
    """What a driver is given: the cell's files and the run's flags."""
    bench: Bench
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                      # the process's start on the host clock


@dataclasses.dataclass
class Outcome:
    """What a driver returns.  ``end_to_end`` by metric name; ``checks``
    each compared number as ``(value, limit)`` (a number passes at or under
    its limit); ``layer`` what the per-layer readers read (the profiled
    window's device operations and host spans, the harness's clocks and
    the program's counters)."""
    end_to_end: Dict[str, float]
    checks: Dict[str, tuple]
    attempted: int
    failed: int
    memory_peak_bytes: int
    layer: Dict[str, Any]
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[Dict[str, list]] = None


def model_config(config: Dict[str, Any]):
    """The program's ``ModelConfig`` from a configuration file: every key
    that names one of its fields (lists become tuples)."""
    from repro_torch.config.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in config.items() if k in fields}
    return ModelConfig(**kw)


def settle() -> None:
    """End of set-up: collect, then move every object set-up made out of
    the collector's reach, so that a full collection in the window scans
    only what the window makes (a pause that scanned set-up's objects
    would land in a random call or step)."""
    gc.collect()
    gc.freeze()


def checks_pass(checks: Dict[str, tuple]) -> bool:
    return all(value is not None and value == value and value <= limit
               for value, limit in checks.values())


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t0: float) -> Dict[str, Any]:
    """Run one cell once and return its result line (a dict)."""
    cell = bench.workload(workload)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    job = Job(bench=bench, config=config, mix=mix,
              limits=bench.limits(workload), seed=int(seed),
              seconds=float(seconds), trace=bool(trace), device=device,
              t0=t0)
    try:
        out: Outcome = bench.driver(mix["kind"]).run(job)
    finally:
        gc.unfreeze()

    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        ctx = dict(out.layer, config=config, mix=mix, bench=bench)
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        for m in bench.end_to_end(workload):
            if m["name"] not in out.end_to_end:
                raise RuntimeError(f"{workload}: the driver gave no "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]),
                                  "unit": m["unit"]}

    correct = (checks_pass(out.checks) and out.failed == 0
               and out.attempted > 0)
    dev: Dict[str, Any] = {"platform": "gpu" if device == "cuda" else device,
                           "kind": _device_kind(device), "count": 1,
                           "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace:
        dev["busy_s"] = out.busy_s
        dev["window_s"] = out.window_s
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(out.attempted),
                            "failed": int(out.failed), "metrics": metrics,
                            "device": dev}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in out.checks.items()}
    return line


def _device_kind(device: str) -> str:
    if device == "cuda":
        import torch
        return torch.cuda.get_device_name(0)
    return device


def loaded_forbidden() -> List[str]:
    """The forbidden top-level module names that ``sys.modules`` holds,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def print_checks(line: Dict[str, Any]) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
