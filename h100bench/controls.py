"""The readings that a cell's limits are set from, beside the benchmark's
own runs (which read the program).

    python3 h100bench/controls.py --workload <cell> --seeds <n> [<n> ...]

For each seed, at the cell's own sizes: the plain reference (float32)
gives the readings the program is held to, and the reference put in the
program's place gives the control's and the faults' readings:

- training: the reference in fp8 (every matrix product's operands and
  incoming gradients rounded to float8 e4m3), and the reference that
  leaves half of each batch out (the mean over the rest); beside them the
  reference with its products' operands rounded to bf16, a witness of how
  far rounding at the configuration's own precision moves each number;
- serving: one call of the program, then at each position of the same
  prompts and served tokens the token the fp8 reference puts first, read
  by the float32 reference (the widest gap), beside the program's own gap.

Prints one JSON line a seed.  ``tests/test_h100bench_controls.py`` runs
the same at a size a CPU test can hold.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]


def train_readings(bench, workload: str, seed: int, device: str) -> Dict:
    import torch

    from h100bench import core, weights
    from h100bench.drivers import train as drv
    from repro_torch.config.base import (MeshConfig, RunConfig, ShapeConfig,
                                         TrainConfig)
    from repro_torch.data.pipeline import (PipelineConfig,
                                           SubsamplingBatchPipeline)
    from repro_torch.models.model import Model

    cell = bench.workload(workload)
    config, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    cfg = core.model_config(config)
    run = RunConfig(model=cfg, shape=ShapeConfig("train", "train",
                                                 mix["seq_len"], mix["batch"]),
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    train=TrainConfig(**config["train"]))
    model = Model(cfg, device=device)
    specs = weights.leaf_specs(model.param_defs(), model.dtype)
    pipe = SubsamplingBatchPipeline(
        drv.corpus(mix["corpus"], cfg.vocab_size,
                   core.derive_seed(seed, "corpus")),
        PipelineConfig(batch_size=mix["batch"], seq_len=mix["seq_len"],
                       seed=core.derive_seed(seed, "pipeline")))
    it = pipe.batches(drv.CHECKED_STEPS)
    batches = [{k: v.copy() for k, v in next(it).items()}
               for _ in range(drv.CHECKED_STEPS)]
    it.close()
    ref_mod = bench.reference(config["architecture"])
    leaves = weights.make(specs, core.derive_seed(seed, "weights"),
                          model.device)
    out = {}
    kinds = {"reference": {}, "control_fp8": {"precision": "fp8"},
             "half_batch": {"half_batch": True},
             "reference_bf16": {"precision": "bf16"}}
    for name, kw in kinds.items():
        t = time.perf_counter()
        out[name] = ref_mod.train_readings(config, leaves, batches,
                                           run.microbatches(),
                                           steps=drv.CHECKED_STEPS,
                                           keep_grads=drv.DIRECTION_LEAVES,
                                           **kw)
        out[name]["seconds"] = time.perf_counter() - t
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    ref = out["reference"]
    return {name: drv.readings(out[name], ref)
            for name in ("control_fp8", "half_batch", "reference_bf16")} | {
        f"losses.{name}": out[name]["losses"] for name in kinds} | {
        "reference_seconds": ref["seconds"]}


def serve_readings(bench, workload: str, seed: int, device: str) -> Dict:
    import torch

    from h100bench import core, weights
    from h100bench.drivers import serve_batch as drv
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServingEngine

    cell = bench.workload(workload)
    config, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    cfg = core.model_config(config)
    model = Model(cfg, device=device)
    defs = model.param_defs()
    specs = weights.leaf_specs(defs, model.dtype)
    wseed = core.derive_seed(seed, "weights")
    engine = ServingEngine(model, weights.build_tree(
        defs, weights.make(specs, wseed, model.device)),
        max_new_tokens=mix["new_tokens"])
    job = core.Job(bench, config, mix, {}, seed, 0.0, False, device, 0.0)
    prompts = drv.prompts(job, 0, mix["batch"], mix["prompt_len"],
                          cfg.vocab_size, model.device)
    served = torch.as_tensor(engine.generate(
        {"tokens": prompts}, new_tokens=mix["new_tokens"]).tokens,
        device=model.device)
    del engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref_mod = bench.reference(config["architecture"])
    leaves = weights.make(specs, wseed, model.device)
    t = time.perf_counter()
    exact = ref_mod.served_logits(config, leaves, prompts, served)
    seconds = time.perf_counter() - t
    low = ref_mod.served_logits(config, leaves, prompts, served,
                                precision="fp8")
    control = ref_mod.widest_gaps(exact, low.argmax(dim=-1))
    program = ref_mod.widest_gaps(exact, served)
    return {"control_fp8": {"logit_gap": float(control.max())},
            "program": {"logit_gap": float(program.max())},
            "reference_seconds": seconds}


def readings(bench, workload: str, seed: int, device: str) -> Dict:
    kind = bench.mix(bench.workload(workload)["traffic"])["kind"]
    fn = {"train": train_readings, "serve_batch": serve_readings}[kind]
    return fn(bench, workload, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from h100bench import core
    if not torch.cuda.is_available():
        print("controls: no CUDA device is available", file=sys.stderr)
        return 3
    bench = core.Bench(ROOT)
    for seed in args.seeds:
        got = readings(bench, args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "card": torch.cuda.get_device_name(0), **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
