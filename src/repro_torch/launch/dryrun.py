"""The dry run: a cell's cost and memory on a production mesh, with no
card and no allocation (the reference's ``repro.launch.dryrun``).

A cell is an (arch × shape × mesh): ``train_4k``, ``prefill_32k``,
``decode_32k`` or ``long_500k`` on the single-pod ``(16, 16)`` or the
multi-pod ``(2, 16, 16)`` mesh (``launch.mesh.make_production_mesh``).
The reference lowers and compiles the cell's jitted step for 512 forced
host devices and reads XLA's cost and memory analyses.  A PyTorch step
has no compiled artifact; the port runs the step itself on ``meta``
tensors, which carry shapes and dtypes and no storage, through the same
model code (the kernel wrappers take their plain versions there):

* **FLOPs** — :class:`torch.utils.flop_counter.FlopCounterMode` over one
  microbatch's loss and backward, with the step's remat (training), the
  prefill, or one decode step, at two stacked calibration depths,
  extrapolated by the reference's arithmetic (``roofline.analysis``).  A
  training count adds AdamW's analytic cost (:func:`_opt_correction`),
  which the reference's calibration module contains.  The counter counts
  matrix products only: no elementwise FLOPs, and attention counted in
  full where the plain version computes every score, masked or not (XLA
  counts elementwise work too).  Per device is the count ÷ chips, which
  assumes the work partitions evenly.  ``validation_cost`` is the
  calibrated total: no full-depth module is counted.
* **Bytes** — the same run's eager traffic: every op's inputs read and
  outputs written (views move nothing), with no fusion, reported beside
  the analytic traffic model (``roofline.traffic``) that the memory term
  uses, as the reference reports its XLA CPU bytes.
* **Memory** — arguments and outputs per device exactly, from the
  parameter, optimizer-state, cache and input definitions and their
  specs on the mesh (each leaf's bytes ÷ the mesh axes its spec names).
  Temporaries: the peak of live storage allocated inside the step (a
  dispatch mode tracking every new meta storage until it is freed),
  outputs included, a phase at each calibration depth, each phase's
  extrapolated linearly in units and the larger taken, ÷ chips; a
  training step runs two microbatches for this, so that the gradient
  accumulator is live as in any longer step.
  ``fits_hbm`` holds the peak against one H100's memory (``hw``).
* **Collectives** — only HLO shows them, so ``coll_bytes``, ``coll_ops``
  and ``collective_s`` are ``null`` with a ``reason``, never 0; the
  roofline's ``dominant`` is chosen between compute and memory.

The calibration depths are two and three units (a layer-pattern
repetition, after any dense prefix), each stacked so that its blocks run
under the step's remat; the port's ``transformer.stack_plan`` unrolls a
single block without remat, as the reference's does, so a 1-unit count
would miss the recomputation.  The 1-unit cost the reference's
``extrapolate`` takes is derived from them (``cost(2u) − per_unit``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.config import (ARCH_IDS, MULTI_POD_MESH, SHAPES,
                                SINGLE_POD_MESH, MeshConfig, RunConfig,
                                TrainConfig, get_config)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (TRAIN_RULES, NamedSharding,
                                           hint_mesh, named_sharding,
                                           serve_rules, tree_shape_structs,
                                           tree_shardings)
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import hw
from repro_torch.roofline import traffic as rt
from repro_torch.train.loop import TrainState, make_train_phases
from repro_torch.tree import tree_leaves

LM_ARCHS = [a for a in ARCH_IDS if a != "paper-subsample"]

# Per-arch training-memory policy (the reference's): moment/grad precision
# is the distributed-optimization knob that fits the big models.
TRAIN_OVERRIDES = {
    "arctic-480b": dict(moment_dtype="int8", grad_accum_dtype="bfloat16"),
    "qwen2-72b": dict(moment_dtype="bfloat16"),
    "deepseek-67b": dict(moment_dtype="bfloat16"),
}

COLLECTIVE_REASON = (
    "not measured: collective bytes come only from HLO, which a PyTorch "
    "step does not have (the reference parses its compiled module)")

METRICS = ("ce", "aux", "loss", "lr", "grad_norm", "clip")


def train_config_for(arch: str) -> TrainConfig:
    return TrainConfig(**TRAIN_OVERRIDES.get(arch, {}))


def mesh_config(name: str) -> MeshConfig:
    return MULTI_POD_MESH if name == "multi" else SINGLE_POD_MESH


# ---------------------------------------------------------------------------
# Counting on meta tensors
# ---------------------------------------------------------------------------


class _Tally(TorchDispatchMode):
    """Over the ops run inside it: ``bytes`` each op reads and writes (its
    tensor inputs and outputs; a view op moves nothing), and the peak of
    the live bytes of storage first produced inside it, one a segment
    (:meth:`mark` starts the next; ``peaks``).  An op's output whose
    storage is one of its inputs' (a view, an in-place op) is no new
    storage.  Freed storage leaves the live set when the set is swept,
    which is needed only where the unswept total, an upper bound of the
    live bytes, would pass the segment's peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peaks = [0]

    def mark(self) -> None:
        """Start a segment, its peak from what is live now."""
        self._sweep()
        self.peaks.append(self.live_bytes)

    def _sweep(self):
        gone = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in gone:
            self.live_bytes -= self.live.pop(k)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        fresh = []
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in seen or st._cdata in self.live:
                continue
            seen.add(st._cdata)
            fresh.append((StorageWeakRef(st), st.nbytes()))
        if fresh:
            grown = self.live_bytes + sum(n for _, n in fresh)
            if grown > self.peaks[-1]:
                self._sweep()
            for ref, n in fresh:
                self.live[ref.cdata] = (ref, n)
                self.live_bytes += n
            self.peaks[-1] = max(self.peaks[-1], self.live_bytes)
        return out


def _tensors(tree) -> list:
    """The tensors in an op's arguments or result, in order."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _step_inputs(model, shape):
    """The cell's inputs as meta tensors (``Model.input_specs``)."""
    return {k: v.struct for k, v in model.input_specs(shape).items()}


def count_step(cfg, shape, mesh, tcfg: TrainConfig, *, n_mb: int = 1
               ) -> Dict[str, Any]:
    """Run one step of ``cfg`` at ``shape`` on meta tensors (the whole
    job, not a device's share) inside ``hint_mesh(mesh)``: ``flops`` (the
    counted matrix products), ``bytes`` (the run's eager traffic),
    ``peaks`` (the most live storage allocated inside the step, a phase)
    and ``hints`` (the sharding hints pinned).

    Training runs the whole step over ``min(n_mb, 2)`` microbatches of
    ``shape`` each, so that the gradient accumulator is live as in any
    longer step, in its two phases (``loop.make_train_phases``): the
    gradients, whose peak the activations set at a shallow depth, and
    AdamW's update, whose peak the new state sets at a deep one; each
    grows linearly with depth, so each is extrapolated apart.  ``flops``
    and ``bytes`` are then a microbatch's share (AdamW adds no matrix
    product, and its eager bytes are spread over the microbatches run).
    Otherwise one phase: the prefill, or one decode step against a cache
    of ``shape.seq_len``."""
    model = build_model(cfg, device="meta")
    # the step's arguments are made before the counting starts: they are
    # the cell's argument bytes, not its temporaries
    params = tree_shape_structs(model.param_defs(), model.dtype)
    n_run = min(n_mb, 2) if shape.kind == "train" else 1
    if shape.kind == "train":
        run_shape = dataclasses.replace(
            shape, global_batch=shape.global_batch * n_run)
        state = TrainState(params, adamw.init_structs(params, tcfg), None,
                           torch.empty((), dtype=torch.int32, device="meta"))
        run = RunConfig(model=cfg, shape=run_shape,
                        mesh=MeshConfig((1, 1), ("data", "model")),
                        train=tcfg)
        gradients, apply = make_train_phases(model, run, n_mb=n_run)

        def step(state, batch):
            out = gradients(state, batch)
            tally.mark()
            return apply(state, *out)

        args = (state, _step_inputs(model, run_shape))
    elif shape.kind == "prefill":
        step = model.prefill
        args = (params, _step_inputs(model, shape))
    else:
        caches = tree_shape_structs(
            model.cache_defs(shape.global_batch, shape.seq_len,
                             mode="decode"), model.dtype)

        def step(params, tokens, caches):
            return model.decode_step(params, tokens, caches,
                                     shape.seq_len - 1)

        args = (params, _step_inputs(model, shape)["tokens"], caches)
    # opt_einsum's path search takes ~0.3 s a three-operand einsum, 60
    # times the op itself on meta; the counted products are the same
    # without it (rwkv6's chunk form, checked on its shapes)
    with hint_mesh(mesh) as pins, \
            torch.backends.opt_einsum.flags(enabled=False), \
            FlopCounterMode(display=False) as fc, _Tally() as tally:
        out = step(*args)
        del out
    return {"flops": float(fc.get_total_flops()) / n_run,
            "bytes": float(tally.bytes) / n_run,
            "peaks": [float(p) for p in tally.peaks],
            "hints": len(pins.pins)}


def _calibration_cfgs(cfg):
    """The two calibration depths, two and three layer-pattern units after
    the dense prefix, stacked as ``cfg`` stacks them (so their blocks run
    under the step's remat), and the full model's units."""
    pat = len(cfg.layer_pattern)
    prefix = cfg.first_dense_layers
    small = dataclasses.replace(cfg, num_layers=prefix + 2 * pat)
    big = dataclasses.replace(cfg, num_layers=prefix + 3 * pat)
    n_units = (cfg.num_layers - prefix) / pat
    return small, big, n_units


def _opt_correction(cfg, tcfg, chips) -> ra.CellCost:
    """Analytic per-device optimizer-step cost, subtracted for the extra
    (n_mb − 1) repetitions the extrapolation would otherwise charge."""
    n = cfg.param_count()
    moment_rw = {"float32": 16.0, "bfloat16": 8.0, "int8": 4.0}
    grad_read = {"float32": 4.0, "bfloat16": 2.0}
    bytes_per_param = (4.0                       # param read+write (bf16)
                      + grad_read[tcfg.grad_accum_dtype]
                      + moment_rw[tcfg.moment_dtype])
    return ra.CellCost(flops=12.0 * n / chips,
                       bytes_accessed=bytes_per_param * n / chips,
                       coll_bytes=None, coll_ops=None)


def _cell_cost(counts, cfg, shape, tcfg, chips) -> ra.CellCost:
    """A calibration count as a per-device cost: a training count adds
    AdamW's analytic cost, as the reference's n_mb = 1 module holds it."""
    cost = ra.CellCost(counts["flops"] / chips, counts["bytes"] / chips,
                       None, None)
    if shape.kind == "train":
        cost = cost.plus(_opt_correction(cfg, tcfg, chips))
    return cost


# ---------------------------------------------------------------------------
# Arguments and outputs, exactly
# ---------------------------------------------------------------------------


def _device_bytes(structs, shardings) -> int:
    """Bytes one device holds of a tree of meta tensors placed by a tree
    of :class:`NamedSharding` of the same structure."""
    total = 0
    for t, s in zip(tree_leaves(structs), tree_leaves(shardings),
                    strict=True):
        total += int(np.prod(s.shard_shape(t.shape))) * t.element_size()
    return total


def placed_bytes(cfg, shape, mesh, tcfg: TrainConfig) -> Dict[str, int]:
    """Per-device argument and output bytes of the cell's step from the
    definitions and their specs: parameters, optimizer state and the step
    count, caches, inputs and logits."""
    model = build_model(cfg, device="meta")
    defs = model.param_defs()
    rules = TRAIN_RULES if shape.kind == "train" else serve_rules(cfg)
    params = tree_shape_structs(defs, model.dtype)
    p_shard = tree_shardings(defs, mesh, rules)
    inputs = model.input_specs(shape)
    in_bytes = sum(_device_bytes(
        v.struct, named_sharding(v.logical, mesh, rules, v.struct.shape))
        for v in inputs.values())
    repl = NamedSharding(mesh, ())
    scalar = torch.empty((), dtype=torch.float32, device="meta")
    if shape.kind == "train":
        opt = adamw.init_structs(params, tcfg)
        opt_shard = adamw.state_shardings(p_shard, params, tcfg, mesh,
                                          ("data", "model"))
        state = (_device_bytes(params, p_shard)
                 + _device_bytes(opt, opt_shard) + 4)
        return {"argument_bytes": state + in_bytes,
                "output_bytes": state + len(METRICS) * _device_bytes(
                    scalar, repl)}
    logits = torch.empty((shape.global_batch, cfg.vocab_size),
                         dtype=torch.float32, device="meta")
    out = _device_bytes(logits, named_sharding(
        ("batch", "vocab"), mesh, rules, tuple(logits.shape)))
    mode = "prefill" if shape.kind == "prefill" else "decode"
    cache_defs = model.cache_defs(shape.global_batch, shape.seq_len,
                                  mode=mode)
    cache = _device_bytes(tree_shape_structs(cache_defs, model.dtype),
                          tree_shardings(cache_defs, mesh, rules))
    args = _device_bytes(params, p_shard) + in_bytes
    if shape.kind == "decode":
        args += cache
    return {"argument_bytes": args, "output_bytes": out + cache}


# ---------------------------------------------------------------------------
# Cell execution
# ---------------------------------------------------------------------------


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "false", "True", "False"):
        return k, v.lower() == "true"
    return k, v


def dry_run(cfg, shape, mesh_cfg: MeshConfig, tcfg: TrainConfig, *,
            calibrate: bool = True) -> Dict[str, Any]:
    """One cell of ``cfg`` at ``shape`` on the mesh ``mesh_cfg`` names:
    the reference's ``run_cell`` keys (``memory``, ``fits_hbm``,
    ``validation_cost``, and with ``calibrate`` ``calibration`` and
    ``roofline``), every number per device."""
    mesh = make_mesh(mesh_cfg)
    chips = mesh_cfg.num_devices
    run = RunConfig(model=cfg, shape=shape, mesh=mesh_cfg, train=tcfg)
    n_mb = run.microbatches()
    if shape.kind == "train":
        mb_shape = dataclasses.replace(
            shape, global_batch=max(mesh_cfg.dp_size,
                                    shape.global_batch // n_mb))
    else:
        mb_shape = shape

    t0 = time.perf_counter()
    placed = placed_bytes(cfg, shape, mesh, tcfg)
    t1 = time.perf_counter()
    small, big, n_units = _calibration_cfgs(cfg)
    counts = {name: count_step(c, mb_shape, mesh, tcfg, n_mb=n_mb)
              for name, c in (("2u", small), ("3u", big))}
    t2 = time.perf_counter()

    # the temporaries: each phase's peak linear in units from the two
    # depths, the larger of them at the model's
    temp = max(p2 + (n_units - 2) * (p3 - p2) for p2, p3 in zip(
        counts["2u"]["peaks"], counts["3u"]["peaks"])) / chips
    mem = {
        "argument_bytes": placed["argument_bytes"],
        "output_bytes": placed["output_bytes"],
        # the step's own storage, its outputs as they are made included,
        # so the outputs alias within it
        "temp_bytes": int(round(temp)),
        "alias_bytes": placed["output_bytes"],
        "code_bytes": None,
    }
    mem["peak_bytes"] = (mem["argument_bytes"] + mem["temp_bytes"]
                         + mem["output_bytes"] - mem["alias_bytes"])
    c2 = _cell_cost(counts["2u"], small, mb_shape, tcfg, chips)
    c3 = _cell_cost(counts["3u"], big, mb_shape, tcfg, chips)
    c1 = c2.minus(c3.minus(c2))          # the 1-unit cost, by linearity
    corr = (_opt_correction(cfg, tcfg, chips)
            if shape.kind == "train" else None)
    total = ra.extrapolate(c1, c2, n_units,
                           n_repeat=n_mb, per_repeat_correction=corr)
    result = dict(
        status="ok",
        lower_s=round(t1 - t0, 2),
        compile_s=round(t2 - t1, 2),
        n_mb=n_mb,
        memory=mem,
        fits_hbm=bool(mem["peak_bytes"] <= hw.HBM_BYTES),
        validation_cost={"flops": total.flops,
                         "bytes": total.bytes_accessed,
                         "coll_bytes": None, "coll_ops": None},
        hints=counts["3u"]["hints"],
        reasons={"coll_bytes": COLLECTIVE_REASON,
                 "coll_ops": COLLECTIVE_REASON,
                 "collective_s": COLLECTIVE_REASON,
                 "code_bytes": "not measured: no compiled artifact",
                 "memory_s_xla_cpu_raw": "no XLA CPU module: "
                                         "memory_s_eager_raw is the port's "
                                         "counted bytes"},
    )
    if calibrate:
        model_bytes = rt.memory_traffic(cfg, shape, mesh_cfg, n_mb=n_mb,
                                        tcfg=tcfg)
        with_model = rt.cost_with_model_memory(total, model_bytes)
        mf = ra.model_flops_per_step(cfg, shape)
        terms = ra.roofline(with_model, chips=chips, model_flops=mf)
        result["calibration"] = {
            "n_units": n_units, "n_mb": n_mb,
            "cost_1u": dataclasses.asdict(c1),
            "cost_2u": dataclasses.asdict(c2),
            "cost_3u": dataclasses.asdict(c3),
            "total": dataclasses.asdict(total),
        }
        result["roofline"] = terms.as_dict()
        result["roofline"]["memory_s_xla_cpu_raw"] = None
        result["roofline"]["memory_s_eager_raw"] = (
            total.bytes_accessed / hw.HBM_BW)
        result["roofline"]["model_traffic_bytes"] = model_bytes
    return result


def run_cell(arch: str, shape_name: str, mesh_name: str,
             calibrate: bool = True, mcfg_overrides=(), tcfg_overrides=()
             ) -> dict:
    cfg = get_config(arch)
    if mcfg_overrides:
        cfg = dataclasses.replace(
            cfg, **dict(_parse_override(o) for o in mcfg_overrides))
    if tcfg_overrides:
        TRAIN_OVERRIDES[arch] = dict(
            TRAIN_OVERRIDES.get(arch, {}),
            **dict(_parse_override(o) for o in tcfg_overrides))
    shape = SHAPES[shape_name]
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name}

    if shape_name == "long_500k" and not cfg.is_sub_quadratic():
        result.update(status="skipped",
                      reason="full-attention arch: 500k dense decode is "
                             "quadratic; run only for SSM/hybrid")
        return result

    result.update(dry_run(cfg, shape, mesh_config(mesh_name),
                          train_config_for(arch),
                          calibrate=calibrate and mesh_name == "single"))
    mem = result["memory"]
    print(f"[{arch} {shape_name} {mesh_name}] counted on meta in "
          f"{result['compile_s']:.1f}s: args="
          f"{mem['argument_bytes'] / 2**30:.2f}GiB "
          f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
          f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
          f"fits_{hw.HBM_BYTES / 2**30:.1f}GiB={result['fits_hbm']}")
    if "roofline" in result:
        r = result["roofline"]
        print(f"  roofline: compute={r['compute_s']:.4f}s "
              f"memory={r['memory_s']:.4f}s (eager raw "
              f"{r['memory_s_eager_raw']:.2f}s) collective=null "
              f"dominant={r['dominant']} useful={r['useful_ratio']:.2f}")
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def cell_list():
    for arch in LM_ARCHS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run on meta "
                                             "tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="drive the full sweep in per-cell subprocesses")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--mcfg", action="append", default=[],
                    help="model-config override key=value")
    ap.add_argument("--tcfg", action="append", default=[],
                    help="train-config override key=value")
    ap.add_argument("--tag", default="",
                    help="suffix for the output file name")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = (("single", "multi") if args.mesh == "both"
              else (args.mesh,))

    if args.all:
        failures = []
        for arch, shape in cell_list():
            for mesh in meshes:
                out_file = os.path.join(
                    args.out, f"{arch}_{shape}_{mesh}.json")
                if os.path.exists(out_file):
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", args.out]
                if args.no_calibrate:
                    cmd.append("--no-calibrate")
                rc = subprocess.run(cmd).returncode
                if rc != 0:
                    failures.append((arch, shape, mesh, rc))
        print("sweep complete; failures:", failures or "none")
        return 1 if failures else 0

    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape are required without --all")
    ok = True
    for mesh in meshes:
        try:
            res = run_cell(args.arch, args.shape, mesh,
                           calibrate=not args.no_calibrate,
                           mcfg_overrides=args.mcfg,
                           tcfg_overrides=args.tcfg)
            res["overrides"] = {"mcfg": args.mcfg, "tcfg": args.tcfg}
        except Exception as e:      # noqa: BLE001
            traceback.print_exc()
            res = {"arch": args.arch, "shape": args.shape, "mesh": mesh,
                   "status": "error", "reason": repr(e)}
            ok = False
        suffix = f"_{args.tag}" if args.tag else ""
        out_file = os.path.join(
            args.out, f"{args.arch}_{args.shape}_{mesh}{suffix}.json")
        with open(out_file, "w") as f:
            json.dump(res, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
