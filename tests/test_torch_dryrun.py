"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: a cell's
step run on ``meta`` tensors, counted and sized.

* One layer-pattern unit's counted FLOPs equal a hand count from the
  config's shapes: ``deepseek-7b`` training (remat full) and
  ``recurrentgemma-2b`` prefill, at full width and a short sequence.  The
  counter takes ``2·m·n·k`` a matrix product, so the two agree exactly
  (tolerance 1e-9 relative, for the float sums).
* ``extrapolate`` of two depths' counts equals the count of a third
  depth, FLOPs exactly, as the reference's arithmetic assumes.
* Per-device argument bytes equal those computed from the reference's own
  parameter, optimizer-state, cache and input structs and its specs on
  the production meshes (the reference's ``NamedSharding.shard_shape`` on
  an ``AbstractMesh``), for every LM arch: integers, exactly.
* The CLI writes the reference's JSON keys, with the collective terms
  ``null`` and a reason, and the port's ``report`` reads the cells.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.config import ARCH_IDS as REF_ARCH_IDS
from repro.config import SHAPES as REF_SHAPES
from repro.config import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.parallel import sharding as ref_sh
from repro_torch.config import (ARCH_IDS, SHAPES, SINGLE_POD_MESH,
                                ShapeConfig, TrainConfig, get_config)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh as pmesh
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import report

# the configurations both registries hold (the port's deepseek-v2-lite
# has no reference to compare with)
LM_ARCHS = [a for a in ARCH_IDS
            if a != "paper-subsample" and a in REF_ARCH_IDS]
REL = 1e-9
MESH = make_mesh(SINGLE_POD_MESH)


def _depth(cfg, units):
    return dataclasses.replace(
        cfg, num_layers=cfg.first_dense_layers
        + units * len(cfg.layer_pattern))


def _flops(cfg, shape, units, tcfg=TrainConfig()):
    return dryrun.count_step(_depth(cfg, units), shape, MESH, tcfg)["flops"]


def test_one_unit_of_deepseek_7b_training_is_the_hand_count():
    """Per layer and microbatch, with T = B·S tokens and a = 2·H·S²·hd
    (one score-sized product, causal masking counted in full by the plain
    versions): the projections and SwiGLU, ``lin = 2T(4d² + 3d·ff)``,
    run forward twice (remat full) and backward once (two products
    each), except that the recomputation stops before the block's last
    product, the MLP's down projection (``2T·ff·d``), whose output the
    backward does not need (``torch.utils.checkpoint`` stops early);
    attention's forward takes three products (QKᵀ and PV, QKᵀ again for
    the log-sum-exp), twice, and its backward five (QKᵀ, dO Vᵀ, dQ, dK,
    dV): ``4·lin − 2T·ff·d + 11·a``."""
    cfg = get_config("deepseek-7b")
    assert cfg.remat == "full" and cfg.q_dim == cfg.kv_dim == cfg.d_model
    b, s = 1, 256
    shape = ShapeConfig("t", "train", s, b)
    per_unit = _flops(cfg, shape, 3) - _flops(cfg, shape, 2)
    t, d, ff = b * s, cfg.d_model, cfg.d_ff
    lin = 2 * t * (4 * d * d + 3 * d * ff)
    a = 2 * b * cfg.num_heads * s * s * cfg.head_dim
    assert per_unit == pytest.approx(4 * lin - 2 * t * ff * d + 11 * a,
                                     rel=REL)


def test_one_unit_of_recurrentgemma_2b_prefill_is_the_hand_count():
    """A unit is RG-LRU, RG-LRU, local attention, each with a gated MLP
    (3 products of d × ff).  An RG-LRU block takes three products (w_x,
    w_y of d × W, w_out of W × d; the conv, gates and scan are
    elementwise); the local block its projections (q and o of d × H·hd, k
    and v of d × hd: one KV head) and QKᵀ and PV over every (query, key)
    pair of the 10 query heads (the window of 2,048 masks nothing at S =
    256)."""
    cfg = get_config("recurrentgemma-2b")
    b, s = 1, 256
    shape = ShapeConfig("p", "prefill", s, b)
    per_unit = _flops(cfg, shape, 3) - _flops(cfg, shape, 2)
    t, d, ff, w = b * s, cfg.d_model, cfg.d_ff, cfg.lru_dim
    hq, hd = cfg.num_heads, cfg.head_dim
    mlp = 3 * 2 * t * 3 * d * ff
    rg = 2 * (2 * t * 3 * d * w)
    local = 2 * t * d * (2 * hq * hd + 2 * cfg.num_kv_heads * hd)
    att = 2 * (2 * b * hq * s * s * hd)
    assert per_unit == pytest.approx(mlp + rg + local + att, rel=REL)


@pytest.mark.parametrize("arch,shape", [
    ("musicgen-medium", ShapeConfig("p", "prefill", 128, 2)),
    ("deepseek-moe-16b", ShapeConfig("d", "decode", 256, 4)),
])
def test_extrapolation_from_one_and_two_units_is_three(arch, shape):
    cfg = get_config(arch)
    c = {u: ra.CellCost(_flops(cfg, shape, u), 0.0, None, None)
         for u in (1, 2, 3)}
    total = ra.extrapolate(c[1], c[2], 3)
    assert total.flops == pytest.approx(c[3].flops, rel=REL)


def test_extrapolation_of_a_training_step_with_remat():
    """Training stacks its blocks under remat only from two units on: the
    calibration depths (two and three units) extrapolate to four."""
    cfg = get_config("musicgen-medium")
    shape = ShapeConfig("t", "train", 128, 2)
    small, big, _ = dryrun._calibration_cfgs(cfg)
    c2 = ra.CellCost(_flops(cfg, shape, 2), 0.0, None, None)
    c3 = ra.CellCost(_flops(cfg, shape, 3), 0.0, None, None)
    assert (small.num_layers, big.num_layers) == (2, 3)
    c1 = c2.minus(c3.minus(c2))
    assert ra.extrapolate(c1, c2, 4).flops == pytest.approx(
        _flops(cfg, shape, 4), rel=REL)


@pytest.mark.parametrize("arch", ("musicgen-medium", "recurrentgemma-2b"))
def test_a_training_steps_peak_extrapolates_by_phase(arch):
    """A training step's peak live storage, each phase's (the gradients',
    the update's) extrapolated from two and three units, is the peak
    counted at six units: the update's phase, which the new state and
    the accumulator set, is linear in depth exactly and wins there."""
    cfg = get_config(arch)
    shape = ShapeConfig("t", "train", 256, 2)
    peaks = {u: dryrun.count_step(_depth(cfg, u), shape, MESH,
                                  TrainConfig(), n_mb=4)["peaks"]
             for u in (2, 3, 6)}
    extrapolated = max(p2 + 4 * (p3 - p2)
                       for p2, p3 in zip(peaks[2], peaks[3]))
    assert extrapolated == max(peaks[6]) == peaks[6][1]


# -- argument bytes against the reference's specs ------------------------------


def _ref_nbytes(structs, shardings) -> int:
    leaves = jax.tree.leaves(structs)
    shards = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
        x, jax.sharding.NamedSharding))
    assert len(leaves) == len(shards)
    return sum(int(np.prod(s.shard_shape(t.shape))) * t.dtype.itemsize
               for t, s in zip(leaves, shards))


def _ref_argument_bytes(arch, shape_name, multi):
    """The argument set of the reference's ``lower_cell``, sized by its
    specs on an abstract production mesh."""
    from repro.config.base import TrainConfig as RefTrainConfig
    cfg = ref_get_config(arch)
    shape = REF_SHAPES[shape_name]
    mesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
            else AbstractMesh((16, 16), ("data", "model")))
    model = ref_build_model(cfg)
    defs = model.param_defs()
    rules = (ref_sh.TRAIN_RULES if shape.kind == "train"
             else ref_sh.serve_rules(cfg))
    p_structs = ref_sh.tree_shape_structs(defs, model.dtype)
    p_shard = ref_sh.tree_shardings(defs, mesh, rules)
    total = _ref_nbytes(p_structs, p_shard)
    for v in model.input_specs(shape).values():
        total += _ref_nbytes(v.struct, ref_sh.named_sharding(
            v.logical, mesh, rules, v.struct.shape))
    if shape.kind == "train":
        tcfg = RefTrainConfig(**dryrun.TRAIN_OVERRIDES.get(arch, {}))
        total += _ref_nbytes(
            ref_adamw.init_structs(p_structs, tcfg),
            ref_adamw.state_shardings(p_shard, p_structs, tcfg, mesh,
                                      ("data", "model")))
        total += 4                                  # the step count
    elif shape.kind == "decode":
        cache = model.cache_defs(shape.global_batch, shape.seq_len,
                                 mode="decode")
        total += _ref_nbytes(ref_sh.tree_shape_structs(cache, model.dtype),
                             ref_sh.tree_shardings(cache, mesh, rules))
    return total


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_argument_bytes_equal_the_references(arch):
    cfg = get_config(arch)
    for shape_name in SHAPES:
        for multi in (False, True):
            got = dryrun.placed_bytes(
                cfg, SHAPES[shape_name], pmesh(multi_pod=multi),
                dryrun.train_config_for(arch))["argument_bytes"]
            assert got == _ref_argument_bytes(arch, shape_name, multi), (
                shape_name, multi)


def test_the_port_only_config_is_counted():
    """``deepseek-v2-lite``, which the reference lacks, through the dry
    run's placement: every cell's bytes, and a decode cell's outputs (the
    logits and the new caches) hold the latent cache
    (``kv_lora_rank + qk_rope_head_dim`` bf16 values a token and layer),
    split over the 256 chips."""
    arch = "deepseek-v2-lite"
    cfg = get_config(arch)
    tcfg = dryrun.train_config_for(arch)
    got = {name: dryrun.placed_bytes(cfg, SHAPES[name],
                                     pmesh(multi_pod=False), tcfg)
           for name in SHAPES}
    assert all(v["argument_bytes"] > 0 for v in got.values())
    decode = SHAPES["decode_32k"]
    latent = (cfg.num_layers * decode.global_batch * decode.seq_len
              * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2)
    logits = decode.global_batch * cfg.vocab_size * 4
    out = got["decode_32k"]["output_bytes"] * 256
    assert latent <= out <= latent + logits


# -- the CLI and the report ----------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s",
            "n_mb", "memory", "fits_hbm", "validation_cost", "calibration",
            "roofline", "overrides"}
REF_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "code_bytes", "peak_bytes"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
                "model_flops", "hlo_flops_total", "useful_ratio",
                "memory_s_xla_cpu_raw", "model_traffic_bytes"}


def test_cli_writes_the_references_keys_and_report_reads_them(tmp_path):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "musicgen-medium", "--shape",
                        "decode_32k", "--mesh", "both", "--out", out]) == 0
    assert dryrun.main(["--arch", "musicgen-medium", "--shape", "long_500k",
                        "--mesh", "single", "--out", out]) == 0
    with open(tmp_path / "musicgen-medium_decode_32k_single.json") as f:
        cell = json.load(f)
    assert REF_KEYS <= set(cell) and cell["status"] == "ok"
    assert REF_MEMORY <= set(cell["memory"])
    assert REF_ROOFLINE <= set(cell["roofline"])
    for key in ("coll_bytes", "coll_ops"):
        assert cell["validation_cost"][key] is None
        assert cell["reasons"][key]
    assert cell["roofline"]["collective_s"] is None
    assert cell["roofline"]["dominant"] in ("compute", "memory")
    with open(tmp_path / "musicgen-medium_decode_32k_multi.json") as f:
        multi = json.load(f)
    assert "roofline" not in multi and multi["status"] == "ok"
    with open(tmp_path / "musicgen-medium_long_500k_single.json") as f:
        assert json.load(f)["status"] == "skipped"
    cells = report.load_cells(out)
    assert len(cells) == 3
    dry = report.dryrun_table(cells)
    assert dry.count("musicgen-medium") == 3 and "skipped" in dry
    roof = report.roofline_table(cells)
    assert "| musicgen-medium | decode_32k |" in roof and "n/a" in roof
    assert "musicgen-medium decode_32k" in report.perf_table(cells)


def test_a_cell_fits_and_its_numbers_are_per_device():
    """musicgen-medium's train_4k cell: its parameters' bytes on the
    single-pod mesh are at most a 256th of the whole (more only where a
    leaf falls back to replication), and its peak fits the card."""
    cell = dryrun.run_cell("musicgen-medium", "train_4k", "single")
    cfg = get_config("musicgen-medium")
    mem = cell["memory"]
    assert cell["fits_hbm"] and mem["peak_bytes"] > mem["argument_bytes"]
    whole = cfg.param_count() * 2 * 5          # bf16 params, fp32 mu, nu
    assert whole / 256 < mem["argument_bytes"] < whole / 16
    assert cell["calibration"]["n_units"] == cfg.num_layers
    assert cell["roofline"]["useful_ratio"] < 1.0
    assert cell["validation_cost"]["flops"] * 256 == pytest.approx(
        cell["roofline"]["hlo_flops_total"])
