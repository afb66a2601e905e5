"""The port's roofline accounting (``repro_torch.roofline``) on the CPU:
the reference's seven ``tests/test_roofline.py`` tests ported (the
interconnect term against the H100's NVLink figure), then the pure
arithmetic held against the reference's: ``model_flops_per_step`` and
``memory_traffic`` for every LM arch × shape × mesh, and
``collective_bytes`` / ``profile_text`` on the same HLO text.  The
arithmetic is the same, so every comparison is exact."""

import pytest

from repro.config import SHAPES as REF_SHAPES
from repro.config import get_config as ref_get_config
from repro.config.base import MeshConfig as RefMeshConfig
from repro.config.base import TrainConfig as RefTrainConfig
from repro.config import ARCH_IDS as REF_ARCH_IDS
from repro.roofline import analysis as ref_ra
from repro.roofline import collprofile as ref_cp
from repro.roofline import traffic as ref_rt
from repro_torch.config import (ARCH_IDS, MULTI_POD_MESH, SHAPES,
                                SINGLE_POD_MESH, MeshConfig, TrainConfig,
                                get_config)
from repro_torch.roofline import (CellCost, collective_bytes, extrapolate,
                                  hw, model_flops_per_step, roofline)
from repro_torch.roofline import collprofile
from repro_torch.roofline.traffic import memory_traffic

HLO = """
  %ag = bf16[8,1024]{1,0} all-gather(%p0), replica_groups=...
  %ar.1 = f32[256]{0} all-reduce(%x), to_apply=%sum
  %ags = (bf16[8,1024]{1,0}, bf16[8,1024]{1,0}) all-gather-start(%p1)
  %agd = bf16[8,1024]{1,0} all-gather-done(%ags)
  %rs = f32[64,32]{1,0} reduce-scatter(%y), dimensions={0}
  %cp = bf16[4,4]{1,0} collective-permute(%z), source_target_pairs=...
  %a2a = f32[16,16]{1,0} all-to-all(%w), dimensions={0}
  %dot = f32[128,128]{1,0} dot(%a, %b)
"""
# the configurations both registries hold (the port's deepseek-v2-lite
# has no reference to compare with)
LM_ARCHS = [a for a in ARCH_IDS
            if a != "paper-subsample" and a in REF_ARCH_IDS]


def test_collective_parsing_kinds_and_bytes():
    out = collective_bytes(HLO)
    assert out["all-gather"] == 8 * 1024 * 2 + 2 * 8 * 1024 * 2  # ag + start
    assert out["all-reduce"] == 256 * 4
    assert out["reduce-scatter"] == 64 * 32 * 4
    assert out["collective-permute"] == 16 * 2
    assert out["all-to-all"] == 16 * 16 * 4
    # -done is not double counted; dot is not a collective
    assert out["ops"] == 6


def test_extrapolation_math():
    c1 = CellCost(10.0, 100.0, 5.0, 1)    # nonlayer 4 + 1 unit of 6
    c2 = CellCost(16.0, 150.0, 7.0, 2)    # nonlayer + 2 units
    total = extrapolate(c1, c2, n_units=10)
    assert total.flops == pytest.approx(4 + 10 * 6)
    assert total.bytes_accessed == pytest.approx(50 + 10 * 50)
    assert total.coll_bytes == pytest.approx(3 + 10 * 2)


def test_extrapolation_with_microbatches_and_correction():
    c1 = CellCost(10.0, 100.0, 5.0, 1)
    c2 = CellCost(16.0, 150.0, 7.0, 2)
    corr = CellCost(1.0, 10.0, 0.0, 0)
    total = extrapolate(c1, c2, n_units=10, n_repeat=4,
                        per_repeat_correction=corr)
    assert total.flops == pytest.approx(64 * 4 - 3 * 1.0)
    assert total.bytes_accessed == pytest.approx(550 * 4 - 3 * 10.0)


def test_roofline_terms_and_dominance():
    cost = CellCost(flops=hw.PEAK_FLOPS_BF16,          # 1s compute
                    bytes_accessed=hw.HBM_BW / 2,       # 0.5s memory
                    coll_bytes=hw.NVLINK_LINK_BW / 4,   # 0.25s collective
                    coll_ops=10)
    rt = roofline(cost, chips=256, model_flops=hw.PEAK_FLOPS_BF16 * 128)
    assert rt.dominant == "compute"
    assert rt.compute_s == pytest.approx(1.0)
    assert rt.memory_s == pytest.approx(0.5)
    assert rt.collective_s == pytest.approx(0.25)
    assert rt.useful_ratio == pytest.approx(0.5)


def test_model_flops_dense_vs_moe():
    dense = get_config("deepseek-7b")
    moe = get_config("arctic-480b")
    shape = SHAPES["train_4k"]
    f_dense = model_flops_per_step(dense, shape)
    tokens = shape.global_batch * shape.seq_len
    assert f_dense == pytest.approx(6 * dense.param_count() * tokens)
    f_moe = model_flops_per_step(moe, shape)
    assert f_moe == pytest.approx(6 * moe.active_param_count() * tokens)
    assert f_moe < 6 * moe.param_count() * tokens * 0.1


def test_traffic_model_scales_sanely():
    cfg = get_config("qwen2-72b")
    t_train = memory_traffic(cfg, SHAPES["train_4k"], SINGLE_POD_MESH,
                             n_mb=16, tcfg=TrainConfig())
    t_decode = memory_traffic(cfg, SHAPES["decode_32k"], SINGLE_POD_MESH)
    # decode reads params once; train re-gathers per microbatch + optimizer
    assert t_train > t_decode
    # decode must be dominated by params+cache, of plausible magnitude
    p_read = cfg.param_count() * 2 / SINGLE_POD_MESH.tp_size
    assert t_decode > p_read
    assert t_decode < 20 * p_read


def test_traffic_model_decode_moe_reads_less_than_dense_equivalent():
    moe = get_config("deepseek-moe-16b")
    t = memory_traffic(moe, SHAPES["decode_32k"], SINGLE_POD_MESH)
    full = moe.param_count() * 2 / SINGLE_POD_MESH.tp_size
    active_bound = (SHAPES["decode_32k"].global_batch
                    * moe.active_param_count() * 2 / SINGLE_POD_MESH.tp_size)
    assert t <= full + active_bound + 2**34


# -- the port's own: no collective measured ----------------------------------


def test_roofline_without_collective_bytes_is_null_not_zero():
    """A cost with no collective count keeps ``None`` through the
    arithmetic, and the dominant term is chosen between the other two."""
    c1 = CellCost(10.0, 100.0, None, None)
    c2 = CellCost(16.0, 150.0, None, None)
    total = extrapolate(c1, c2, n_units=10, n_repeat=4,
                        per_repeat_correction=CellCost(1.0, 10.0, None,
                                                       None))
    assert total.coll_bytes is None and total.coll_ops is None
    rt = roofline(CellCost(hw.PEAK_FLOPS_BF16, hw.HBM_BW * 2, None, None),
                  chips=256, model_flops=1.0)
    assert rt.collective_s is None and rt.dominant == "memory"


def test_collprofile_main_refuses_without_hlo(capsys):
    assert collprofile.main(["--arch", "qwen2-72b",
                             "--shape", "train_4k"]) != 0
    assert "no collective profile" in capsys.readouterr().err


def test_hw_holds_the_h100s_figures():
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BW == 3.35e12
    assert hw.NVLINK_LINK_BW == 50e9
    assert 80e9 <= hw.HBM_BYTES < 2**37
    assert (hw.SINGLE_POD_CHIPS, hw.MULTI_POD_CHIPS) == (256, 512)


# -- the arithmetic against the reference's ----------------------------------


def _ref_mesh(mesh):
    return RefMeshConfig(mesh.shape, mesh.axis_names)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_and_traffic_equal_the_references(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape_name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[shape_name]
        assert model_flops_per_step(cfg, shape) == \
            ref_ra.model_flops_per_step(ref_cfg, ref_shape)
        for mesh in (SINGLE_POD_MESH, MULTI_POD_MESH, MeshConfig((1, 1))):
            for n_mb in (1, 16):
                for moment in ("float32", "bfloat16", "int8"):
                    got = memory_traffic(
                        cfg, shape, mesh, n_mb=n_mb,
                        tcfg=TrainConfig(moment_dtype=moment))
                    want = ref_rt.memory_traffic(
                        ref_cfg, ref_shape, _ref_mesh(mesh), n_mb=n_mb,
                        tcfg=RefTrainConfig(moment_dtype=moment))
                    assert got == want, (shape_name, mesh, n_mb, moment)


def test_the_port_only_config_in_the_arithmetic():
    """``deepseek-v2-lite``, which the reference lacks: 2 FLOPs an active
    parameter and token, and the decode traffic reads its latent cache of
    576 bf16 values a token and layer."""
    from repro_torch.roofline.traffic import _cache_bytes_per_chip
    cfg = get_config("deepseek-v2-lite")
    shape = SHAPES["prefill_32k"]
    assert model_flops_per_step(cfg, shape) == (
        2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len)
    assert _cache_bytes_per_chip(cfg, 128, 32768, 1) == (
        27 * 128 * 32768 * 576 * 2)
    decode = SHAPES["decode_32k"]
    assert memory_traffic(cfg, decode, SINGLE_POD_MESH) > (
        _cache_bytes_per_chip(cfg, 128, 32768, 256))


def test_collective_parsers_equal_the_references():
    assert collective_bytes(HLO) == ref_ra.collective_bytes(HLO)
    assert collprofile.profile_text(HLO) == ref_cp.profile_text(HLO)
