"""The benchmark's frozen counts: the analytic FLOPs against the dry run's
``6·N·D`` (every gap explained), and the kernels' least times against
``chip_smoke.py``'s at the shapes PERF.md reports."""

from __future__ import annotations

import json

import pytest
import torch

from h100bench import core
from repro_torch.config.base import ShapeConfig
from repro_torch.roofline.analysis import model_flops_per_step

from _tiny import HERE


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _mix(name):
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def _counts(name):
    return core.load_module(HERE / "counts" / f"{name}.py")


def test_rwkv6_train_flops_against_the_dry_run():
    """The dry run counts 6 a parameter and token; the benchmark leaves out
    the embedding (a lookup) and every vector leaf (norm scales, token-shift
    mixes, decay bias, bonus: elementwise work), 11 vectors of d a layer."""
    cfg, mix = _config("rwkv6-7b"), _mix("train-4k")
    mc = core.model_config(cfg)
    tokens = mix["batch"] * mix["seq_len"]
    dry = model_flops_per_step(mc, ShapeConfig("t", "train", mix["seq_len"],
                                               mix["batch"]))
    mine = _counts("rwkv6").train_flops(cfg, mix)
    d, v, n = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    assert dry - mine == pytest.approx(6.0 * tokens * (v * d + 11 * d * n),
                                       rel=1e-12)
    assert mine == pytest.approx(6 * 2_021_654_528 * tokens, rel=1e-12)
    assert 198e12 < mine < 199e12


def test_llama_prefill_flops_against_the_dry_run():
    """The dry run counts 2 a parameter and token; the benchmark leaves out
    the embedding and the norm scales, applies the head at each prompt's
    last position only (as ``Model.prefill`` does) and adds causal
    attention's two products."""
    cfg, mix = _config("deepseek-7b"), _mix("serve-4k")
    mc = core.model_config(cfg)
    b, p = mix["batch"], mix["prompt_len"]
    dry = model_flops_per_step(mc, ShapeConfig("p", "prefill", p, b))
    mine = _counts("llama").prefill_flops(cfg, mix)
    d, v, n = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    hd, h = cfg["head_dim"], cfg["num_heads"]
    attention = 4.0 * hd * h * (p * (p + 1) // 2) * n * b
    left_out = 2.0 * b * p * (v * d + 2 * d * n) + 2.0 * v * d * (b * p - b)
    assert dry - mine == pytest.approx(left_out - attention, rel=1e-9)
    assert 426e12 < mine < 428e12


def test_decode_bytes_count_weights_and_the_filled_int8_cache():
    cfg, mix = _config("deepseek-7b"), _mix("serve-4k")
    got = _counts("llama").decode_step_bytes(cfg, mix)
    weights = 2 * (30 * (4 * 4096 ** 2 + 3 * 4096 * 11008) + 4096 * 102400
                   + 8 * 4096)
    cache = 30 * 8 * (4064 + 16.5) * 2 * 32 * (128 + 4)
    assert got == pytest.approx(weights + cache, rel=1e-12)


def _view(shape, dtype):
    return torch.empty(1, dtype=dtype).expand(*shape)


@pytest.mark.parametrize("shape", [(4, 64, 1024, 64), (1, 64, 4096, 64)])
def test_rwkv6_counts_are_chip_smokes(shape):
    import chip_smoke
    r, lw = _view(shape, torch.bfloat16), _view(shape, torch.float32)
    b, h, s, hd = shape
    fwd = _counts("rwkv6_chunked").bound_s(b, h, s, hd, 64)
    bwd = _counts("rwkv6_chunked_bwd").bound_s(b, h, s, hd, 64)
    assert fwd * 1e3 == pytest.approx(chip_smoke._rwkv6_bound(r, lw, 64)[0],
                                      rel=1e-12)
    assert bwd * 1e3 == pytest.approx(
        chip_smoke._rwkv6_bwd_bound(r, lw, 64)[0], rel=1e-12)


@pytest.mark.parametrize("bh,s,hd,window", [(128, 4064, 128, 0),
                                            (256, 4064, 128, 0),
                                            (48, 2048, 64, 512)])
def test_flash_attention_count_is_chip_smokes(bh, s, hd, window):
    import chip_smoke
    q = _view((bh, s, hd), torch.bfloat16)
    (want_ms, _), pairs = chip_smoke._flash_bound(q, q, True, window, 1)
    count = _counts("flash_attention")
    assert count.pairs(s, s, True, window) * bh == pairs
    assert count.bound_s(bh, s, s, hd, window=window) * 1e3 == pytest.approx(
        want_ms, rel=1e-12)
