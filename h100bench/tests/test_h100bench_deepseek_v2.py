"""The DeepSeek-V2 cell at a size a CPU test can hold: its counts against
hand counts, a sound run correct, and runs with a fault planted in the
port's latent attention, RoPE or routing come out as not correct, or are
named here as not caught.

The tiny configuration keeps the cell's structure and the widths of its
hidden state and of a head (2,048; latent 512, q and k 192, v 128): one
dense layer, then latent attention with a shared roped key and YaRN
(ramped over ``original_max_position_embeddings`` 16 at factor 4, so that
prompts of 40 reach past it), and a dropless MoE of 8 experts, top 2 by
softmax, not renormalised, with one shared expert; 2 heads, 3 layers and
512 tokens of vocabulary; fp32, so that the port's plain versions and the
reference compute one function.  The widths matter: through the seed's
N(0, 0.02) weights a product's output grows with the width it sums over,
and at a hidden size of 64 scores and logits are so flat that none of the
three faults below moved a served token."""

from __future__ import annotations

import json
import math

import pytest
import torch

import _tiny
from h100bench import core

CELL = "dsv2-tiny.serve-long-tiny"
REAL = "deepseek-v2-lite.serve-32k"
BASE = json.loads((_tiny.HERE / "configs" / "deepseek-v2-lite.json")
                  .read_text())
TINY = dict(
    BASE, name="dsv2-tiny", num_layers=3, num_heads=2, num_kv_heads=2,
    d_ff=256, vocab_size=512, num_experts=8, moe_top_k=2,
    num_shared_experts=1, moe_d_ff=256, first_dense_d_ff=512,
    moe_seq_chunk=24, dtype="float32",
    rope_scaling=dict(BASE["rope_scaling"], factor=4,
                      original_max_position_embeddings=16))
MIX = {"kind": "serve_batch", "batch": 4, "prompt_len": 40,
       "new_tokens": 12, "checked": 4}
# the sound runs' widest gap is under 1e-5 at this size (fp32 on both
# sides), as the llama tiny cell's; the limit is that cell's
LIMITS = {"logit_gap": 1e-3}


def make_root(tmp):
    root = _tiny.make_root(tmp)
    home = root / "h100bench"
    (home / "configs" / "dsv2-tiny.json").write_text(json.dumps(TINY))
    (home / "mixes" / "serve-long-tiny.json").write_text(json.dumps(MIX))
    (home / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dsv2-tiny", "source": BASE["source"],
                            "file": "h100bench/configs/dsv2-tiny.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": CELL, "config": "dsv2-tiny",
                              "traffic": "serve-long-tiny", "chips": 1,
                              "why": "tiny"})
    for section in ("end_to_end", "per_layer"):
        for m in spec[section]:
            if REAL in m.get("workloads", ()):
                m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("dsv2"))


def _counts(name):
    return core.load_module(_tiny.HERE / "counts" / f"{name}.py")


# -- counts -------------------------------------------------------------------


def test_prefill_flops_by_hand():
    """One dense layer and one MoE layer at hand-sized widths."""
    cfg = {"d_model": 4, "num_heads": 2, "kv_lora_rank": 3,
           "qk_nope_head_dim": 2, "qk_rope_head_dim": 2, "v_head_dim": 1,
           "num_layers": 2, "first_dense_layers": 1, "first_dense_d_ff": 5,
           "num_experts": 4, "moe_top_k": 2, "moe_d_ff": 3,
           "num_shared_experts": 1, "vocab_size": 7}
    mix = {"batch": 2, "prompt_len": 3}
    # attention: wq 4·2·4 + w_kva 4·5 + w_kvb 3·2·3 + wo 2·1·4 = 32+20+18+8
    att = 78
    dense = 3 * 4 * 5
    moe = 4 * 4 + 2 * (3 * 4 * 3) + 1 * (3 * 4 * 3)       # router, 2 + 1
    tokens = 2 * 3
    want = (2 * (2 * att + dense + moe) * tokens + 2 * 4 * 7 * 2
            + 2 * (2 + 2 + 1) * 2 * (3 * 4 // 2) * 2 * 2)
    assert _counts("deepseek_v2").prefill_flops(cfg, mix) == want


def test_decode_bytes_by_hand():
    cfg = {"d_model": 4, "num_heads": 2, "kv_lora_rank": 3,
           "qk_nope_head_dim": 2, "qk_rope_head_dim": 2, "v_head_dim": 1,
           "num_layers": 2, "first_dense_layers": 1, "first_dense_d_ff": 5,
           "num_experts": 4, "moe_top_k": 2, "moe_d_ff": 3,
           "num_shared_experts": 1, "vocab_size": 7}
    mix = {"batch": 1, "prompt_len": 5, "new_tokens": 3}
    c = _counts("deepseek_v2")
    # one token reaches its 2 experts exactly: 4 · (1 - (1/2)^1) = 2
    assert c.experts_touched(cfg, 1) == 2.0
    assert c.experts_touched(cfg, 3) == pytest.approx(4 * (1 - 0.5 ** 3))
    weights = 2 * (2 * 78 + 60 + (16 + 2 * 36 + 36) + 4 * 7 + 4)
    cache = 2 * 1 * (5 + 2.0) * (3 + 2) * 2
    assert c.decode_step_bytes(cfg, mix) == pytest.approx(weights + cache,
                                                          rel=1e-12)


def test_the_real_cells_counts():
    cfg = BASE
    mix = json.loads((_tiny.HERE / "mixes" / "serve-32k.json").read_text())
    c = _counts("deepseek_v2")
    # 2.24 B active weights outside the embedding and the head, as the
    # configuration's parameter count gives them
    per_token = sum(c.attention_params(cfg) + c.ffn_params(cfg, i, 6)
                    for i in range(27))
    mc = core.model_config(cfg)
    assert per_token == (mc.active_param_count() - 2 * 102400 * 2048
                         - 2 * 2048 * 27 - 512 * 27)
    flops = c.prefill_flops(cfg, mix)
    attention = 2 * 320 * 16 * (32736 * 32737 // 2) * 27 * 4
    assert flops - attention == pytest.approx(
        2 * per_token * 4 * 32736 + 2 * 2048 * 102400 * 4, rel=1e-12)
    assert 1.17e15 < flops < 1.19e15


def test_mla_attention_bound_by_hand():
    c = _counts("mla_attention")
    from h100bench import peaks
    assert c.pairs(3) == 6
    got = c.bound_s(2, 3, 4, 2)
    ops = 2 * (4 + 2) * 6 * 2
    nbytes = 2 * 3 * (8 + 4) * 2
    assert got == max(ops / peaks.PEAK_FLOPS_BF16,
                      nbytes / peaks.HBM_BYTES_PER_S)
    # at the cell's shapes it is bound by operations
    s = 32736
    assert c.bound_s(64, s, 192, 128) == pytest.approx(
        2 * 320 * (s * (s + 1) // 2) * 64 / peaks.PEAK_FLOPS_BF16)


# -- runs ---------------------------------------------------------------------


def test_a_sound_run_is_correct(root):
    line = _tiny.run(root, CELL, seed=2 ** 31 + 11)
    assert line["correct"], line["checks"]
    assert line["checks"]["logit_gap"]["value"] < 1e-5
    assert set(line["metrics"]) == {"ttft_mean_s", "serve_tokens_per_s",
                                    "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 5])
def test_the_fp8_control_fails_the_limit(root, seed):
    """``controls.py``'s serving control at this size: the reference in
    fp8 in the program's place reads 0.36–0.38, the program 0."""
    from h100bench import controls
    got = controls.readings(core.Bench(root), CELL, seed, "cpu")
    assert got["control_fp8"]["logit_gap"] > LIMITS["logit_gap"]
    assert got["program"]["logit_gap"] <= LIMITS["logit_gap"]


def test_the_halves_rotated_in_place_of_pairs(root, monkeypatch):
    from repro_torch.models import mla

    def halves(x, positions, cfg, gain=1.0):
        inv, att = mla.yarn_inv_freq(cfg)
        ang = positions.float()[:, None] * inv
        for _ in range(x.dim() - 3):
            ang = ang[:, None]
        x1, x2 = torch.chunk(x.float(), 2, dim=-1)
        cos, sin = torch.cos(ang) * gain, torch.sin(ang) * gain
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    monkeypatch.setattr(mla, "rope_pairs", halves)
    line = _tiny.run(root, CELL)
    assert not line["correct"]


def test_the_mscale_squared_left_out(root, monkeypatch):
    from repro_torch.models import mla
    monkeypatch.setattr(mla, "softmax_scale",
                        lambda cfg: 1.0 / math.sqrt(cfg.mla_qk_dim))
    line = _tiny.run(root, CELL)
    assert not line["correct"]


def test_pairs_dropped_at_capacity(root, monkeypatch):
    """Routing that drops every pair past ``capacity_factor`` 1.25 (the
    JAX-parity modes' capacity) in place of none.  Caught at this size;
    at the real cell's segments (16,384 tokens, 1,536 pairs an expert on
    average under the seed's near-uniform router) no expert reaches the
    capacity of 1,920, so there the fault changes nothing and no run can
    see it (PERF.md, section 4)."""
    from repro_torch.models import moe
    dropped = []

    def capped(cfg, params, xf, gate, order, counts):
        t = xf.shape[0]
        c = moe.capacity(cfg, t)
        idx = torch.empty(t * cfg.moe_top_k, dtype=torch.long)
        idx[order] = torch.repeat_interleave(
            torch.arange(cfg.num_experts), counts)
        idx = idx.view(t, cfg.moe_top_k)
        dropped.append(int(torch.clamp(counts - c, min=0).sum()))
        return moe._dispatch_einsum(cfg, params, xf, idx, gate.float())

    monkeypatch.setattr(moe, "_dispatch_dropless", capped)
    line = _tiny.run(root, CELL)
    assert sum(dropped) > 0
    assert not line["correct"], (line["checks"], sum(dropped))


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(_tiny.REPO)!r})
from pathlib import Path
from h100bench.core import load_module
load_module(Path({str(_tiny.HERE)!r}) / "reference" / "deepseek_v2.py")
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=f"{_tiny.REPO / 'src'}:{_tiny.REPO}")
    out = subprocess.run([sys.executable, "-c", code], cwd=_tiny.REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
