"""DeepSeek-V2-Lite's mechanisms in the port on the CPU, at a tiny size on
seeded random weights, against the benchmark's plain fp32 reference
(``h100bench/reference/deepseek_v2.py``, loaded by its path): multi-head
latent attention (prefill through ``ops.flash_attention`` padded to 256,
decode in the absorbed form over the latent cache), YaRN RoPE on
consecutive pairs, and the dropless MoE; beside them the padded kernel
call and the cache manager's latent leaves.  The JAX package has no such model, so nothing
here compares with it."""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.models import mla
from repro_torch.models import moe as MOE
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import init_params
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kvcache import grow_caches
from repro_torch.tree import tree_leaves_with_path

ROOT = Path(__file__).resolve().parents[1]


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "bench_deepseek_v2", ROOT / "h100bench" / "reference" /
        "deepseek_v2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


plain = _load_reference()
FULL = get_config("deepseek-v2-lite")
# 2 layers (one dense, one MoE of 8 experts, top 2, 1 shared); YaRN ramped
# over 16 original positions at factor 4, so that the prompts below (23
# positions and 6 more decoded) reach past them
TINY = dataclasses.replace(
    FULL, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=256, kv_lora_rank=32, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, num_experts=8, moe_top_k=2,
    num_shared_experts=1, moe_d_ff=32, first_dense_d_ff=128, moe_seq_chunk=0,
    dtype="float32",
    rope_scaling=dict(FULL.yarn, factor=4,
                      original_max_position_embeddings=16))


def _ref_cfg(cfg):
    """The reference's configuration: the port's fields by name."""
    d = dataclasses.asdict(cfg)
    d["rope_scaling"] = cfg.yarn
    return d


def _weights(cfg, seed=0, sharpen=10.0):
    """Seeded weights by path.  Normal leaves are N(0, 0.02) times
    ``sharpen``: at width 64 the default leaves scores and logits so flat
    that a wrong rotation or scale would hardly move them."""
    model = Model(cfg, device="cpu")
    params = init_params(model.param_defs(), torch.float32, "cpu",
                         torch.Generator().manual_seed(seed))
    defs = dict(tree_leaves_with_path(model.param_defs()))
    out = {}
    for path, t in tree_leaves_with_path(params):
        if defs[path].init == "normal":
            t.mul_(sharpen)
        out["/".join(str(p) for p in path)] = t
    return model, params, out


def _served(model, params, prompts, served):
    """Prefill, then decode through the latent cache feeding ``served``:
    the logits at each position that chose a served token."""
    p, n = prompts.shape[1], served.shape[1]
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"tokens": prompts})
        caches = model.prefill_to_decode(grow_caches(caches, p + n))
        got = [logits]
        for i in range(n - 1):
            logits, caches = model.decode_step(params, served[:, i:i + 1],
                                               caches, p + i)
            got.append(logits)
    return torch.stack(got, dim=1)


def _tokens(seed, b=2, p=23, n=6, vocab=256):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, vocab, (b, p), generator=gen),
            torch.randint(0, vocab, (b, n), generator=gen))


# -- the model against the reference -------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_latent_decode_equal_the_reference(seed):
    """Prefill's logits and each decode step's through the latent cache
    against the reference's one causal pass at every position.  Both are
    fp32; they part only by the order of their sums (padded kernel against
    blocked scores, absorbed against expanded attention, grouped against
    per-expert products), ~1e-6 of the logits here: 1e-4 is that with room,
    and a wrong rotation or scale moves them by far more (tests below)."""
    model, params, leaves = _weights(TINY, seed)
    prompts, served = _tokens(seed)
    got = _served(model, params, prompts, served)
    want = plain.served_logits(_ref_cfg(TINY), leaves, prompts, served)
    assert got.shape == want.shape == (2, 6, 256)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), float(
        (got - want).abs().max())
    assert float(want.std()) > 0.5      # sharp enough to mean something


def test_generate_serves_the_references_greedy_tokens():
    model, params, leaves = _weights(TINY, 2)
    prompts, _ = _tokens(2, n=1)
    res = ServingEngine(model, params, max_new_tokens=5).generate(
        {"tokens": prompts})
    served = torch.as_tensor(res.tokens).long()
    want = plain.served_logits(_ref_cfg(TINY), leaves, prompts, served)
    assert torch.equal(want.argmax(dim=-1), served)


@pytest.mark.parametrize("fault", ["halves", "no_mscale"])
def test_the_reference_tells_a_wrong_rope_or_scale(fault, monkeypatch):
    """The comparison above is tight enough to see each departure."""
    model, params, leaves = _weights(TINY, 3)
    prompts, served = _tokens(3)
    if fault == "halves":
        def halves(x, positions, cfg, gain=1.0):
            inv, _ = mla.yarn_inv_freq(cfg)
            ang = positions.float()[:, None] * inv
            for _ in range(x.dim() - 3):
                ang = ang[:, None]
            x1, x2 = torch.chunk(x.float(), 2, dim=-1)
            c, s = torch.cos(ang) * gain, torch.sin(ang) * gain
            return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1)
        monkeypatch.setattr(mla, "rope_pairs", halves)
    else:
        monkeypatch.setattr(mla, "softmax_scale",
                            lambda cfg: 1.0 / math.sqrt(cfg.mla_qk_dim))
    got = _served(model, params, prompts, served)
    want = plain.served_logits(_ref_cfg(TINY), leaves, prompts, served)
    assert float((got - want).abs().max()) > 1e-2


# -- YaRN and RoPE --------------------------------------------------------------


def test_yarn_at_the_published_settings():
    """Factor 40 over 4,096 positions, beta 32 / 1, theta 10,000, 64 roped
    dims: the fastest pairs keep their frequency, the slowest are divided
    by 40, a ramp between; cos/sin factor 1 (mscale = mscale_all_dim);
    softmax scale (0.1 · 0.707 · ln 40 + 1)² / sqrt(192)."""
    inv, att = mla.yarn_inv_freq(FULL)
    base = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    assert att == 1.0
    assert inv.shape == (32,)
    low = math.floor(64 * math.log(4096 / (32 * 2 * math.pi))
                     / (2 * math.log(10000)))
    high = math.ceil(64 * math.log(4096 / (1 * 2 * math.pi))
                     / (2 * math.log(10000)))
    assert (low, high) == (10, 23)
    assert torch.allclose(inv[:low + 1], base[:low + 1], rtol=1e-6)
    assert torch.allclose(inv[high:], base[high:] / 40, rtol=1e-6)
    assert bool(((inv[low + 1:high] < base[low + 1:high])
                 & (inv[low + 1:high] > base[low + 1:high] / 40)).all())
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert mla.softmax_scale(FULL) == pytest.approx(mscale ** 2
                                                    / math.sqrt(192))
    r_inv, r_att, r_scale = plain.yarn(_ref_cfg(FULL))
    assert torch.allclose(inv, r_inv, rtol=1e-6) and r_att == att
    assert r_scale == pytest.approx(mla.softmax_scale(FULL), rel=1e-15)


def test_rope_rotates_consecutive_pairs():
    x = torch.zeros(1, 1, 8)
    x[..., 2] = 1.0                              # pair 1, first element
    pos = torch.tensor([7])
    out = mla.rope_pairs(x, pos, TINY)
    inv, _ = mla.yarn_inv_freq(TINY)
    ang = 7 * inv[1]
    want = torch.zeros(1, 1, 8)
    want[..., 2], want[..., 3] = torch.cos(ang), torch.sin(ang)
    assert torch.allclose(out, want, atol=1e-6)


# -- the dropless MoE -------------------------------------------------------------


def _moe_params(cfg, seed):
    defs = MOE.moe_defs(cfg)
    return init_params(defs, torch.float32, "cpu",
                       torch.Generator().manual_seed(seed))


def _ref_moe(cfg, params, x):
    w = {"ffn/router": params["router"], "ffn/we_i": params["we_i"],
         "ffn/we_g": params["we_g"], "ffn/we_d": params["we_d"],
         "ffn/shared/wi": params["shared"]["wi"],
         "ffn/shared/wg": params["shared"]["wg"],
         "ffn/shared/wd": params["shared"]["wd"]}
    return plain.moe(_ref_cfg(cfg), w, x, lambda a, b: a @ b)


def test_the_dropless_moe_drops_no_pair_under_a_skewed_router():
    """A router skewed onto expert 3: every token sends a choice there.
    The dropless mode computes all of them, as the reference does, where
    a capacity of 1.25 drops most."""
    cfg = dataclasses.replace(TINY, moe_seq_chunk=0)
    p = _moe_params(cfg, 5)
    p["router"][:, 3] += 5.0
    x = torch.randn(2, 23, cfg.d_model,
                    generator=torch.Generator().manual_seed(6)).abs()
    got, _ = MOE.moe_apply(cfg, p, x)
    want = _ref_moe(cfg, p, x)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    idx = MOE._route(cfg, p, x.reshape(-1, cfg.d_model))[0]
    assert bool((idx == 3).any(dim=-1).all())
    assert MOE.capacity(cfg, 46) < 46
    capped, _ = MOE.moe_apply(cfg, p, x, dispatch="einsum")
    assert not torch.allclose(capped, want, rtol=1e-3, atol=1e-3)


def test_the_dropless_gates_are_not_renormalised_and_route_in_fp32():
    cfg = TINY
    p = _moe_params(cfg, 7)
    x = torch.randn(10, cfg.d_model, generator=torch.Generator().manual_seed(8))
    idx, gate, _, probs = MOE._route(cfg, p, x)
    assert torch.equal(gate, probs.gather(-1, idx))
    assert bool((gate.sum(-1) < 1).all())


@pytest.mark.parametrize("seg", [5, 8])
def test_moe_seq_chunk_leaves_the_dropless_output_equal(seg):
    """Segments of 5 (not dividing 23, the last shorter) or 8 positions
    give each token the same experts and products as one pass.  Equal to
    1e-6: each expert's product runs over another number of rows, which
    the CPU's matrix library may sum in another order (in fact it comes
    out equal bit for bit here or within an ulp)."""
    p = _moe_params(TINY, 9)
    x = torch.randn(2, 23, TINY.d_model,
                    generator=torch.Generator().manual_seed(10))
    whole, _ = MOE.moe_apply(dataclasses.replace(TINY, moe_seq_chunk=0),
                             p, x)
    cut, _ = MOE.moe_apply(dataclasses.replace(TINY, moe_seq_chunk=seg),
                           p, x)
    assert torch.allclose(cut, whole, rtol=1e-6, atol=1e-6)


# -- the padded kernel call ----------------------------------------------------------


def test_the_padded_call_is_plain_attention_at_192_and_128():
    """q and k of 192 and v of 128, zero-padded to 256, q carrying the
    model's scale past the kernel's 1/sqrt(256) (as ``mla_apply`` lays it
    out): the first 128 columns are softmax attention at those widths and
    that scale, in value and in gradient; the padded columns are zeros."""
    gen = torch.Generator().manual_seed(12)
    s, scale = 19, mla.softmax_scale(FULL)
    fold = scale * math.sqrt(mla.KERNEL_HD)
    q = torch.randn(3, s, 192, generator=gen, dtype=torch.float64).float()
    k = torch.randn(3, s, 192, generator=gen, dtype=torch.float64).float()
    v = torch.randn(3, s, 128, generator=gen, dtype=torch.float64).float()
    pad = lambda t: torch.nn.functional.pad(t, (0, 256 - t.shape[-1]))

    def plain_attention(q, k, v):
        sc = (q @ k.transpose(1, 2)) * scale
        mask = torch.ones(s, s, dtype=torch.bool).tril()
        return torch.softmax(sc.masked_fill(~mask, float("-inf")), -1) @ v

    got = ops.flash_attention(pad(q * fold), pad(k), pad(v))
    assert torch.allclose(got[..., :128], plain_attention(q, k, v),
                          rtol=1e-5, atol=1e-5)
    assert not got[..., 128:].any()
    qg = q.clone().requires_grad_()
    out = ops.flash_attention(pad(qg * fold), pad(k), pad(v))
    out[..., :128].sum().backward()
    qw = q.clone().requires_grad_()
    plain_attention(qw, k, v).sum().backward()
    assert torch.allclose(qg.grad, qw.grad, rtol=1e-4, atol=1e-5)


# -- the cache manager --------------------------------------------------------------


def test_grow_caches_grows_latent_leaves_and_keeps_the_old_layouts():
    gen = torch.Generator().manual_seed(13)
    tree = {"blocks": [{"c_kv": torch.randn(3, 2, 5, 8, generator=gen),
                        "k_pe": torch.randn(3, 2, 5, 4, generator=gen)}],
            "prefix": [{"c_kv": torch.randn(2, 5, 8, generator=gen),
                        "k_pe": torch.randn(2, 5, 4, generator=gen)},
                       {"k": torch.randn(2, 5, 3, 4, generator=gen),
                        "v": torch.randn(2, 5, 3, 4, generator=gen),
                        "k_scale": torch.randn(2, 5, 3, 1, generator=gen)}],
            "tail": [{"wkv": torch.randn(2, 3, 4, 4, generator=gen)}]}
    got = grow_caches(tree, 9)
    for old, new in ((tree["blocks"][0]["c_kv"], got["blocks"][0]["c_kv"]),
                     (tree["prefix"][0]["k_pe"], got["prefix"][0]["k_pe"])):
        assert new.shape[:-2] + new.shape[-1:] == old.shape[:-2] + \
            old.shape[-1:]
        assert new.shape[-2] == 9
        assert torch.equal(new[..., :5, :], old)
        assert not new[..., 5:, :].any()
    for key in ("k", "v", "k_scale"):
        old, new = tree["prefix"][1][key], got["prefix"][1][key]
        assert new.shape == (2, 9) + old.shape[2:]
        assert torch.equal(new[:, :5], old)
    assert got["tail"][0]["wkv"] is tree["tail"][0]["wkv"]


def test_decode_writes_the_token_latent_at_pos_in_place():
    model, params, _ = _weights(TINY, 14)
    prompts, served = _tokens(14, n=2)
    with torch.inference_mode():
        _, caches = model.prefill(params, {"tokens": prompts})
        caches = model.prefill_to_decode(grow_caches(caches, 30))
        layer = caches["prefix"][1]
        before = layer["c_kv"].clone()
        _, after = model.decode_step(params, served[:, :1], caches, 23)
    assert after["prefix"][1]["c_kv"] is layer["c_kv"]
    assert torch.equal(layer["c_kv"][:, :23], before[:, :23])
    assert layer["c_kv"][:, 23].abs().sum() > 0
    assert not layer["c_kv"][:, 24:].any()


# -- the configuration ----------------------------------------------------------------


def test_the_configuration_is_the_published_model():
    """15.7 B parameters (2.66 B active with the embedding and the head),
    every width as published."""
    assert FULL.param_count() == 15_706_482_176
    assert FULL.active_param_count() == 2_661_148_160
    assert (FULL.kv_lora_rank, FULL.qk_nope_head_dim, FULL.qk_rope_head_dim,
            FULL.v_head_dim) == (512, 128, 64, 128)
    assert (FULL.norm_topk_prob, FULL.moe_dispatch) == (False, "dropless")
    cache = Model(FULL, device="cpu").cache_defs(4, 32768)
    layer = cache["blocks_flat"][0][0]
    assert layer["c_kv"].shape == (4, 32768, 512)
    assert layer["k_pe"].shape == (4, 32768, 64)
    assert layer["c_kv"].dtype == layer["k_pe"].dtype == torch.bfloat16
