"""The port's dense decoders (full attention, ``ATTN``) and its int8 KV
cache against the reference, on the CPU.

Each dense model runs in its ``tests/conftest.py::reduced`` float32 config
(two layers, d_model 64, four query heads of 16, GQA as the model has
it), with one set of random weights made with numpy from a seed: the
reference runs them as JAX arrays and the port takes them through
``models.convert.params_from_jax``.  Prompts are numpy tokens given to
both; the port's ``flash_attention`` runs its plain version here.

Tolerances:
- logits and bf16/fp32 cache leaves: 1e-4 relative and absolute.  Both
  sides compute the same fp32 formulas; matmuls, einsums and the softmax
  add in other orders.
- ``quantize_kv`` and ``dequantize_kv`` on the same inputs: bit for bit
  (both take the fp32 absmax, floor it at 1e-8, divide by 127, round half
  to even and clip to ±127).
- an int8 cache made by the model: values within one step and scales
  within 1e-4 relative.  The k and v it quantizes agree to ~1e-6, not
  bit for bit, and a value that lands near a half step may round the
  other way on one side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as ref_build_model
from repro.models import layers as LJ
from repro.parallel.sharding import is_param_def
from repro.serving import ServingEngine as RefEngine
from repro.serving.kvcache import grow_caches as ref_grow_caches
from repro_torch.config import ARCH_IDS, ShapeConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.serving import ServingEngine, grow_caches
from repro_torch.tree import tree_leaves_with_path, tree_map
from tests.conftest import reduced

TOL = 1e-4
BATCH = 2
PROMPT = 20
DENSE = ["deepseek-7b", "internlm2-20b", "qwen2-72b", "deepseek-67b",
         "musicgen-medium"]


def _cfg(arch, **kw):
    if arch == "internlm2-20b-g6":
        # internlm2-20b's own group of 6 (48 heads on 8), at 12 on 2
        return reduced("internlm2-20b", dtype="float32", num_heads=12,
                       num_kv_heads=2, head_dim=16, **kw)
    return reduced(arch, dtype="float32", **kw)


def _numpy_params(ref_model, seed=0):
    """Random weights for every leaf, away from the zero/one inits (norms
    near 1, small biases), matrices scaled by their fan-in."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        if p.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        elif p.init == "zeros":
            a = 0.1 * rng.standard_normal(p.shape)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, ref_model.param_defs(),
                                            is_leaf=is_param_def)


_PAIRS = {}


def _pair(arch, **kw):
    """(cfg, reference model, its params, port model, its params), made
    once a config in this module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        cfg = _cfg(arch, **kw)
        ref_model = ref_build_model(cfg)
        weights = _numpy_params(ref_model)
        _PAIRS[key] = (cfg, ref_model, jax.tree.map(jnp.asarray, weights),
                       Model(cfg, device="cpu"),
                       params_from_jax(weights, cfg, "cpu"))
    return _PAIRS[key]


def _prompt(cfg, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (BATCH, s), dtype=np.int32)


def _tokens(a):
    return torch.from_numpy(a).long()


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


def _assert_caches_close(got, want):
    """Every leaf of the same type as the reference's; int8 values within
    one step, everything else within TOL."""
    got_leaves = list(tree_leaves_with_path(got))
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_leaves)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        assert _dtype_name(g) == w.dtype.name, path
        if g.dtype == torch.int8:
            step = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
            assert step.max() <= 1, path
            assert (step == 0).mean() > 0.99, path
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                       err_msg=str(path))


# -- every model of the registry builds ---------------------------------------


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a != "paper-subsample"])
def test_dense_configs_are_supported(arch):
    """All ten LM configs build in the port (the dense decoders, the
    recurrent and hybrid models, the mixture-of-experts models and the
    patch frontend): the model at full width with the reference's
    parameter tree, and reduced on the CPU a prefill of finite logits."""
    cfg = get_config(arch)
    model = Model(cfg, device="cpu")
    want = jax.tree.map(lambda p: tuple(p.shape),
                        ref_build_model(cfg).param_defs(),
                        is_leaf=is_param_def)
    assert tree_map(lambda p: tuple(p.shape), model.param_defs()) == want
    assert (set(cfg.layer_kinds()) == {"attn"}) == (arch in DENSE
                                                   + ["deepseek-moe-16b",
                                                      "arctic-480b",
                                                      "llava-next-34b"])
    small = reduced(arch, dtype="float32")
    model = Model(small, device="cpu")
    params = model.init(model.generator(0))
    batch = model.make_inputs(ShapeConfig("p", "prefill", 24, 2),
                              model.generator(1))
    logits, _ = model.prefill(params, batch)
    assert tuple(logits.shape) == (2, small.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_layer_cache_defs_give_attention_a_cache_of_the_sequence():
    """An ``ATTN`` layer's cache is the whole sequence (a recurrent state
    before this slice), int8 with fp32 scales where the config asks."""
    cfg = get_config("deepseek-7b")
    defs = T.layer_cache_defs(cfg, 0, 4, 4096)
    assert {n: (p.shape, p.dtype) for n, p in defs.items()} == {
        "k": ((4, 4096, 32, 128), torch.int8),
        "v": ((4, 4096, 32, 128), torch.int8),
        "k_scale": ((4, 4096, 32, 1), torch.float32),
        "v_scale": ((4, 4096, 32, 1), torch.float32)}
    bf16 = dataclasses.replace(cfg, kv_cache_dtype="bfloat16")
    defs = T.layer_cache_defs(bf16, 0, 4, 4096, torch.bfloat16)
    assert sorted(defs) == ["k", "v"]
    assert defs["k"].dtype == torch.bfloat16


# -- the int8 primitives ------------------------------------------------------


def _kv_array(shape, seed):
    """Values of several magnitudes a row, with some exact half steps of
    the scale and an all-zero row (the 1e-8 floor)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 30.0],
                                                shape[:-1] + (1,))
    x[..., 0] = 127.0
    x[..., 1] = 0.5
    x[..., 2] = -2.5
    x[0, 0, 0] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 3, 16), (1, 33, 2, 128)])
def test_quantize_kv_equals_reference_bit_for_bit(dtype, shape):
    x = _kv_array(shape, seed=shape[1])
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = LJ.quantize_kv(jx)
    got_q, got_s = L.quantize_kv(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    want = LJ.dequantize_kv(want_q, want_s, jx.dtype)
    got = L.dequantize_kv(got_q, got_s, tx.dtype)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_maybe_quantize_cache_keeps_a_bf16_cache():
    cfg = _cfg("internlm2-20b")
    kv = {"k": torch.ones((1, 3, 1, 16)), "v": torch.ones((1, 3, 1, 16))}
    assert L.maybe_quantize_cache(cfg, kv) is kv
    quant = L.maybe_quantize_cache(_cfg("deepseek-7b"), kv)
    assert sorted(quant) == ["k", "k_scale", "v", "v_scale"]
    assert quant["k"].dtype == torch.int8


def _numpy_tree(defs, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        if p.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, defs, is_leaf=is_param_def)


@pytest.mark.parametrize("pos,window,s_max", [
    (0, 0, 12),       # the first write, every other slot masked
    (9, 0, 20),       # a full cache part filled
    (19, 0, 20),      # the last slot
    (21, 16, 16),     # a rolling buffer that has wrapped
])
def test_quantized_attention_decode_matches_reference(pos, window, s_max):
    cfg = _cfg("deepseek-7b")
    tree = _numpy_tree(LJ.attention_defs(cfg), seed=pos)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tree_map(torch.from_numpy, tree)
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shape = (2, s_max, cfg.num_kv_heads, cfg.head_dim)
    cache = {}
    for n in ("k", "v"):
        vals, scales = LJ.quantize_kv(jnp.asarray(
            rng.standard_normal(shape).astype(np.float32)))
        cache[n], cache[n + "_scale"] = np.asarray(vals), np.asarray(scales)
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    want_out, want_cache = LJ.attention_decode(
        cfg, jp, jnp.asarray(x), {n: jnp.asarray(a) for n, a in cache.items()},
        jnp.asarray(pos, jnp.int32), window=window)
    out, new_cache = L.attention_decode(cfg, tp, torch.from_numpy(x), tc,
                                        pos, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=TOL,
                               atol=TOL)
    assert sorted(new_cache) == sorted(want_cache)
    _assert_caches_close(new_cache, want_cache)
    write_at = pos % window if window else pos
    for n in ("k", "v"):     # only the written slot changed, not in place
        np.testing.assert_array_equal(tc[n].numpy(), cache[n])
        kept = np.delete(np.arange(s_max), write_at)
        np.testing.assert_array_equal(new_cache[n].numpy()[:, kept],
                                      cache[n][:, kept])


# -- the dense models end to end ----------------------------------------------


@pytest.mark.parametrize("arch", DENSE + ["internlm2-20b-g6"])
def test_prefill_logits_and_caches_match_reference(arch):
    cfg, ref_model, ref_params, model, params = _pair(arch)
    tokens = _prompt(cfg, PROMPT, seed=1)
    want_logits, want_caches = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, caches = model.prefill(params, {"tokens": _tokens(tokens)})
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)
    _assert_caches_close(caches, want_caches)
    k = caches["blocks"][0]["k"]
    assert tuple(k.shape) == (2, BATCH, PROMPT, cfg.num_kv_heads,
                              cfg.head_dim)
    assert (k.dtype == torch.int8) == (cfg.kv_cache_dtype == "int8")


def _reference_decode(cfg, ref_model, ref_params, tokens, steps):
    """The reference's logits and caches at each decode step of the given
    tokens after a prefill of the prompt."""
    s = tokens.shape[1] - steps
    _, caches = ref_model.prefill(ref_params,
                                  {"tokens": jnp.asarray(tokens[:, :s])})
    caches = ref_model.prefill_to_decode(ref_grow_caches(
        caches, tokens.shape[1], cfg.local_window))
    out = []
    for i in range(steps):
        logits, caches = ref_model.decode_step(
            ref_params, jnp.asarray(tokens[:, s + i:s + i + 1]), caches,
            jnp.asarray(s + i, jnp.int32))
        out.append((np.asarray(logits), caches))
    return out


@pytest.mark.parametrize("arch", DENSE + ["internlm2-20b-g6"])
def test_decode_steps_match_reference(arch):
    """Three decode steps after a 20-token prompt into a cache grown to
    23: logits at each step, and the caches after the last."""
    cfg, ref_model, ref_params, model, params = _pair(arch)
    tokens = _prompt(cfg, PROMPT + 3, seed=2)
    want = _reference_decode(cfg, ref_model, ref_params, tokens, 3)
    _, caches = model.prefill(params, {"tokens": _tokens(tokens[:, :PROMPT])})
    caches = model.prefill_to_decode(grow_caches(caches, PROMPT + 3))
    for i in range(3):
        logits, caches = model.decode_step(
            params, _tokens(tokens[:, PROMPT + i:PROMPT + i + 1]), caches,
            PROMPT + i)
        np.testing.assert_allclose(logits.numpy(), want[i][0], rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    _assert_caches_close(caches, want[-1][1])


@pytest.mark.parametrize("arch", ["internlm2-20b", "qwen2-72b"])
def test_decode_after_prefill_equals_prefill_of_one_more(arch):
    """The port's own decode ≡ prefill invariant, with an unquantized fp32
    cache (the int8 cache is held against the reference above)."""
    cfg, _, _, model, params = _pair(arch)
    tokens = _tokens(_prompt(cfg, PROMPT + 1, seed=3))
    _, caches = model.prefill(params, {"tokens": tokens[:, :PROMPT]})
    caches = model.prefill_to_decode(grow_caches(caches, PROMPT + 1))
    stepped, _ = model.decode_step(params, tokens[:, PROMPT:], caches, PROMPT)
    whole, _ = model.prefill(params, {"tokens": tokens})
    np.testing.assert_allclose(stepped.numpy(), whole.numpy(), rtol=TOL,
                               atol=TOL)


def test_decode_refuses_a_write_past_a_full_attention_cache():
    cfg, _, _, model, params = _pair("deepseek-7b")
    tokens = _tokens(_prompt(cfg, 8, seed=4))
    _, caches = model.prefill(params, {"tokens": tokens})
    caches = model.prefill_to_decode(caches)          # not grown
    with pytest.raises(ValueError, match="grow"):
        model.decode_step(params, tokens[:, :1], caches, 8)


@pytest.mark.parametrize("p", [12, 24])
def test_int8_local_attention_cache_matches_reference(p):
    """``maybe_quantize_cache`` after the windowed roll: a reduced
    ``recurrentgemma-2b`` (window 16) with an int8 cache, at prompts below
    and above the window.  Above it, two decode steps too (below it the
    reference's decode is off: ROADMAP Queue 3)."""
    cfg, ref_model, ref_params, model, params = _pair(
        "recurrentgemma-2b", kv_cache_dtype="int8")
    tokens = _prompt(cfg, p + 2, seed=p)
    want_logits, want_caches = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens[:, :p])})
    logits, caches = model.prefill(params, {"tokens": _tokens(tokens[:, :p])})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)
    _assert_caches_close(caches, want_caches)
    local = caches["blocks"][2]
    assert local["k"].dtype == torch.int8
    assert local["k"].shape[2] == min(p, cfg.local_window)
    if p < cfg.local_window:
        return
    want = _reference_decode(cfg, ref_model, ref_params, tokens, 2)
    caches = model.prefill_to_decode(grow_caches(caches, p + 2,
                                                 cfg.local_window))
    for i in range(2):
        logits, caches = model.decode_step(
            params, _tokens(tokens[:, p + i:p + i + 1]), caches, p + i)
        np.testing.assert_allclose(logits.numpy(), want[i][0], rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    _assert_caches_close(caches, want[-1][1])


def test_grow_caches_and_caches_from_jax_on_an_int8_tree():
    """The reference's int8 prefill caches, grown by both packages' grow
    functions and carried into the port: int8 stays int8, fp32 scales stay
    fp32, values equal; then one decode step from the carried caches."""
    cfg, ref_model, ref_params, model, params = _pair("deepseek-7b")
    tokens = _prompt(cfg, PROMPT, seed=5)
    _, ref_caches = ref_model.prefill(ref_params,
                                      {"tokens": jnp.asarray(tokens)})
    numpy_caches = jax.tree.map(np.asarray, ref_caches)
    carried = caches_from_jax(numpy_caches, "cpu")
    for (path, got), (_, want) in zip(
            tree_leaves_with_path(carried),
            jax.tree_util.tree_flatten_with_path(numpy_caches)[0]):
        assert _dtype_name(got) == want.dtype.name, path
        np.testing.assert_array_equal(got.numpy(), want)
    for target in (PROMPT + 5, PROMPT - 4):
        want = ref_grow_caches(ref_caches, target)
        got = grow_caches(carried, target)
        for (path, g), (_, w) in zip(
                tree_leaves_with_path(got),
                jax.tree_util.tree_flatten_with_path(want)[0]):
            w = np.asarray(w)
            assert _dtype_name(g) == w.dtype.name, path
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    ref_dec = ref_model.prefill_to_decode(ref_grow_caches(ref_caches,
                                                          PROMPT + 1))
    tok = np.full((BATCH, 1), 3, np.int32)
    want, _ = ref_model.decode_step(ref_params, jnp.asarray(tok), ref_dec,
                                    jnp.asarray(PROMPT, jnp.int32))
    dec = caches_from_jax(jax.tree.map(np.asarray, ref_dec), "cpu")
    got, _ = model.decode_step(params, _tokens(tok), dec, PROMPT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_int8_cache_decode_close_to_bf16():
    """The reference's own bound (tests/test_serving_consistency.py), in
    the port: a 2-layer reduced ``deepseek-7b`` in bf16, the same weights
    with an int8 and a bf16 cache; their first decode logits differ by a
    relative max under 0.15."""
    base = reduced("deepseek-7b", num_layers=2, kv_cache_dtype="bfloat16")
    weights = _numpy_params(ref_build_model(base), seed=6)
    tokens = _tokens(_prompt(base, 25, seed=6))
    outs = {}
    for cache in ("bfloat16", "int8"):
        cfg = dataclasses.replace(base, kv_cache_dtype=cache)
        model = Model(cfg, device="cpu")
        params = tree_map(lambda t: t.to(torch.bfloat16),
                          params_from_jax(weights, cfg, "cpu"))
        _, caches = model.prefill(params, {"tokens": tokens[:, :24]})
        caches = model.prefill_to_decode(grow_caches(caches, 26))
        got, _ = model.decode_step(params, tokens[:, 24:], caches, 24)
        outs[cache] = got.numpy()
    denom = max(np.abs(outs["bfloat16"]).max(), 1e-3)
    rel = np.abs(outs["int8"] - outs["bfloat16"]).max() / denom
    assert 0 < rel < 0.15, rel


def test_generate_matches_reference_tokens():
    """Greedy tokens of a reduced ``deepseek-7b`` (int8 cache) equal the
    reference engine's wherever the reference's top-2 logit gap exceeds
    1e-3 (the int8 cache may move logits by about 1e-4 more than fp32); a
    row is compared up to its first near-tie."""
    cfg, ref_model, ref_params, model, params = _pair("deepseek-7b")
    tokens = _prompt(cfg, PROMPT, seed=7)
    n_new = 6
    gen = RefEngine(ref_model, ref_params, max_new_tokens=n_new).generate(
        {"tokens": jnp.asarray(tokens)}, new_tokens=n_new).tokens
    first, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    steps = _reference_decode(cfg, ref_model, ref_params,
                              np.concatenate([tokens, gen], axis=1), n_new)
    deciding = [np.asarray(first)] + [lg for lg, _ in steps[:-1]]
    out = ServingEngine(model, params, max_new_tokens=n_new).generate(
        {"tokens": _tokens(tokens)})
    assert out.tokens.shape == (BATCH, n_new)
    compared = 0
    for b in range(BATCH):
        for i in range(n_new):
            top2 = np.sort(deciding[i][b])[-2:]
            if top2[1] - top2[0] <= 1e-3:
                break
            assert out.tokens[b, i] == gen[b, i], (b, i)
            compared += 1
    assert compared >= n_new


@pytest.mark.parametrize("arch_cfg", ["reduced", "full"])
def test_cache_tree_matches_reference_definitions(arch_cfg):
    cfg = (_cfg("deepseek-7b") if arch_cfg == "reduced"
           else get_config("deepseek-7b"))
    ref_model = ref_build_model(cfg)
    model = Model(cfg, device="cpu")
    for mode in ("prefill", "decode"):
        want = jax.tree.map(lambda p: (p.shape, np.dtype(p.dtype).name),
                            ref_model.cache_defs(3, 40, mode=mode),
                            is_leaf=is_param_def)
        got = tree_map(lambda p: (p.shape, _dtype_name(p)),
                       model.cache_defs(3, 40, mode=mode))
        assert got == want


def test_init_cache_makes_int8_zeros():
    model = Model(_cfg("deepseek-7b"), device="cpu")
    caches = model.init_cache(2, 9)
    leaves = dict(tree_leaves_with_path(caches))
    assert leaves
    for path, t in leaves.items():
        want = torch.float32 if "scale" in path[-1] else torch.int8
        assert t.dtype == want, path
        assert not t.any(), path


def test_serve_launcher_runs_deepseek_7b_on_cpu():
    ops.reset_launch_count()
    out = serve.main(["--arch", "deepseek-7b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "17",
                      "--new-tokens", "3"])
    assert out.tokens.shape == (2, 3)
    assert out.prefill_seconds > 0 and out.decode_seconds > 0
    assert all(ops.launch_count(n) == 0 for n in ops.KERNELS)  # plain on CPU
