"""The port's RecurrentGemma-2B serving path against the reference, on the
CPU.

A reduced ``recurrentgemma-2b`` (two stacked (RG-LRU, RG-LRU, local)
blocks and a tail of two RG-LRU layers, d_model 64, four query heads of 16
on one KV head, window 16, float32) gets one set of random weights, made
with numpy from a seed; the reference runs them as JAX arrays and the port
takes them through ``models.convert.params_from_jax``.  Prompts are numpy
tokens given to both.  The port's kernel wrappers run their plain
versions here.

Tolerance: 1e-4 relative and absolute on logits and every cache leaf.
Both sides compute the same fp32 formulas; their matmuls, einsums, the
softmax and the scan add in other orders, over eight layers and a 256-way
head with a soft cap of 30.

The reference serves a prompt shorter than the window wrong (ROADMAP
Queue 3): its decode overwrites the last prompt token's K/V.  Where the
prompt is that short, the port is held against the reference's prefill of
the longer sequence instead of its decode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as ref_build_model
from repro.parallel.sharding import is_param_def
from repro.serving import ServingEngine as RefEngine
from repro.serving.kvcache import grow_caches as ref_grow_caches
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.serving import ServingEngine, grow_caches
from repro_torch.tree import tree_leaves_with_path, tree_map
from tests.conftest import reduced

TOL = 1e-4
BATCH = 2


def _cfg():
    return reduced("recurrentgemma-2b", dtype="float32")


def _numpy_params(ref_model, seed=0):
    """Random weights for every leaf, away from the degenerate zero/one
    inits (gate weights and Λ near 1, small biases, norms near 1), and
    matrices scaled by their fan-in so that activations stay of order one
    through the layers."""
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


@pytest.fixture(scope="module")
def pair():
    cfg = _cfg()
    ref_model = ref_build_model(cfg)
    weights = _numpy_params(ref_model)
    model = Model(cfg, device="cpu")
    return (ref_model, jax.tree.map(jnp.asarray, weights), model,
            params_from_jax(weights, cfg, "cpu"))


def _prompt(s, seed=0):
    return np.random.default_rng(seed).integers(0, _cfg().vocab_size,
                                                (BATCH, s), dtype=np.int32)


def _tokens(a):
    return torch.from_numpy(a).long()


def _assert_trees_close(got, want):
    got_leaves = list(tree_leaves_with_path(got))
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_leaves)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=str(path))


def test_stack_is_eighteen_rglru_and_eight_local_layers():
    cfg = get_config("recurrentgemma-2b")
    kinds = cfg.layer_kinds()
    assert (kinds.count("rglru"), kinds.count("local")) == (18, 8)
    assert cfg.param_count() == 2_658_549_760


@pytest.mark.parametrize("s", [13, 24, 40])
def test_prefill_logits_and_caches_match_reference(pair, s):
    ref_model, ref_params, model, params = pair
    tokens = _prompt(s, seed=s)
    want_logits, want_caches = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, caches = model.prefill(params, {"tokens": _tokens(tokens)})
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)
    _assert_trees_close(caches, want_caches)


def _reference_run(ref_model, ref_params, tokens, n_new):
    """The reference engine's tokens, then its logits at each decode step
    when fed those tokens."""
    gen = RefEngine(ref_model, ref_params, max_new_tokens=n_new).generate(
        {"tokens": jnp.asarray(tokens)}, new_tokens=n_new).tokens
    _, caches = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    caches = ref_model.prefill_to_decode(ref_grow_caches(
        caches, tokens.shape[1] + n_new, _cfg().local_window))
    logits = []
    for i in range(n_new):
        out, caches = ref_model.decode_step(
            ref_params, jnp.asarray(gen[:, i:i + 1]), caches,
            jnp.asarray(tokens.shape[1] + i, jnp.int32))
        logits.append(np.asarray(out))
    return gen, logits


def test_decode_steps_match_reference(pair):
    """Four decode steps after a 24-token prompt (longer than the window
    of 16, where the reference serves right), the second wrapping the
    rolling buffer past slot 15."""
    ref_model, ref_params, model, params = pair
    tokens = _prompt(24, seed=1)
    gen, want = _reference_run(ref_model, ref_params, tokens, 4)
    _, caches = model.prefill(params, {"tokens": _tokens(tokens)})
    caches = model.prefill_to_decode(grow_caches(caches, 24 + 4, 16))
    for i in range(4):
        logits, caches = model.decode_step(
            params, _tokens(gen[:, i:i + 1]), caches, 24 + i)
        np.testing.assert_allclose(logits.numpy(), want[i], rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("p", [8, 15])
def test_short_prompt_decode_matches_reference_prefill(pair, p):
    """A prompt shorter than the window: the port's decode of x after
    prefill(P) gives the reference's *prefill* logits of P ++ [x], and so
    for the steps after.  (The reference's own decode is off here: the
    next test, and ROADMAP Queue 3.)"""
    ref_model, ref_params, model, params = pair
    tokens = _prompt(p + 3, seed=p)
    _, caches = model.prefill(params, {"tokens": _tokens(tokens[:, :p])})
    caches = model.prefill_to_decode(grow_caches(caches, p + 3, 16))
    for i in range(3):
        stepped, caches = model.decode_step(
            params, _tokens(tokens[:, p + i:p + i + 1]), caches, p + i)
        want, _ = ref_model.prefill(
            ref_params, {"tokens": jnp.asarray(tokens[:, :p + i + 1])})
        np.testing.assert_allclose(stepped.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("p,off", [(8, True), (24, False)])
def test_reference_decode_is_off_only_below_the_window(pair, p, off):
    """The fault the port does not copy: the reference's decode of x after
    prefill(P) against its own prefill of P ++ [x], with its grow_caches.
    Below the window the last prompt token's K/V is overwritten and the
    logits part by far more than the tolerance; above it they agree."""
    ref_model, ref_params, _, _ = pair
    tokens = _prompt(p + 1, seed=p + 70)
    _, caches = ref_model.prefill(ref_params,
                                  {"tokens": jnp.asarray(tokens[:, :p])})
    caches = ref_model.prefill_to_decode(ref_grow_caches(caches, p + 1, 16))
    stepped, _ = ref_model.decode_step(ref_params, jnp.asarray(tokens[:, p:]),
                                       caches, jnp.asarray(p, jnp.int32))
    whole, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    err = float(np.abs(np.asarray(stepped) - np.asarray(whole)).max())
    assert (err > 100 * TOL) == off, err


@pytest.mark.parametrize("p", [8, 16, 23])
def test_decode_after_prefill_equals_prefill_of_one_more(pair, p):
    """The port's own decode ≡ prefill invariant, below, at and above the
    window."""
    _, _, model, params = pair
    tokens = _tokens(_prompt(p + 1, seed=p + 50))
    _, caches = model.prefill(params, {"tokens": tokens[:, :p]})
    caches = model.prefill_to_decode(grow_caches(caches, p + 1, 16))
    stepped, _ = model.decode_step(params, tokens[:, p:], caches, p)
    whole, _ = model.prefill(params, {"tokens": tokens})
    np.testing.assert_allclose(stepped.numpy(), whole.numpy(), rtol=TOL,
                               atol=TOL)


def test_grow_caches_grows_a_window_buffer_up_to_the_window():
    k = torch.ones((2, 3, 8, 1, 4))
    tree = {"blocks": [{"k": k, "v": k}, {"h": torch.ones((2, 3, 5))}],
            "prefix": [], "tail": []}
    for target, want in ((11, 11), (40, 16), (6, 8)):
        out = grow_caches(tree, target, window=16)
        assert out["blocks"][0]["k"].shape[2] == want
        assert out["blocks"][1]["h"].shape == (2, 3, 5)
        assert float(out["blocks"][0]["v"][:, :, 8:].abs().sum()) == 0.0
    # a buffer already at the window stays as it is
    full = torch.ones((2, 16, 1, 4))
    assert grow_caches({"k": full}, 40, window=16)["k"] is full


def test_generate_matches_reference_tokens(pair):
    """Greedy tokens equal the reference's wherever the reference's top-2
    logit gap exceeds the tolerance; a row is compared up to its first
    near-tie, after which the two may rightly part."""
    ref_model, ref_params, model, params = pair
    tokens = _prompt(24, seed=2)
    gen, logits = _reference_run(ref_model, ref_params, tokens, 6)
    first, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    deciding = [np.asarray(first)] + logits[:-1]
    out = ServingEngine(model, params, max_new_tokens=6).generate(
        {"tokens": _tokens(tokens)})
    assert out.tokens.shape == (BATCH, 6)
    compared = 0
    for b in range(BATCH):
        for i in range(6):
            top2 = np.sort(deciding[i][b])[-2:]
            if top2[1] - top2[0] <= TOL:
                break
            assert out.tokens[b, i] == gen[b, i], (b, i)
            compared += 1
    assert compared >= 6


@pytest.mark.parametrize("arch_cfg", ["reduced", "full"])
def test_param_tree_matches_reference_definitions(arch_cfg):
    cfg = _cfg() if arch_cfg == "reduced" else get_config("recurrentgemma-2b")
    ref_defs = ref_build_model(cfg).param_defs()
    defs = Model(cfg, device="cpu").param_defs()
    want = jax.tree.map(lambda p: (p.shape, p.logical, p.init, p.init_scale),
                        ref_defs, is_leaf=is_param_def)
    got = tree_map(lambda p: (p.shape, p.logical, p.init, p.init_scale), defs)
    assert got == want


@pytest.mark.parametrize("seq", [8, 40])
def test_cache_tree_matches_reference_definitions(pair, seq):
    ref_model, _, model, _ = pair
    for mode in ("prefill", "decode"):
        want = jax.tree.map(lambda p: (p.shape, np.dtype(p.dtype).name),
                            ref_model.cache_defs(3, seq, mode=mode),
                            is_leaf=is_param_def)
        got = tree_map(lambda p: (p.shape, str(p.dtype).split(".")[-1]),
                       model.cache_defs(3, seq, mode=mode))
        assert got == want


def test_caches_from_jax_carries_decode_caches(pair):
    ref_model, ref_params, model, params = pair
    tokens = _prompt(20, seed=4)
    _, ref_caches = ref_model.prefill(ref_params,
                                      {"tokens": jnp.asarray(tokens)})
    ref_caches = ref_model.prefill_to_decode(ref_caches)
    caches = caches_from_jax(jax.tree.map(np.asarray, ref_caches), "cpu")
    tok = np.full((BATCH, 1), 3, np.int32)
    want, _ = ref_model.decode_step(ref_params, jnp.asarray(tok), ref_caches,
                                    jnp.asarray(20, jnp.int32))
    got, _ = model.decode_step(params, _tokens(tok), caches, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_serve_launcher_runs_on_cpu():
    ops.reset_launch_count()
    out = serve.main(["--arch", "recurrentgemma-2b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "21",
                      "--new-tokens", "3"])
    assert out.tokens.shape == (2, 3)
    assert out.prefill_seconds > 0 and out.decode_seconds > 0
    assert all(ops.launch_count(n) == 0 for n in ops.KERNELS)  # plain on CPU
