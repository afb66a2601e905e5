"""The port's RWKV6-7B serving path against the reference, on the CPU.

A reduced ``rwkv6-7b`` (two stacked blocks, d_model 64, heads of 16,
float32) gets one set of random weights, made with numpy from a seed; the
reference runs them as JAX arrays and the port takes them through
``models.convert.params_from_jax``.  Prompts are numpy tokens given to
both.  The port's kernel wrappers run their plain versions here.

Tolerance: 1e-4 relative and absolute on logits and every cache leaf.
Both sides compute the same fp32 formulas; their matmuls, einsums and the
chunk form add in other orders, over two layers and a 256-way head.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ARCH_IDS as REF_ARCH_IDS
from repro.config import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.parallel.sharding import is_param_def
from repro.serving import ServingEngine as RefEngine
from repro.serving.kvcache import grow_caches as ref_grow_caches
from repro_torch.config import ARCH_IDS, ShapeConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.parallel.sharding import tree_shapes
from repro_torch.serving import ServingEngine, grow_caches
from repro_torch.tree import tree_leaves_with_path, tree_map
from tests.conftest import reduced

TOL = 1e-4
BATCH = 2


def _cfg():
    return reduced("rwkv6-7b", rwkv_head_dim=16, dtype="float32")


def _numpy_params(ref_model, seed=0):
    """Random weights for every leaf, away from the degenerate zero/one
    inits (token-shift mixes in (0, 1), a negative decay bias, norms near
    1), and matrices scaled by their fan-in so that activations stay of
    order one through the layers."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = jax.tree_util.keystr(path)
        if "mix" in name and p.init == "zeros":
            a = rng.random(p.shape)
        elif "decay_bias" in name:
            a = -1.0 + 0.5 * rng.standard_normal(p.shape)
        elif p.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:                       # matrices: 1 / sqrt(fan-in)
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
    vocab = _cfg().vocab_size
    return np.random.default_rng(seed).integers(0, vocab, (BATCH, s),
                                                dtype=np.int32)


def _assert_trees_close(got, want):
    got_leaves = list(tree_leaves_with_path(got))
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_leaves)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=str(path))


@pytest.mark.parametrize("s", [32, 13, 5])
def test_prefill_logits_and_caches_match_reference(pair, s):
    ref_model, ref_params, model, params = pair
    tokens = _prompt(s, seed=s)
    want_logits, want_caches = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(tokens).long()})
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
    caches = ref_model.prefill_to_decode(
        ref_grow_caches(caches, tokens.shape[1] + n_new))
    logits = []
    for i in range(n_new):
        out, caches = ref_model.decode_step(
            ref_params, jnp.asarray(gen[:, i:i + 1]), caches,
            jnp.asarray(tokens.shape[1] + i, jnp.int32))
        logits.append(np.asarray(out))
    return gen, logits


def test_decode_steps_match_reference(pair):
    ref_model, ref_params, model, params = pair
    tokens = _prompt(11, seed=1)
    gen, want = _reference_run(ref_model, ref_params, tokens, 8)
    _, caches = model.prefill(params,
                              {"tokens": torch.from_numpy(tokens).long()})
    caches = model.prefill_to_decode(grow_caches(caches, 11 + 8))
    for i in range(8):
        logits, caches = model.decode_step(
            params, torch.from_numpy(gen[:, i:i + 1]).long(), caches, 11 + i)
        np.testing.assert_allclose(logits.numpy(), want[i], rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")


def test_generate_matches_reference_tokens(pair):
    """Greedy tokens equal the reference's wherever the reference's top-2
    logit gap exceeds the tolerance; a row is compared up to its first
    near-tie, after which the two may rightly part."""
    ref_model, ref_params, model, params = pair
    tokens = _prompt(24, seed=2)
    gen, logits = _reference_run(ref_model, ref_params, tokens, 8)
    # the token decoded at step i comes from the previous step's logits;
    # the first from the prefill
    first, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)})
    deciding = [np.asarray(first)] + logits[:-1]
    out = ServingEngine(model, params, max_new_tokens=8).generate(
        {"tokens": torch.from_numpy(tokens).long()})
    assert out.tokens.shape == (BATCH, 8)
    compared = 0
    for b in range(BATCH):
        for i in range(8):
            top2 = np.sort(deciding[i][b])[-2:]
            if top2[1] - top2[0] <= TOL:
                break
            assert out.tokens[b, i] == gen[b, i], (b, i)
            compared += 1
    assert compared >= 8


def test_param_tree_matches_reference_definitions():
    for arch_cfg in (_cfg(), get_config("rwkv6-7b")):
        ref_defs = ref_build_model(arch_cfg).param_defs()
        defs = Model(arch_cfg, device="cpu").param_defs()
        want = jax.tree.map(lambda p: (p.shape, p.logical, p.init,
                                       p.init_scale),
                            ref_defs, is_leaf=is_param_def)
        got = tree_map(lambda p: (p.shape, p.logical, p.init, p.init_scale),
                       defs)
        assert got == want


def test_cache_tree_matches_reference_definitions(pair):
    ref_model, _, model, _ = pair
    for mode in ("prefill", "decode"):
        want = jax.tree.map(lambda p: (p.shape, np.dtype(p.dtype).name),
                            ref_model.cache_defs(3, 16, mode=mode),
                            is_leaf=is_param_def)
        got = tree_map(lambda p: (p.shape, str(p.dtype).split(".")[-1]),
                       model.cache_defs(3, 16, mode=mode))
        assert got == want
    caches = model.init_cache(3, 16)
    assert tree_shapes(caches) == tree_shapes(model.cache_defs(3, 16))
    assert all(float(t.abs().sum()) == 0.0
               for _, t in tree_leaves_with_path(caches))


def test_caches_from_jax_carries_decode_caches(pair):
    ref_model, ref_params, model, params = pair
    tokens = _prompt(9, seed=4)
    _, ref_caches = ref_model.prefill(ref_params,
                                      {"tokens": jnp.asarray(tokens)})
    ref_caches = ref_model.prefill_to_decode(ref_caches)
    caches = caches_from_jax(jax.tree.map(np.asarray, ref_caches), "cpu")
    tok = np.full((BATCH, 1), 3, np.int32)
    want, _ = ref_model.decode_step(ref_params, jnp.asarray(tok), ref_caches,
                                    jnp.asarray(9, jnp.int32))
    got, _ = model.decode_step(params, torch.from_numpy(tok).long(), caches,
                               9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_params_from_jax_refuses_a_tree_of_another_model(pair):
    ref_model, _, _, _ = pair
    weights = _numpy_params(ref_model)
    with pytest.raises(ValueError):
        params_from_jax(weights, dataclasses.replace(_cfg(), d_ff=64), "cpu")


def test_params_from_jax_keeps_bf16():
    cfg = reduced("rwkv6-7b")                     # bf16
    ref_model = ref_build_model(cfg)
    weights = jax.tree.map(np.asarray, ref_model.init(jax.random.PRNGKey(0)))
    params = params_from_jax(weights, cfg, "cpu")
    emb = params["embed"]["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.float().numpy(), weights["embed"]["embedding"].astype(np.float32))


def test_grow_caches_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"blocks": [{"k": rng.standard_normal((2, 3, 5, 2, 4)),
                        "v": rng.standard_normal((2, 3, 5, 2, 4)),
                        "wkv": rng.standard_normal((2, 3, 2, 4, 4))}],
            "prefix": [], "tail": [{"shift_tm": rng.standard_normal((3, 8))}]}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    for target, window in ((9, 0), (4, 0), (9, 5)):
        want = ref_grow_caches(jax.tree.map(jnp.asarray, tree), target, window)
        got = grow_caches(jax.tree.map(torch.from_numpy, tree), target, window)
        _assert_trees_close(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert ARCH_IDS == REF_ARCH_IDS
    ours, theirs = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.param_count() == theirs.param_count()


def test_workload_config_is_not_a_model():
    with pytest.raises(ValueError):
        Model(get_config("paper-subsample"), device="cpu")


def test_init_is_seeded_and_keeps_the_defined_inits():
    model = Model(_cfg(), device="cpu")
    a = model.init(model.generator(3))
    b = model.init(model.generator(3))
    c = model.init(model.generator(4))
    leaves = [(p, x, y, z) for (p, x), (_, y), (_, z) in zip(
        tree_leaves_with_path(a), tree_leaves_with_path(b),
        tree_leaves_with_path(c))]
    assert all(torch.equal(x, y) for _, x, y, _ in leaves)
    defs = dict(tree_leaves_with_path(model.param_defs()))
    for path, x, _, z in leaves:
        assert tuple(x.shape) == defs[path].shape
        if defs[path].init == "zeros":
            assert float(x.abs().max()) == 0.0
        elif defs[path].init == "ones":
            assert bool((x == 1).all())
        else:
            assert not torch.equal(x, z)
            assert abs(float(x.std()) - 0.02) < 0.01


def test_make_inputs_draws_tokens_in_range():
    model = Model(_cfg(), device="cpu")
    shape = ShapeConfig("t", "prefill", 17, 3)
    a = model.make_inputs(shape, model.generator(1))["tokens"]
    b = model.make_inputs(shape, model.generator(1))["tokens"]
    assert tuple(a.shape) == (3, 17) and torch.equal(a, b)
    assert 0 <= int(a.min()) and int(a.max()) < _cfg().vocab_size
    dec = model.make_inputs(ShapeConfig("d", "decode", 40, 3),
                            model.generator(1))
    assert tuple(dec["tokens"].shape) == (3, 1) and dec["pos"] == 39


def test_serve_launcher_runs_on_cpu():
    ops.reset_launch_count()
    out = serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "21",
                      "--new-tokens", "3"])
    assert out.tokens.shape == (2, 3)
    assert out.prefill_seconds > 0 and out.decode_seconds > 0
    assert ops.launch_count("rwkv6_chunked") == 0     # plain version on CPU
