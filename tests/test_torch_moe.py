"""The port's mixture-of-experts FFN (``models/moe.py``) and the MoE
models built on it against the JAX reference, on the CPU.

Models run in their ``tests/conftest.py::reduced`` float32 configs
(``deepseek-moe-16b``: a dense first layer of width 128, then two MoE
layers of 8 experts, top 2, two shared experts; ``arctic-480b``: MoE
layers of 8 experts, top 2, each beside a dense residual FFN), with one
set of random numpy weights carried into the port by
``models.convert.params_from_jax``.

Tolerances:
- expert indices, capacities and slots: exactly, ties included (a stable
  descending sort keeps ``jax.lax.top_k``'s lower index first).
- one MoE layer (outputs and aux loss): 1e-5 absolute.  Both sides form
  the same fp32 products; the expert and combine products add in other
  orders.
- logits, caches, the loss and every gradient leaf: 1e-4 (relative to a
  gradient leaf's largest entry), as ``tests/test_torch_dense.py`` and
  ``tests/test_torch_train.py`` hold the dense models.
- one AdamW step from the reference's state: each parameter within 1e-4
  of its leaf's largest entry plus the first step's sensitivity to its
  gradient (``_adam_bound``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as RefRunConfig
from repro.config import ShapeConfig as RefShapeConfig
from repro.config import TrainConfig as RefTrainConfig
from repro.config.base import MeshConfig as RefMeshConfig
from repro.models import build_model as ref_build_model
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.parallel.sharding import is_param_def
from repro.serving import ServingEngine as RefEngine
from repro.serving.kvcache import grow_caches as ref_grow_caches
from repro.train import loop as ref_loop
from repro.train import microbatch as ref_microbatch
from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.serving import ServingEngine, grow_caches
from repro_torch.train import loop, microbatch
from repro_torch.tree import tree_leaves_with_path, tree_map
from tests.conftest import reduced

LAYER_TOL = 1e-5
TOL = 1e-4
BATCH = 2
PROMPT = 20
MOE = ["deepseek-moe-16b", "arctic-480b"]
MODES = ["einsum", "scatter"]


def _cfg(arch, **kw):
    return reduced(arch, dtype="float32", **kw)


def _numpy_tree(defs, seed):
    """Random values for every ParamDef leaf, away from the zero/one
    inits, matrices scaled by their fan-in."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        if p.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        elif p.init == "zeros":
            a = 0.1 * rng.standard_normal(p.shape)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, defs, is_leaf=is_param_def)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


_PAIRS = {}


def _pair(arch, **kw):
    """(cfg, reference model, its params, port model, its params), made
    once a config in this module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        cfg = _cfg(arch, **kw)
        ref_model = ref_build_model(cfg)
        weights = _numpy_tree(ref_model.param_defs(), seed=0)
        _PAIRS[key] = (cfg, ref_model, jax.tree.map(jnp.asarray, weights),
                       Model(cfg, device="cpu"),
                       params_from_jax(weights, cfg, "cpu"))
    return _PAIRS[key]


def _prompt(cfg, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (BATCH, s), dtype=np.int32)


def _tokens(a):
    return torch.from_numpy(a).long()


def _close(got, want, tol=LAYER_TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def _rel_close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{what}: relative error {err} > {tol}"


def _layer(arch, seed=0, **kw):
    """A reduced config's MoE layer parameters, on both sides."""
    cfg = _cfg(arch, **kw)
    return (cfg,) + _both(_numpy_tree(RM.moe_defs(cfg), seed))


# -- the reference's formulas for the slots and the combine tensor ----------


def _reference_combine(cfg, idx, gate):
    """``combine [T, E, C]`` as ``src/repro/models/moe.py::_dispatch_einsum``
    builds it (its lines, on the same expert indices and gates)."""
    idx, gate = jnp.asarray(idx), jnp.asarray(gate)
    t = idx.shape[0]
    e, k = cfg.num_experts, cfg.moe_top_k
    c = RM.capacity(cfg, t)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    pos = (jnp.cumsum(onehot.reshape(t * k, e), axis=0) - 1.0).reshape(t, k, e)
    in_cap = pos < c
    pos_oh = jax.nn.one_hot(jnp.einsum("tke,tke->tk", pos, onehot)
                            .astype(jnp.int32), c, dtype=jnp.float32)
    return np.asarray(jnp.einsum("tke,tk,tkc,tke->tec", onehot, gate, pos_oh,
                                 in_cap.astype(jnp.float32)))


def _port_combine(cfg, idx, gate):
    """The port's combine tensor, read back through its einsum with an
    identity expert output: ``_dispatch_einsum`` with experts that return
    their slot's one-hot."""
    t = idx.shape[0]
    e, c = cfg.num_experts, M.capacity(cfg, t)
    eye = torch.eye(e * c).view(e, c, e * c)
    captured = {}

    def expert_ffn(cfg_, params, xe):
        captured["xe"] = xe
        return eye

    orig = M._expert_ffn
    M._expert_ffn = expert_ffn
    try:
        xf = torch.arange(1, t + 1, dtype=torch.float32)[:, None]
        out = M._dispatch_einsum(cfg, None, xf, torch.from_numpy(idx),
                                 torch.from_numpy(gate))
    finally:
        M._expert_ffn = orig
    return out.view(t, e, c).numpy(), captured["xe"][..., 0].numpy()


# ---------------------------------------------------------------------------
# definitions and capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ff_shard", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_moe_defs_match_reference(arch, ff_shard):
    """Both layouts, with shared experts (``deepseek-moe-16b``) and without
    (``arctic-480b``), at full width: shapes, logical axes and inits."""
    cfg = dataclasses.replace(get_config(arch), opt_moe_ff_shard=ff_shard)
    fields = lambda p: (tuple(p.shape), tuple(p.logical), p.init,  # noqa
                        p.init_scale, p.dtype)
    want = jax.tree.map(fields, RM.moe_defs(cfg), is_leaf=is_param_def)
    got = tree_map(fields, M.moe_defs(cfg))
    assert got == want
    assert ("shared" in got) == bool(cfg.num_shared_experts)


@pytest.mark.parametrize("arch", MOE + ["llava-next-34b"])
def test_param_defs_match_reference_at_full_width(arch):
    """The whole model's definitions: the dense first layer's width, the
    MoE layers' ``ffn`` and arctic's ``dense_res``, llava's
    ``frontend.proj``."""
    cfg = get_config(arch)
    fields = lambda p: (tuple(p.shape), tuple(p.logical), p.init)  # noqa
    want = jax.tree.map(fields, RT.build_param_defs(cfg),
                        is_leaf=is_param_def)
    got = tree_map(fields, T.build_param_defs(cfg))
    assert got == want


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0, 8.0])
def test_capacity_matches_reference(arch, factor):
    cfg = dataclasses.replace(get_config(arch), capacity_factor=factor)
    for t in (1, 2, 4, 7, 8, 31, 64, 100, 1000, 2048, 4096, 12288, 16256):
        assert M.capacity(cfg, t) == RM.capacity(cfg, t), t


def test_capacity_at_the_card_shapes():
    cfg = get_config("deepseek-moe-16b")
    assert M.capacity(cfg, 4096) == 480          # a 1,024-position segment
    assert M.capacity(cfg, 16256) == 1912        # 4 x 4,064 unsegmented
    assert M.capacity(cfg, 4) == 8               # a decode step of batch 4


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.5, 0.3, 0.5, 0.5, 0.2],
                      [0.2, 0.2, 0.2, 0.2, 0.1, 0.1],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = M.top_k_lower_first(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0].tolist() == [1, 3, 4]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_route_matches_reference(arch, ties):
    """Expert indices exactly, gates, probabilities and the aux loss within
    1e-5.  With ``ties``, router columns 1, 3 and 5 are equal and column 6
    is column 2: their logits are equal for every token, so each top-k
    choice among them is a tie."""
    cfg, jp, tp = _layer(arch, seed=1)
    router = np.array(tp["router"])
    if ties:
        router[:, 3] = router[:, 1]
        router[:, 5] = router[:, 1]
        router[:, 6] = router[:, 2]
        router *= 0.05                 # flat probabilities: ties in the top k
    x = np.random.default_rng(2).standard_normal(
        (64, cfg.d_model)).astype(np.float32)
    want = RM._route(cfg, {"router": jnp.asarray(router)}, jnp.asarray(x))
    got = M._route(cfg, {"router": torch.from_numpy(router)},
                   torch.from_numpy(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w, name in zip(got[1:], want[1:], ("gate", "aux", "probs")):
        _close(g, w, what=name)
    if ties:
        p = got[3].numpy()
        tied = np.isclose(p[:, 1], p[:, 3], rtol=0, atol=0)
        assert tied.all()
        chose = got[0].numpy()
        both = ((chose == 1).any(1) & (chose == 3).any(1)).sum()
        assert (((chose == 3).any(1) & ~(chose == 1).any(1)).sum() == 0
                and both > 0), "a tie went to the higher index"


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _route_inputs(cfg, t, seed):
    """Distinct expert choices for each token (a skewed draw, so that some
    experts overflow) and normalised gates."""
    rng = np.random.default_rng(seed)
    e, k = cfg.num_experts, cfg.moe_top_k
    weights = np.linspace(3.0, 1.0, e)
    weights /= weights.sum()
    idx = np.stack([rng.choice(e, size=k, replace=False, p=weights)
                    for _ in range(t)]).astype(np.int32)
    gate = rng.random((t, k)).astype(np.float32) + 0.05
    gate /= gate.sum(-1, keepdims=True)
    return idx, gate


@pytest.mark.parametrize("factor", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("arch", MOE)
def test_slots_and_combine_equal_the_reference_formula(arch, factor):
    """The combine tensor ``[T, E, C]`` equal to the reference's four-way
    einsum bit for bit (so every slot and drop), and the dispatched expert
    input equal to ``(combine > 0)`` times the tokens."""
    cfg = _cfg(arch, capacity_factor=factor)
    t = 96
    idx, gate = _route_inputs(cfg, t, seed=int(factor * 4))
    want = _reference_combine(cfg, idx, gate)
    got, xe = _port_combine(cfg, idx, gate)
    np.testing.assert_array_equal(got, want)
    dispatch = (want > 0).astype(np.float32)
    tokens = np.arange(1, t + 1, dtype=np.float32)
    np.testing.assert_array_equal(xe, np.einsum("tec,t->ec", dispatch,
                                                tokens))
    kept = int((want > 0).sum())
    if factor == 0.5:
        assert kept < t * cfg.moe_top_k        # some pairs dropped
    if factor == 4.0:
        assert kept == t * cfg.moe_top_k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("factor", [0.5, 4.0])
@pytest.mark.parametrize("arch", MOE)
def test_dispatch_matches_reference(arch, factor, mode):
    """One dispatch call on the same indices and gates: at 0.5 the skewed
    choices overflow experts (pairs drop), at 4.0 nothing drops."""
    cfg, jp, tp = _layer(arch, seed=3, capacity_factor=factor)
    idx, gate = _route_inputs(cfg, 96, seed=5)
    x = np.random.default_rng(6).standard_normal(
        (96, cfg.d_model)).astype(np.float32)
    ref_fn = RM._dispatch_scatter if mode == "scatter" else RM._dispatch_einsum
    fn = M._dispatch_scatter if mode == "scatter" else M._dispatch_einsum
    want = ref_fn(cfg, jp, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gate))
    got = fn(cfg, tp, torch.from_numpy(x), torch.from_numpy(idx),
             torch.from_numpy(gate))
    _close(got, want)
    _, keep = M._slots(cfg, torch.from_numpy(idx), M.capacity(cfg, 96))
    assert bool(keep.all()) == (factor == 4.0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seg", [0, 8])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch, seg, mode):
    """``moe_apply`` on x [2, 32, D]: in four segments of 8 positions
    (T = 16 each, aux the segments' mean) and whole (T = 64), at the
    config's capacity factor and at 0.5 (pairs drop)."""
    for factor in (1.25, 0.5):
        cfg, jp, tp = _layer(arch, seed=7, moe_seq_chunk=seg,
                             capacity_factor=factor)
        x = np.random.default_rng(8).standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32)
        want_y, want_aux = RM.moe_apply(cfg, jp, jnp.asarray(x),
                                        dispatch=mode)
        got_y, got_aux = M.moe_apply(cfg, tp, torch.from_numpy(x),
                                     dispatch=mode)
        assert got_aux.dtype == torch.float32 and got_aux.dim() == 0
        _close(got_y, want_y, what=f"y at {factor}")
        _close(got_aux, want_aux, what=f"aux at {factor}")


def test_mode_comes_from_the_call_then_the_config(monkeypatch):
    cfg, _, tp = _layer("deepseek-moe-16b", seed=9, capacity_factor=0.5)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    calls = []
    for name in ("_dispatch_einsum", "_dispatch_scatter"):
        def spy(*a, _orig=getattr(M, name), _name=name):
            calls.append(_name)
            return _orig(*a)

        monkeypatch.setattr(M, name, spy)
    scatter = dataclasses.replace(cfg, moe_dispatch="scatter")
    M.moe_apply(cfg, tp, x)
    M.moe_apply(scatter, tp, x)
    M.moe_apply(scatter, tp, x, dispatch="einsum")
    M.moe_apply(dataclasses.replace(cfg, moe_dispatch=""), tp, x)
    assert calls == ["_dispatch_einsum", "_dispatch_scatter",
                     "_dispatch_einsum", "_dispatch_einsum"]
    with pytest.raises(ValueError, match="einsum or scatter"):
        M.moe_apply(cfg, tp, x, dispatch="dense")


def test_scatter_dispatch_matches_einsum_dispatch():
    """The reference's ``tests/test_perf_variants.py`` check in the port: a
    reduced ``deepseek-moe-16b`` layer (random weights from the model's
    init), x [2, 16, D], both modes within 2e-2 and their aux losses within
    1e-5 relative; and here, in fp32, the two modes within 1e-5."""
    cfg = reduced("deepseek-moe-16b")
    model = Model(cfg, device="cpu")
    params = model.init(model.generator(0), param_dtype=torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=model.generator(1))
    lp = tree_map(lambda t: t[0], params["blocks"][0]["ffn"])
    y_e, aux_e = M.moe_apply(cfg, lp, x, dispatch="einsum")
    y_s, aux_s = M.moe_apply(cfg, lp, x, dispatch="scatter")
    np.testing.assert_allclose(y_e.float().numpy(), y_s.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(aux_e), float(aux_s), rtol=1e-5)
    np.testing.assert_allclose(y_e.numpy(), y_s.numpy(), rtol=LAYER_TOL,
                               atol=LAYER_TOL)


# ---------------------------------------------------------------------------
# the MoE models end to end
# ---------------------------------------------------------------------------


def test_first_layer_is_dense_at_its_own_width():
    cfg = get_config("deepseek-moe-16b")
    defs = T.build_param_defs(cfg)
    assert defs["prefix"][0]["ffn"]["wi"].shape == (2048, 10944)
    assert defs["blocks"][0]["ffn"]["we_i"].shape == (27, 64, 2048, 1408)
    assert defs["blocks"][0]["ffn"]["shared"]["wi"].shape == (27, 2048, 2816)
    arctic = T.build_param_defs(get_config("arctic-480b"))
    assert arctic["blocks"][0]["dense_res"]["wi"].shape == (35, 7168, 4864)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE)
def test_prefill_logits_and_caches_match_reference(arch, mode):
    cfg, ref_model, ref_params, model, params = _pair(arch,
                                                      moe_dispatch=mode)
    tokens = _prompt(cfg, PROMPT, seed=1)
    want_logits, want_caches = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, caches = model.prefill(params, {"tokens": _tokens(tokens)})
    _close(logits, want_logits, TOL)
    want_leaves = jax.tree_util.tree_flatten_with_path(want_caches)[0]
    got_leaves = list(tree_leaves_with_path(caches))
    assert len(got_leaves) == len(want_leaves)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        _close(g, w, TOL, str(path))


def _reference_decode(cfg, ref_model, ref_params, tokens, steps):
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


@pytest.mark.parametrize("arch", MOE)
def test_decode_steps_match_reference(arch):
    """Three decode steps (T = 2 tokens a step, capacity 8: nothing drops)
    after a 20-token prompt: logits at each step, caches after the last."""
    cfg, ref_model, ref_params, model, params = _pair(arch)
    tokens = _prompt(cfg, PROMPT + 3, seed=2)
    want = _reference_decode(cfg, ref_model, ref_params, tokens, 3)
    _, caches = model.prefill(params, {"tokens": _tokens(tokens[:, :PROMPT])})
    caches = model.prefill_to_decode(grow_caches(caches, PROMPT + 3))
    for i in range(3):
        logits, caches = model.decode_step(
            params, _tokens(tokens[:, PROMPT + i:PROMPT + i + 1]), caches,
            PROMPT + i)
        _close(logits, want[i][0], TOL, f"step {i}")
    for (path, g), (_, w) in zip(
            tree_leaves_with_path(caches),
            jax.tree_util.tree_flatten_with_path(want[-1][1])[0]):
        _close(g, w, TOL, str(path))


@pytest.mark.parametrize("arch", MOE)
def test_decode_after_prefill_equals_prefill_of_one_more(arch):
    """The port's own decode ≡ prefill invariant where nothing drops (a
    capacity factor that gives every expert room for every pair)."""
    cfg, _, _, model, params = _pair(arch, capacity_factor=8.0)
    tokens = _tokens(_prompt(cfg, PROMPT + 1, seed=3))
    assert M.capacity(cfg, BATCH * (PROMPT + 1)) >= \
        BATCH * (PROMPT + 1) * cfg.moe_top_k / cfg.num_experts * 4
    _, caches = model.prefill(params, {"tokens": tokens[:, :PROMPT]})
    caches = model.prefill_to_decode(grow_caches(caches, PROMPT + 1))
    stepped, _ = model.decode_step(params, tokens[:, PROMPT:], caches, PROMPT)
    whole, _ = model.prefill(params, {"tokens": tokens})
    np.testing.assert_allclose(stepped.numpy(), whole.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", MOE)
def test_generate_matches_reference_tokens(arch):
    """Greedy tokens equal the reference engine's wherever the reference's
    top-2 logit gap exceeds 1e-3; a row is compared up to its first
    near-tie."""
    cfg, ref_model, ref_params, model, params = _pair(arch)
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


def _batch(cfg, b=2, s=24, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("seg", [0, 8])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE)
def test_loss_aux_and_gradients_match_reference(arch, mode, seg):
    """``Model.loss`` (remat full) on a batch of 2 × 24 (whole, T = 48, or
    in three segments of 8 positions): loss, ``ce`` and ``aux`` within
    1e-4, every gradient leaf within 1e-4 of its largest entry, the router
    and experts' included."""
    cfg = _cfg(arch, moe_dispatch=mode, moe_seq_chunk=seg)
    ref_model = ref_build_model(cfg)
    weights = _numpy_tree(ref_model.param_defs(), seed=4)
    batch = _batch(cfg)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        ref_model.loss, has_aux=True))(jax.tree.map(jnp.asarray, weights),
                                       {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    model = Model(cfg, device="cpu")
    (got, got_m), got_g = microbatch.value_and_grad(
        model.loss, params_from_jax(weights, cfg, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(got_m["aux"]), float(want_m["aux"]),
                               rtol=TOL)
    assert float(got_m["aux"]) > 0
    np.testing.assert_allclose(
        float(got), float(got_m["ce"]) + 0.01 * float(got_m["aux"]),
        rtol=1e-6)
    want_leaves = jax.tree_util.tree_flatten_with_path(want_g)[0]
    got_leaves = list(tree_leaves_with_path(got_g))
    assert len(got_leaves) == len(want_leaves)
    names = set()
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(np.shape(w)), path
        _rel_close(g.numpy(), w, TOL, str(path))
        assert float(torch.abs(g).max()) > 0.0, path
        names.add(path[-1])
    assert {"router", "we_i", "we_g", "we_d"} <= names


def _runs(cfg):
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=20)
    ref_run = RefRunConfig(model=cfg, shape=RefShapeConfig("t", "train", 24,
                                                           2),
                           mesh=RefMeshConfig((1, 1), ("data", "model")),
                           train=RefTrainConfig(**dataclasses.asdict(tcfg)))
    return ref_run, RunConfig(model=cfg, shape=ShapeConfig("t", "train", 24,
                                                           2),
                              mesh=MeshConfig((1, 1), ("data", "model")),
                              train=tcfg)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE)
def test_one_adamw_step_matches_reference(arch, mode):
    """Two ``make_train_step`` calls on both sides from the reference's
    ``init_state`` (carried by ``train_state_from_jax``, which carries the
    router, expert, shared and dense-residual leaves and their moments):
    the losses within 1e-4.  The schedule's rate is 0 at step 0, so the
    second step is the first AdamW update that moves a parameter: each
    parameter after it within 1e-4 of its leaf's largest entry, except
    where a gradient is near zero (within 1e-2 of its leaf's largest),
    where ``lr · m / (sqrt(v) + eps)`` may turn a gradient difference of
    1e-4 of the leaf's largest into another sign: there within 2 lr."""
    cfg = _cfg(arch, moe_dispatch=mode)
    ref_run, run = _runs(cfg)
    ref_model = ref_build_model(cfg)
    jstate = ref_loop.init_state(ref_model, ref_run, jax.random.PRNGKey(0))
    numpy_state = jax.tree.map(np.asarray, jstate)
    state = train_state_from_jax(numpy_state, cfg, "cpu")
    for (path, g), w in zip(tree_leaves_with_path(state),
                            jax.tree.leaves(numpy_state)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    carried = {p[-1] for p, _ in tree_leaves_with_path(state.params)}
    assert {"router", "we_i", "we_g", "we_d"} <= carried
    assert ("shared" in state.params["blocks"][0]["ffn"]) == \
        bool(cfg.num_shared_experts)
    assert ("dense_res" in state.params["blocks"][0]) == \
        cfg.moe_dense_residual
    batches = [_batch(cfg, seed=s) for s in (11, 12)]
    grads = [jax.tree.leaves(ref_microbatch.accumulate_gradients(
        ref_model.loss, jstate.params,
        {k: jnp.asarray(v) for k, v in b.items()},
        ref_run.microbatches())[2]) for b in batches]
    ref_step = jax.jit(ref_loop.make_train_step(ref_model, ref_run))
    step = loop.make_train_step(Model(cfg, device="cpu"), run)
    for b in batches:
        jstate, want_m = ref_step(jstate, {k: jnp.asarray(v)
                                           for k, v in b.items()})
        state, got_m = step(state, loop.to_device(b, "cpu"))
        np.testing.assert_allclose(float(got_m["loss"]),
                                   float(want_m["loss"]), rtol=TOL)
    lr = 1e-2 / 2                              # step 1 of a 2-step warm-up
    moved = 0
    for (path, g), w, w0, g1, g2 in zip(tree_leaves_with_path(state.params),
                                        jax.tree.leaves(jstate.params),
                                        jax.tree.leaves(numpy_state.params),
                                        *grads):
        w, g1, g2 = np.asarray(w), np.asarray(g1), np.asarray(g2)
        near_zero = ((np.abs(g1) <= 1e-2 * np.abs(g1).max())
                     | (np.abs(g2) <= 1e-2 * np.abs(g2).max()))
        bound = np.where(near_zero, 2 * lr, TOL * np.abs(w).max())
        assert (np.abs(g.numpy() - w) <= bound).all(), path
        moved += int((w != w0).any())
    assert moved == len(jax.tree.leaves(jstate.params))


@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_carries_the_moe_subtrees(arch):
    """Every leaf bit for bit, the router, experts, shared experts and the
    dense residual among them; a tree whose expert stack has another shape
    is refused."""
    cfg, ref_model, _, _, _ = _pair(arch)
    weights = _numpy_tree(ref_model.param_defs(), seed=5)
    params = params_from_jax(weights, cfg, "cpu")
    got = list(tree_leaves_with_path(params))
    want = jax.tree_util.tree_flatten_with_path(weights)[0]
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    paths = {"/".join(map(str, p)) for p, _ in got}
    assert "blocks/0/ffn/router" in paths
    assert ("prefix/0/ffn/wi" in paths) == bool(cfg.first_dense_layers)
    assert ("blocks/0/ffn/shared/wd" in paths) == bool(cfg.num_shared_experts)
    assert ("blocks/0/dense_res/wd" in paths) == cfg.moe_dense_residual
    weights["blocks"][0]["ffn"]["we_i"] = weights["blocks"][0]["ffn"][
        "we_i"][:, :-1]
    with pytest.raises(ValueError, match="differs"):
        params_from_jax(weights, cfg, "cpu")


@pytest.mark.parametrize("arch", MOE)
def test_serve_launcher_runs_moe_on_cpu(arch):
    ops.reset_launch_count()
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "17",
                      "--new-tokens", "3"])
    assert out.tokens.shape == (2, 3)
    assert all(ops.launch_count(n) == 0 for n in ops.KERNELS)  # plain on CPU


def test_train_launcher_runs_moe_on_cpu():
    report = launch_train.main(["--arch", "deepseek-moe-16b", "--reduced",
                                "--device", "cpu", "--steps", "2",
                                "--batch", "2", "--seq", "32"])
    assert report.steps == 2 and all(np.isfinite(report.losses))
