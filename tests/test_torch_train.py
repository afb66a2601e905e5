"""The port's training side against the JAX reference on the CPU.

Models run in their ``tests/conftest.py::reduced`` float32 configs
(``internlm2-20b`` also at its own group of 6, as 12 query heads on 2);
the same numpy weights, states and batches go to both sides.  Tolerances:

* ``cross_entropy``, both gold-logit forms, masked: 1e-6 (the same fp32
  log-sum-exp and gather, reduced in another order).
* ``Model.loss`` and every gradient leaf against ``jax.value_and_grad``,
  remat full, dots and none: 1e-4 relative to the leaf's largest entry
  (fp32 products and sums in other orders through every layer; the port's
  attention keeps its probabilities in fp32, as the reference does in
  fp32 configs).
* one ``adamw.update`` from the same state, fp32, bf16 and int8 moments,
  and ``lr_schedule`` at warm-up, middle and end: 1e-6 (one fp32 step in
  the reference's order of operations); the int8 moments' quantize and
  linear dequantize bit for bit on the same inputs, the log-space
  dequantize within two ulps (an exp, whose implementations differ).
* ``accumulate_gradients`` at 1, 2 and 4 microbatches: 1e-5 relative.
* ``compress_grads``: the int8 values and scales bit for bit, the error
  feedback within 1e-7.
* three ``train()`` steps from the same state on the same batches: losses
  within 1e-4.
* the input pipeline (with and without a ``ReplicatedDataStore``),
  ``tune_microbatch_tokens`` and ``lm_token_corpus``: bit for bit (the
  same numpy code from the same seeds).
* ``flash_attention_bwd_ref`` against autograd through
  ``flash_attention_ref``, against the ``flash_attention`` Function's
  backward and against ``jax.grad`` of the reference's attention: 1e-5.
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
from repro.core.datastore import ReplicatedDataStore as RefStore
from repro.data import pipeline as ref_pipeline
from repro.data import synthetic as ref_synthetic
from repro.kernels import ref as jref
from repro.models.model import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.parallel import compression as ref_compression
from repro.parallel.sharding import is_param_def
from repro.train import loop as ref_loop
from repro.train import microbatch as ref_microbatch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.core.datastore import ReplicatedDataStore
from repro_torch.data import pipeline
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.optim import adamw
from repro_torch.parallel import compression
from repro_torch.train import loop, microbatch
from repro_torch.tree import tree_leaves, tree_map
from tests.conftest import reduced

TOL = 1e-4
CPU_MESH = MeshConfig((1, 1), ("data", "model"))
REF_MESH = RefMeshConfig((1, 1), ("data", "model"))


def _cfg(arch, **kw):
    if arch == "internlm2-20b-g6":
        return reduced("internlm2-20b", dtype="float32", num_heads=12,
                       num_kv_heads=2, head_dim=16, **kw)
    return reduced(arch, dtype="float32", **kw)


def _numpy_params(ref_model, seed=0):
    """Random weights for every leaf, away from the zero/one inits,
    matrices scaled by their fan-in."""
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


def _batch(cfg, b=2, s=24, seed=1, masked=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if masked:
        labels[0, :3] = -1
    return {"tokens": tokens, "labels": labels}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rel_close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    err = float(np.max(np.abs(got - want))) / scale if want.size else 0.0
    assert err <= tol, f"{what}: relative error {err} > {tol}"


# ---------------------------------------------------------------------------
# cross-entropy, loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("onehot", [False, True])
def test_cross_entropy_matches_reference(onehot):
    from repro.models import layers as RL
    rng = np.random.default_rng(3)
    logits = (4.0 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for m in (mask, None):
        want = RL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m),
                                onehot=onehot)
        got = L.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels),
                              None if m is None else torch.from_numpy(m),
                              onehot=onehot)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "internlm2-20b-g6",
                                  "musicgen-medium"])
def test_loss_and_gradients_match_reference(arch, remat):
    cfg = _cfg(arch, remat=remat)
    ref_model = RefModel(cfg)
    params = _numpy_params(ref_model)
    batch = _batch(cfg)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        ref_model.loss, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                       _jax(batch))
    model = Model(cfg, device="cpu")
    (got, got_m), got_g = microbatch.value_and_grad(
        model.loss, params_from_jax(params, cfg, "cpu"), _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]),
                               rtol=TOL)
    assert float(got_m["aux"]) == float(want_m["aux"]) == 0.0
    want_leaves = jax.tree.leaves(want_g)
    got_leaves = tree_leaves(got_g)
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        assert tuple(g.shape) == tuple(w.shape)
        _rel_close(g.numpy(), w, TOL, f"gradient leaf {i}")
        assert float(torch.abs(g).max()) > 0.0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal((16,)).astype(np.float32),
            "stack": [rng.standard_normal((3, 4, 8)).astype(np.float32)]}


def _opt_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
        params)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(moment_dtype):
    """One update from a state with non-zero moments (the reference's first
    update, carried over): parameters and decoded moments within 1e-6."""
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                      moment_dtype=moment_dtype)
    rcfg = RefTrainConfig(**dataclasses.asdict(cfg))
    params = _opt_params()
    jp = jax.tree.map(jnp.asarray, params)
    jstate = ref_adamw.init(jp, rcfg)
    jp, jstate, _ = ref_adamw.update(
        jax.tree.map(jnp.asarray, _opt_grads(params, 1)), jstate, jp,
        jnp.asarray(1e-2, jnp.float32), rcfg)
    from repro_torch.models.convert import _moments_from_jax, _to_torch
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)),
                  jax.tree.map(np.asarray, jp))
    tstate = adamw.AdamWState(
        _to_torch(np.asarray(jstate.count), "cpu"),
        _moments_from_jax(jax.tree.map(np.asarray, jstate.mu), "cpu"),
        _moments_from_jax(jax.tree.map(np.asarray, jstate.nu), "cpu"))
    grads = _opt_grads(params, 2)
    lr_j = ref_adamw.lr_schedule(rcfg, jnp.asarray(1, jnp.int32))
    lr_t = adamw.lr_schedule(cfg, torch.tensor(1, dtype=torch.int32))
    np.testing.assert_allclose(lr_t.numpy(), np.asarray(lr_j), rtol=1e-6)
    want_p, want_s, want_m = ref_adamw.update(
        jax.tree.map(jnp.asarray, grads), jstate, jp, lr_j, rcfg)
    got_p, got_s, got_m = adamw.update(
        tree_map(torch.from_numpy, grads), tstate, tp, lr_t, cfg)
    for g, w in zip(tree_leaves(got_p), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)
    assert int(got_s.count) == int(want_s.count) == 2
    is_q = lambda x: isinstance(x, ref_adamw.QuantMoment)  # noqa: E731
    for got_tree, want_tree in ((got_s.mu, want_s.mu),
                                (got_s.nu, want_s.nu)):
        got_l = adamw._moment_leaves(got_tree, lambda x: isinstance(
            x, adamw.QuantMoment))
        want_l = jax.tree.leaves(want_tree, is_leaf=is_q)
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(
                adamw._decode(g).numpy(),
                np.asarray(ref_adamw._decode(w, None)), rtol=1e-6,
                atol=1e-6)


@pytest.mark.parametrize("step", [0, 3, 50, 100, 140])
def test_lr_schedule_matches_reference(step):
    cfg = TrainConfig(learning_rate=3e-4, warmup_steps=10, total_steps=100)
    rcfg = RefTrainConfig(**dataclasses.asdict(cfg))
    want = ref_adamw.lr_schedule(rcfg, jnp.asarray(step, jnp.int32))
    got = adamw.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("log_space", [False, True])
def test_int8_moments_quantize_bitwise(log_space):
    rng = np.random.default_rng(4)
    x = np.abs(rng.standard_normal((5, 33))).astype(np.float32) \
        * np.float32(1e-3)
    x[1] = 0.0                                   # an all-zero row
    if not log_space:
        x[2] *= -1.0
    want = ref_adamw._quantize(jnp.asarray(x), log_space)
    got = adamw._quantize(torch.from_numpy(x), log_space)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert int(got.mode) == int(want.mode)
    decoded = adamw._dequantize(got).numpy()
    want_decoded = np.asarray(ref_adamw._dequantize(want, x.shape))
    if log_space:
        # exp of the same fp32 argument: XLA's and PyTorch's exp are not
        # correctly rounded and may part by an ulp
        np.testing.assert_allclose(decoded, want_decoded, rtol=2.4e-7,
                                   atol=0)
    else:
        np.testing.assert_array_equal(decoded, want_decoded)


@pytest.mark.parametrize("threshold", [4, 40])
def test_huge_leaf_updates_chunk_by_chunk(monkeypatch, threshold):
    """A leaf at the chunk threshold updates chunk by chunk over its
    leading dimension (one slice a chunk, or several), equal to the
    whole-leaf update (the threshold is lowered so that a small leaf
    crosses it)."""
    cfg = TrainConfig(moment_dtype="int8")
    params = {"w": torch.from_numpy(_opt_params()["stack"][0])}
    grads = {"w": torch.from_numpy(_opt_grads(_opt_params(), 5)["stack"][0])}
    state = adamw.init(params, cfg)
    lr = torch.tensor(1e-2)
    whole = adamw.update(grads, state, params, lr, cfg)
    monkeypatch.setattr(adamw, "CHUNK_THRESHOLD", threshold)
    sliced = adamw.update(grads, state, params, lr, cfg)
    assert torch.equal(whole[0]["w"], sliced[0]["w"])
    for a, b in zip(tree_leaves(whole[1]), tree_leaves(sliced[1])):
        assert torch.equal(a, b)
    torch.testing.assert_close(whole[2]["grad_norm"], sliced[2]["grad_norm"],
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# microbatches and compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_mb", [1, 2, 4])
def test_accumulate_gradients_matches_reference(n_mb):
    cfg = _cfg("deepseek-7b")
    ref_model = RefModel(cfg)
    params = _numpy_params(ref_model, seed=2)
    batch = _batch(cfg, b=4, s=16, seed=5)
    want_loss, want_m, want_g = jax.jit(
        lambda p, b: ref_microbatch.accumulate_gradients(
            ref_model.loss, p, b, n_mb))(jax.tree.map(jnp.asarray, params),
                                         _jax(batch))
    model = Model(cfg, device="cpu")
    got_loss, got_m, got_g = microbatch.accumulate_gradients(
        model.loss, params_from_jax(params, cfg, "cpu"), _torch(batch), n_mb)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]),
                               rtol=1e-5)
    for i, (g, w) in enumerate(zip(tree_leaves(got_g),
                                   jax.tree.leaves(want_g))):
        _rel_close(g.numpy(), w, 1e-5, f"leaf {i}")


def test_split_microbatches_shapes():
    batch = {"tokens": torch.zeros((8, 5), dtype=torch.int32)}
    out = microbatch.split_microbatches(batch, 4)
    assert tuple(out["tokens"].shape) == (4, 2, 5)
    with pytest.raises(ValueError):
        microbatch.split_microbatches(batch, 3)


def test_compress_grads_matches_reference():
    rng = np.random.default_rng(6)
    grads = {"a": (rng.standard_normal((6, 10)) * 0.01).astype(np.float32),
             "b": [rng.standard_normal((3, 2, 5)).astype(np.float32)],
             "c": rng.standard_normal((7,)).astype(np.float32)}
    for g in jax.tree.leaves(grads):
        q_w, s_w = ref_compression.quantize_int8(jnp.asarray(g))
        q_g, s_g = compression.quantize_int8(torch.from_numpy(g))
        np.testing.assert_array_equal(q_g.numpy(), np.asarray(q_w))
        np.testing.assert_array_equal(s_g.numpy(), np.asarray(s_w))
    ef_w = ref_compression.init_error_feedback(
        jax.tree.map(jnp.asarray, grads))
    ef_g = compression.init_error_feedback(tree_map(torch.from_numpy, grads))
    for rnd in range(2):                    # the feedback carried a round
        g_rnd = jax.tree.map(lambda a: a * (1.0 + rnd), grads)
        out_w, ef_w = ref_compression.compress_grads(
            jax.tree.map(jnp.asarray, g_rnd), ef_w)
        out_g, ef_g = compression.compress_grads(
            tree_map(torch.from_numpy, g_rnd), ef_g)
        for g, w in zip(tree_leaves(out_g), jax.tree.leaves(out_w)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(tree_leaves(ef_g), jax.tree.leaves(ef_w)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# the loop, checkpoint and resume
# ---------------------------------------------------------------------------


def _runs(cfg, **train_kw):
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=20,
                       **train_kw)
    shape = ShapeConfig("t", "train", 16, 4)
    ref_run = RefRunConfig(model=cfg, shape=RefShapeConfig("t", "train", 16,
                                                           4),
                           mesh=REF_MESH,
                           train=RefTrainConfig(**dataclasses.asdict(tcfg)))
    return ref_run, RunConfig(model=cfg, shape=shape, mesh=CPU_MESH,
                              train=tcfg)


def _pipe(cfg, seed=0):
    corpus = synthetic.lm_token_corpus(1 << 12, cfg.vocab_size,
                                       shard_tokens=1 << 10)
    return pipeline.SubsamplingBatchPipeline(
        corpus, pipeline.PipelineConfig(batch_size=4, seq_len=16, seed=seed))


@pytest.mark.parametrize("train_kw", [
    {}, {"moment_dtype": "int8", "grad_compression": "int8"}])
def test_three_train_steps_match_reference(train_kw):
    """``train()`` three steps on both sides from the same state (the
    reference's ``init_state``, carried over) on the same batches; the run
    splits each batch of 4 into 4 microbatches (64 tokens at the reduced
    kneepoint)."""
    cfg = _cfg("deepseek-7b", microbatch_tokens_per_device=16)
    ref_run, run = _runs(cfg, **train_kw)
    assert run.microbatches() == ref_run.microbatches() == 4
    ref_model = RefModel(cfg)
    jstate = ref_loop.init_state(ref_model, ref_run, jax.random.PRNGKey(0))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                 "cpu")
    want = ref_loop.train(ref_model, ref_run, _pipe(cfg).batches(None), 3,
                          state=jstate, log_every=100)
    got = loop.train(Model(cfg, device="cpu"), run,
                     _pipe(cfg).batches(None), 3, state=state,
                     log_every=100)
    assert len(got.losses) == len(want.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=TOL)
    assert got.losses[-1] < got.losses[0]


def test_train_state_from_jax_carries_every_leaf():
    cfg = _cfg("musicgen-medium", num_layers=2)
    ref_run, _ = _runs(cfg, moment_dtype="int8", grad_compression="int8")
    jstate = ref_loop.init_state(RefModel(cfg), ref_run,
                                 jax.random.PRNGKey(3))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                 "cpu")
    assert isinstance(state, loop.TrainState)
    want = jax.tree.leaves(jstate)
    got = tree_leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nu = adamw._moment_leaves(state.opt.nu,
                              lambda x: isinstance(x, adamw.QuantMoment))
    assert nu and all(isinstance(m, adamw.QuantMoment) and int(m.mode) == 1
                      for m in nu)


def test_job_level_restart_resumes_training(tmp_path):
    """The reference's scenario (6 steps with a checkpoint every 3, then a
    fresh ``train()`` to step 8 resumes at 6 and runs 2 steps), and the
    resumed losses equal those of the uninterrupted run continued on the
    same batches."""
    cfg = reduced("deepseek-7b", num_layers=2)
    _, run = _runs(cfg)
    model = Model(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    report = loop.train(model, run, _pipe(cfg).batches(None), 6,
                        checkpoint_manager=mgr, checkpoint_every=3,
                        log_every=100)
    assert report.steps == 6 and mgr.all_steps() == [3, 6]
    resumed = loop.train(model, run, _pipe(cfg).batches(None), 8,
                         checkpoint_manager=mgr, checkpoint_every=3,
                         log_every=100)
    assert len(resumed.losses) == 2, "should only run steps 6..8"

    # uninterrupted: 6 steps in memory, then steps 6..8 on a fresh pipeline
    state = loop.init_state(model, run)
    step = loop.make_train_step(model, run)
    batches = _pipe(cfg).batches(None)
    straight = []
    for _ in range(6):
        state, m = step(state, loop.to_device(next(batches), "cpu"))
        straight.append(float(m["loss"]))
    assert straight == report.losses
    after = loop.train(model, run, _pipe(cfg).batches(None), 8, state=state,
                       log_every=100)
    assert after.losses == resumed.losses


# ---------------------------------------------------------------------------
# the input pipeline
# ---------------------------------------------------------------------------


def test_lm_token_corpus_matches_reference():
    want = ref_synthetic.lm_token_corpus(5000, 300, seed=3,
                                         shard_tokens=1000)
    got = synthetic.lm_token_corpus(5000, 300, seed=3, shard_tokens=1000)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("store", [False, True])
def test_pipeline_batches_match_reference(store):
    corpus = ref_synthetic.lm_token_corpus(1 << 12, 500, seed=1,
                                           shard_tokens=1 << 9)
    want = ref_pipeline.SubsamplingBatchPipeline(
        corpus, ref_pipeline.PipelineConfig(batch_size=3, seq_len=40,
                                            seed=7),
        datastore=RefStore(n_initial=3) if store else None)
    got = pipeline.SubsamplingBatchPipeline(
        corpus, pipeline.PipelineConfig(batch_size=3, seq_len=40, seed=7),
        datastore=ReplicatedDataStore(n_initial=3) if store else None)
    for w, g in zip(want.batches(5), got.batches(5)):
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("args", [(2048, 1536, 48), (4096, 4096, 30),
                                  (128, 64, 2)])
def test_tune_microbatch_tokens_matches_reference(args):
    for kw in ({}, {"hbm_per_device": 80 * 2**30}):
        assert (pipeline.tune_microbatch_tokens(*args, **kw)
                == ref_pipeline.tune_microbatch_tokens(*args, **kw))


# ---------------------------------------------------------------------------
# the attention backward's plain version
# ---------------------------------------------------------------------------

BWD_CASES = [  # bh, sq, skv, hd, causal, window, group
    (4, 37, 37, 16, True, 0, 1),
    (6, 20, 29, 32, False, 0, 2),
    (12, 33, 33, 16, True, 0, 6),
    (4, 30, 21, 16, True, 0, 2),
    (4, 40, 12, 16, True, 4, 1),      # rows 15.. see no key
]


def _bwd_inputs(bh, sq, skv, hd, group, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bh // group, skv, hd)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_attention_bwd_ref_matches_autograd(case):
    bh, sq, skv, hd, causal, window, group = case
    q, k, v, do = (torch.from_numpy(a)
                   for a in _bwd_inputs(bh, sq, skv, hd, group))
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  group=group)
    lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window,
                                      group=group)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                      window=window, group=group)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*leaves, causal=causal, window=window,
                                group=group), leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    if window == 0:
        # the differentiable op on the CPU: the Function's wiring
        fn = ops.flash_attention(*leaves, causal=causal, group=group)
        via_op = torch.autograd.grad(fn, leaves, do)
        for g, w in zip(via_op, got):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert all(ops.launch_count(n) == 0 for n in ops.KERNELS)
    else:
        assert bool(torch.isneginf(lse).any())
        assert float(got[0][torch.isneginf(lse)].abs().max()) == 0.0


@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[6] == 1
                                  and c[1] == c[2] and c[5] == 0])
def test_flash_attention_bwd_ref_matches_jax_grad(case):
    bh, sq, skv, hd, causal, window, group = case
    q, k, v, do = _bwd_inputs(bh, sq, skv, hd, group, seed=9)
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(
        a, b, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    lse = ref.flash_attention_lse_ref(tq, tk, causal=causal)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo,
                                      causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_flash_attention_lse_ref_matches_logsumexp():
    q, k, _, _ = _bwd_inputs(6, 25, 25, 16, 3, seed=4)
    got = ref.flash_attention_lse_ref(torch.from_numpy(q),
                                      torch.from_numpy(k), causal=True,
                                      group=3)
    kf = np.repeat(k, 3, axis=0)
    s = np.einsum("bid,bjd->bij", q, kf) / np.sqrt(16.0)
    s = np.where(np.tril(np.ones((25, 25), bool))[None], s, -np.inf)
    want = jax.nn.logsumexp(jnp.asarray(s), axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# what cannot train yet raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_training_a_recurrent_model_raises(arch):
    cfg = reduced(arch, dtype="float32", num_layers=2) if arch == "rwkv6-7b" \
        else reduced(arch, dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.init(model.generator(0))
    batch = _torch(_batch(cfg, b=1, s=16))
    with pytest.raises(NotImplementedError, match="item 13"):
        microbatch.value_and_grad(model.loss, params, batch)


def test_kernels_without_a_backward_refuse_grad():
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((1, 2, 16, 64), generator=g) for _ in range(3))
    logw = -torch.rand((1, 2, 16, 64), generator=g)
    u = torch.randn((2, 64), generator=g)
    a = torch.rand((1, 8, 32), generator=g)
    b = torch.randn((1, 8, 32), generator=g)
    h0 = torch.zeros((1, 32))
    gates = [torch.randn((32,), generator=g) for _ in range(4)]
    lam = torch.rand((32,), generator=g)
    calls = {
        "rwkv6_chunked": lambda x: ops.rwkv6_chunked(x, k, v, logw, u,
                                                     chunk=16),
        "rglru_scan": lambda x: ops.rglru_scan(x, b, h0),
        "rglru_gated_scan": lambda x: ops.rglru_gated_scan(
            x, *gates, lam, h0),
    }
    inputs = {"rwkv6_chunked": r, "rglru_scan": a, "rglru_gated_scan": b}
    for name, call in calls.items():
        x = inputs[name].clone().requires_grad_()
        with pytest.raises(NotImplementedError, match=name):
            call(x)
        with torch.no_grad():
            call(x)                       # serving: no gradient asked
        call(inputs[name])                # no input requires one
    q = torch.randn((2, 16, 16), generator=g, requires_grad=True)
    with pytest.raises(NotImplementedError, match="window"):
        ops.flash_attention(q, q.detach(), q.detach(), window=4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_train_runs_on_the_cpu(tmp_path):
    report = launch_train.main(["--arch", "musicgen-medium", "--reduced",
                                "--device", "cpu", "--steps", "3",
                                "--batch", "2", "--seq", "32",
                                "--ckpt-dir", str(tmp_path)])
    assert report.steps == 3 and len(report.losses) == 3
    assert all(np.isfinite(report.losses))
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]
    with pytest.raises(NotImplementedError, match="item 9"):
        launch_train.main(["--arch", "musicgen-medium", "--dry-run"])
