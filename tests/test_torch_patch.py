"""The port's patch frontend (``llava-next-34b``) against the JAX
reference, on the CPU.

The model runs in its ``tests/conftest.py::reduced`` float32 config (two
layers of full attention, d_model 64, 4 patch embeddings of width 16
projected by ``frontend.proj`` and prepended to the tokens), with one set
of random numpy weights carried by ``models.convert.params_from_jax`` and
numpy patch embeddings and tokens given to both sides.  Tolerances as
``tests/test_torch_dense.py``: 1e-5 for the embedded inputs (one fp32
product), 1e-4 for logits, caches, the loss and every gradient leaf
(relative to its largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as ref_build_model
from repro.models import transformer as RT
from repro.parallel.sharding import is_param_def
from repro.serving import ServingEngine as RefEngine
from repro.serving.kvcache import grow_caches as ref_grow_caches
from repro_torch.config import ShapeConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServingEngine, grow_caches
from repro_torch.train import microbatch
from repro_torch.tree import tree_leaves_with_path
from tests.conftest import reduced

TOL = 1e-4
BATCH = 2
TEXT = 12
ARCH = "llava-next-34b"


def _numpy_params(ref_model, seed=0):
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


_PAIR = {}


def _pair():
    if not _PAIR:
        cfg = reduced(ARCH, dtype="float32")
        ref_model = ref_build_model(cfg)
        weights = _numpy_params(ref_model)
        _PAIR["v"] = (cfg, ref_model, weights,
                      jax.tree.map(jnp.asarray, weights),
                      Model(cfg, device="cpu"),
                      params_from_jax(weights, cfg, "cpu"))
    return _PAIR["v"]


def _inputs(cfg, s=TEXT, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, s),
                                   dtype=np.int32),
            "patch_embeds": rng.standard_normal(
                (BATCH, cfg.num_patches, cfg.frontend_dim)).astype(
                    np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def test_frontend_projection_is_defined_and_carried():
    cfg, _, weights, _, _, params = _pair()
    assert T.build_param_defs(cfg)["frontend"]["proj"].shape == (16, 64)
    np.testing.assert_array_equal(params["frontend"]["proj"].numpy(),
                                  weights["frontend"]["proj"])
    full = T.build_param_defs(get_config(ARCH))["frontend"]["proj"]
    assert (full.shape, full.logical) == ((1024, 7168), (None, "embed"))


@pytest.mark.parametrize("with_patches", [True, False])
def test_embed_inputs_matches_reference(with_patches):
    """The projected patches prepended to the tokens' embeddings; without
    ``patch_embeds`` the tokens alone, as the reference."""
    cfg, _, _, ref_params, _, params = _pair()
    batch = _inputs(cfg)
    if not with_patches:
        del batch["patch_embeds"]
    want = RT.embed_inputs(cfg, ref_params, _jax(batch), jnp.float32)
    got = T.embed_inputs(cfg, params, _torch(batch), torch.float32)
    assert got.shape[1] == TEXT + (cfg.num_patches if with_patches else 0)
    _close(got, want, 1e-5)


def test_prefill_logits_and_caches_match_reference():
    cfg, ref_model, _, ref_params, model, params = _pair()
    batch = _inputs(cfg)
    want_logits, want_caches = ref_model.prefill(ref_params, _jax(batch))
    logits, caches = model.prefill(params, _torch(batch))
    _close(logits, want_logits)
    want_leaves = jax.tree_util.tree_flatten_with_path(want_caches)[0]
    got_leaves = list(tree_leaves_with_path(caches))
    assert len(got_leaves) == len(want_leaves)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.shape[2] == cfg.num_patches + TEXT, path
        _close(g, w, what=str(path))


def test_decode_after_patches_matches_reference():
    """Two decode steps from position P + S (the patches count in the
    prompt's length), the reference's logits at each."""
    cfg, ref_model, _, ref_params, model, params = _pair()
    batch = _inputs(cfg)
    n = cfg.num_patches + TEXT
    _, rc = ref_model.prefill(ref_params, _jax(batch))
    rc = ref_model.prefill_to_decode(ref_grow_caches(rc, n + 2))
    _, caches = model.prefill(params, _torch(batch))
    caches = model.prefill_to_decode(grow_caches(caches, n + 2))
    nxt = np.random.default_rng(3).integers(0, cfg.vocab_size, (BATCH, 2),
                                            dtype=np.int32)
    for i in range(2):
        want, rc = ref_model.decode_step(ref_params,
                                         jnp.asarray(nxt[:, i:i + 1]), rc,
                                         jnp.asarray(n + i, jnp.int32))
        got, caches = model.decode_step(
            params, torch.from_numpy(nxt[:, i:i + 1]).long(), caches, n + i)
        _close(got, want, what=f"step {i}")


def test_generate_matches_reference_tokens():
    """The engine counts the patches in the prompt's length: greedy tokens
    equal the reference engine's (compared up to a row's first top-2 gap
    under 1e-3), and the port's first decode step writes past the prompt
    (a count without the patches would write over the last prompt slot
    and give other tokens)."""
    cfg, ref_model, _, ref_params, model, params = _pair()
    batch = _inputs(cfg, seed=4)
    n_new = 5
    gen = RefEngine(ref_model, ref_params, max_new_tokens=n_new).generate(
        _jax(batch), new_tokens=n_new).tokens
    out = ServingEngine(model, params, max_new_tokens=n_new).generate(
        _torch(batch))
    assert out.tokens.shape == (BATCH, n_new)
    # the reference's deciding logits: prefill, then decode its tokens
    n = cfg.num_patches + TEXT
    first, rc = ref_model.prefill(ref_params, _jax(batch))
    rc = ref_model.prefill_to_decode(ref_grow_caches(rc, n + n_new))
    deciding = [np.asarray(first)]
    for i in range(n_new - 1):
        lg, rc = ref_model.decode_step(ref_params,
                                       jnp.asarray(gen[:, i:i + 1]), rc,
                                       jnp.asarray(n + i, jnp.int32))
        deciding.append(np.asarray(lg))
    compared = 0
    for b in range(BATCH):
        for i in range(n_new):
            top2 = np.sort(deciding[i][b])[-2:]
            if top2[1] - top2[0] <= 1e-3:
                break
            assert out.tokens[b, i] == gen[b, i], (b, i)
            compared += 1
    assert compared >= n_new


def test_loss_and_gradients_match_reference():
    """``Model.loss`` reads the text's logits from positions P - 1 .. S - 2
    of the sequence with the patches prepended: loss and ``ce`` within
    1e-4, ``aux`` 0, every gradient leaf (``frontend.proj``'s included)
    within 1e-4 of its largest entry."""
    cfg, ref_model, weights, ref_params, model, params = _pair()
    batch = _inputs(cfg, seed=5)
    rng = np.random.default_rng(6)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (BATCH, TEXT),
                                   dtype=np.int32)
    batch["labels"][0, :2] = -1
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        ref_model.loss, has_aux=True))(ref_params, _jax(batch))
    (got, got_m), got_g = microbatch.value_and_grad(
        model.loss, params_from_jax(weights, cfg, "cpu"), _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]),
                               rtol=TOL)
    assert float(got_m["aux"]) == float(want_m["aux"]) == 0.0
    want_leaves = jax.tree_util.tree_flatten_with_path(want_g)[0]
    got_leaves = list(tree_leaves_with_path(got_g))
    assert len(got_leaves) == len(want_leaves)
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w, np.float64)
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= TOL, (path, err)
        assert float(torch.abs(g).max()) > 0.0, path
    assert float(torch.abs(got_g["frontend"]["proj"]).max()) > 0.0


def test_make_inputs_lays_out_patches_then_text():
    cfg, _, _, _, model, _ = _pair()
    batch = model.make_inputs(ShapeConfig("p", "prefill", 20, 3),
                              model.generator(0))
    assert tuple(batch["tokens"].shape) == (3, 20 - cfg.num_patches)
    assert tuple(batch["patch_embeds"].shape) == (3, cfg.num_patches,
                                                  cfg.frontend_dim)
    assert batch["patch_embeds"].dtype == torch.float32
    dec = model.make_inputs(ShapeConfig("d", "decode", 20, 3),
                            model.generator(0))
    assert tuple(dec["tokens"].shape) == (3, 1) and "patch_embeds" not in dec


def test_serve_launcher_runs_llava_on_cpu():
    ops.reset_launch_count()
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "17",
                      "--new-tokens", "3"])
    assert out.tokens.shape == (2, 3)
    assert all(ops.launch_count(n) == 0 for n in ops.KERNELS)


def test_train_launcher_runs_llava_on_cpu():
    """Zero patch embeddings before 32 text tokens: the run's shape is 36
    positions, the losses finite."""
    report = launch_train.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--steps", "2", "--batch", "2",
                                "--seq", "32"])
    assert report.steps == 2 and all(np.isfinite(report.losses))
