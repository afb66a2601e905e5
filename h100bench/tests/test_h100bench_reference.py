"""Each plain reference against the port's CPU path at a tiny size, in
float32, where the two compute the same function and agree to rounding."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h100bench import core, weights
from repro_torch.models.model import Model
from repro_torch.train.microbatch import value_and_grad

from _tiny import HERE, TINY_CONFIGS


def _ref(name):
    return core.load_module(HERE / "reference" / f"{name}.py")


def _model(cfg, seed=3):
    model = Model(core.model_config(cfg), device="cpu")
    specs = weights.leaf_specs(model.param_defs(), torch.float32)
    leaves = weights.make(specs, seed, "cpu")
    return model, leaves, weights.build_tree(model.param_defs(), leaves)


def test_rwkv6_loss_and_gradients_are_the_ports():
    cfg = dict(TINY_CONFIGS["rwkv6-tiny"], dtype="float32")
    model, leaves, params = _model(cfg)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg["vocab_size"], (2, 41), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, _), grads = value_and_grad(model.loss, params, batch)
    ref = _ref("rwkv6")
    mine = {n: t.clone().requires_grad_() for n, t in leaves.items()}
    want = ref.loss(mine, batch["tokens"], batch["labels"], cfg,
                    ref.P.Products("fp32"))
    want.backward()
    assert abs(float(loss) - float(want.detach())) < 1e-5 * float(want.detach())
    for path, g in weights.flatten(grads).items():
        r = mine[path].grad
        assert float((g - r).norm()) <= 1e-4 * float(r.norm()) + 1e-9, path


def test_rwkv6_chunks_agree_with_the_step_by_step_recurrence():
    ref = _ref("rwkv6")
    gen = torch.Generator().manual_seed(1)
    b, s, h, d = 2, 37, 3, 8
    r, k, v = (torch.randn(b, s, h, d, generator=gen) for _ in range(3))
    logw = -torch.exp(torch.randn(b, s, h, d, generator=gen))
    u = torch.randn(h, d, generator=gen)
    state = torch.zeros(b, h, d, d)
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = torch.exp(logw[:, t])[..., None] * state + kv
    want = torch.stack(outs, dim=1)
    for chunk in (1, 4, 16, 64):
        got = ref.wkv(r, k, v, logw, u, chunk=chunk)
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5), chunk


def test_llama_served_logits_are_the_ports_prefill_and_decode():
    """Prefill, then decode through the int8 cache feeding the served
    tokens: the port's logits at every position equal the reference's."""
    cfg = dict(TINY_CONFIGS["llama-tiny"], dtype="float32")
    model, leaves, params = _model(cfg)
    gen = torch.Generator().manual_seed(2)
    b, p, n = 2, 11, 5
    prompts = torch.randint(0, cfg["vocab_size"], (b, p), generator=gen)
    served = torch.randint(0, cfg["vocab_size"], (b, n), generator=gen)
    from repro_torch.serving.kvcache import grow_caches
    with torch.inference_mode():
        logits, caches = model.prefill(params, {"tokens": prompts})
        caches = model.prefill_to_decode(grow_caches(caches, p + n))
        got = [logits]
        for i in range(n - 1):
            logits, caches = model.decode_step(params, served[:, i:i + 1],
                                               caches, p + i)
            got.append(logits)
    got = torch.stack(got, dim=1)
    ref = _ref("llama")
    want = ref.served_logits(cfg, leaves, prompts, served)
    assert got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    gaps = ref.widest_gaps(want, want.argmax(dim=-1))
    assert float(gaps.max()) == 0.0


def test_the_int8_cache_is_what_the_reference_reads():
    """Without the int8 cache the decode positions' logits move: the
    reference's rounding of the cache is not a no-op at this size."""
    cfg = dict(TINY_CONFIGS["llama-tiny"], dtype="float32")
    _, leaves, _ = _model(cfg)
    ref = _ref("llama")
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg["vocab_size"], (2, 9), generator=gen)
    served = torch.randint(0, cfg["vocab_size"], (2, 4), generator=gen)
    a = ref.served_logits(cfg, leaves, prompts, served)
    bf = ref.served_logits(dict(cfg, kv_cache_dtype="bfloat16"), leaves,
                           prompts, served)
    assert torch.equal(a[:, 0], bf[:, 0])
    assert not torch.equal(a[:, 1:], bf[:, 1:])
    assert np.isfinite(a.numpy()).all()
