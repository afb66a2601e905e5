"""The port's attention against the reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
reference runs its Pallas kernel ``flash_attention`` in interpret mode
(its default off-TPU), its oracle ``ref.flash_attention_ref`` and its
model's jnp ``_attend_block``; the port runs the kernel's plain version
(the CUDA kernel itself is held against that version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances, all in float32:
- attention against the Pallas kernel and the oracle: 2e-5, the
  reference's own for its kernel (``tests/test_kernels.py``); the online
  and the plain softmax add in other orders;
- against ``_attend_block``, and the model's attention modules: 1e-4
  relative and absolute; both compute the same fp32 formulas, but their
  matmuls and einsums add in other orders on values up to about 10.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import layers as LJ
from repro.models import transformer as TJ
from repro.parallel.sharding import is_param_def
from repro_torch.config.base import LOCAL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from tests.conftest import reduced

KERNEL_TOL = 2e-5
MODULE_TOL = 1e-4


def _qkv_arrays(bh, sq, skv, hd, seed, group=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bh // group, skv, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,skv,hd", [(2, 64, 64, 32), (3, 32, 64, 16)])
@pytest.mark.parametrize("form", ["plain", "ops"])
def test_flash_attention_matches_reference_kernel_and_oracle(
        form, bh, sq, skv, hd, causal):
    arrays = _qkv_arrays(bh, sq, skv, hd, seed=bh + sq + skv + hd)
    jx = [jnp.asarray(x) for x in arrays]
    tx = [torch.from_numpy(x) for x in arrays]
    fn = ref.flash_attention_ref if form == "plain" else ops.flash_attention
    got = fn(*tx, causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (bh, sq, hd)
    kernel = ref_ops.flash_attention(*jx, causal=causal, block_q=16,
                                     block_k=16)
    oracle = ref_ref.flash_attention_ref(*jx, causal=causal)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=KERNEL_TOL, atol=KERNEL_TOL)


def _attend_block_reference(q, k, v, window, b, kv, g):
    """The reference model's ``_attend_block`` with its causal window mask,
    on the port's head-first layout: q [B·KV·G, S, HD], k, v [B·KV, S,
    HD]."""
    s, hd = q.shape[1], q.shape[2]
    qj = jnp.asarray(q.reshape(b, kv, g, s, hd).transpose(0, 3, 1, 2, 4))
    kj = jnp.asarray(k.reshape(b, kv, s, hd).transpose(0, 2, 1, 3))
    vj = jnp.asarray(v.reshape(b, kv, s, hd).transpose(0, 2, 1, 3))
    i = jnp.arange(s)[:, None]
    j = jnp.arange(s)[None, :]
    mask = j <= i
    if window:
        mask &= (i - j) < window
    out = LJ._attend_block(qj, kj, vj, mask, 1.0 / math.sqrt(hd))
    return np.asarray(out).transpose(0, 2, 3, 1, 4).reshape(b * kv * g, s, hd)


@pytest.mark.parametrize("window", [0, 16, 5])
@pytest.mark.parametrize("s", [13, 24, 40])
@pytest.mark.parametrize("kv,g", [(1, 4), (2, 2), (3, 1)])
def test_window_and_group_match_reference_attend_block(kv, g, s, window):
    b = 2
    q, k, v = _qkv_arrays(b * kv * g, s, s, 16, seed=s + window + kv, group=g)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, window=window, group=g)
    want = _attend_block_reference(q, k, v, window, b, kv, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=MODULE_TOL,
                               atol=MODULE_TOL)


def test_a_row_that_sees_no_key_gives_zeros():
    """Only when Sq > Skv + window − 1: rows 9 and up see no key."""
    q, k, v = (torch.from_numpy(x) for x in _qkv_arrays(1, 12, 6, 16, 0))
    out = ref.flash_attention_ref(q, k, v, causal=True, window=4)
    assert float(out[:, 9:].abs().max()) == 0.0
    assert float(out[:, :9].abs().min(dim=-1).values.min()) > 0.0


@pytest.mark.parametrize("bad", ["group", "hd", "dtype", "strided", "window",
                                 "kv_heads"])
def test_flash_wrapper_rejects_inputs_it_cannot_take(bad):
    q, k, v = (torch.from_numpy(x) for x in _qkv_arrays(4, 8, 8, 16, 0))
    kwargs = {}
    if bad == "group":
        kwargs["group"] = 3                  # does not divide BH = 4
    elif bad == "hd":
        k, v = k[..., :8].contiguous(), v[..., :8].contiguous()
    elif bad == "dtype":
        v = v.to(torch.bfloat16)
    elif bad == "strided":
        q = torch.cat([q, q], dim=-1)[..., :16]
    elif bad == "window":
        kwargs["window"] = -1
    else:
        kwargs["group"] = 2                  # needs 2 KV heads, k has 4
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v, **kwargs)


def test_cpu_attention_counts_no_launch():
    ops.reset_launch_count()
    ops.flash_attention(*(torch.from_numpy(x)
                          for x in _qkv_arrays(2, 8, 8, 16, 1)))
    assert all(ops.launch_count(name) == 0 for name in ops.KERNELS)


# -- the model's attention modules -------------------------------------------


def _cfg(**kw):
    return reduced("recurrentgemma-2b", dtype="float32", **kw)


def _numpy_tree(defs, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        if p.init == "ones":
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:
            a = rng.standard_normal(p.shape) / np.sqrt(p.shape[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, defs, is_leaf=is_param_def)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(torch.from_numpy, tree))


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=MODULE_TOL, atol=MODULE_TOL, err_msg=msg)


@pytest.mark.parametrize("ndim", [1, 2])
def test_apply_rope_matches_reference(ndim):
    rng = np.random.default_rng(ndim)
    x = rng.standard_normal((2, 11, 3, 2, 16)).astype(np.float32)
    pos = np.arange(11) + 5
    if ndim == 2:
        pos = np.stack([pos, pos * 3])
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    want = LJ.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("s", [13, 24, 40])
def test_attention_apply_matches_reference(s, window):
    cfg = _cfg()
    jp, tp = _both(_numpy_tree(LJ.attention_defs(cfg), seed=s))
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want_out, want_kv = LJ.attention_apply(cfg, jp, jnp.asarray(x),
                                           jnp.arange(s), window=window)
    out, kv = L.attention_apply(cfg, tp, torch.from_numpy(x),
                                torch.arange(s), window=window)
    _close(out, want_out)
    for n in ("k", "v"):
        _close(kv[n], want_kv[n], n)


@pytest.mark.parametrize("s", [13, 24, 40])
def test_local_layer_prefill_and_rolled_cache_match_reference(s):
    """The whole LOCAL layer (norms, attention, MLP) in prefill, and its
    cache: the full-sequence K/V when S <= window, else the last window of
    positions rolled into the circular buffer at ``pos % window``."""
    cfg = _cfg()
    jp, tp = _both(_numpy_tree(TJ.layer_defs(cfg, 2), seed=s + 1))
    x = np.random.default_rng(s + 1).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    want_x, want_cache, _ = TJ.layer_apply(
        cfg, LOCAL, "dense", jp, jnp.asarray(x), positions=jnp.arange(s),
        cache=None, mode="prefill", pos=None)
    got_x, got_cache = T.layer_apply(
        cfg, LOCAL, tp, torch.from_numpy(x), positions=torch.arange(s),
        cache=None, mode="prefill", pos=None)
    _close(got_x, want_x)
    assert got_cache["k"].shape[1] == min(s, cfg.local_window)
    for n in ("k", "v"):
        _close(got_cache[n], want_cache[n], n)


@pytest.mark.parametrize("pos,window,s_max", [
    (7, 16, 12),       # the buffer has not wrapped: slots past pos masked
    (16, 16, 16),      # the first write that wraps
    (37, 16, 16),      # wrapped twice
    (9, 0, 20),        # a full (unwindowed) cache
])
def test_attention_decode_matches_reference(pos, window, s_max):
    cfg = _cfg()
    jp, tp = _both(_numpy_tree(LJ.attention_defs(cfg), seed=pos))
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    cache = {n: rng.standard_normal(
        (2, s_max, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
        for n in ("k", "v")}
    jc, tc = _both(cache)
    want_out, want_cache = LJ.attention_decode(
        cfg, jp, jnp.asarray(x), jc, jnp.asarray(pos, jnp.int32),
        window=window)
    out, new_cache = L.attention_decode(cfg, tp, torch.from_numpy(x), tc,
                                        pos, window=window)
    _close(out, want_out)
    for n in ("k", "v"):
        _close(new_cache[n], want_cache[n], n)
    np.testing.assert_array_equal(tc["k"].numpy(), cache["k"])  # not in place


def test_attention_decode_refuses_a_write_past_the_cache():
    """Where the reference clamps the write onto the last slot (ROADMAP
    Queue 3), the port raises."""
    cfg = _cfg()
    _, tp = _both(_numpy_tree(LJ.attention_defs(cfg), seed=0))
    cache = {n: torch.zeros((1, 8, cfg.num_kv_heads, cfg.head_dim))
             for n in ("k", "v")}
    with pytest.raises(ValueError, match="grow"):
        L.attention_decode(cfg, tp, torch.zeros((1, 1, cfg.d_model)), cache,
                           8, window=16)


def test_mlp_matches_reference():
    jp, tp = _both(_numpy_tree(LJ.mlp_defs(64, 128), seed=3))
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(
        np.float32)
    _close(L.mlp_apply(tp, torch.from_numpy(x)),
           LJ.mlp_apply(jp, jnp.asarray(x)))

