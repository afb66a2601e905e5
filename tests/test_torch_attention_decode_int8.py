"""Decode attention over the int8 KV cache on the CPU: the plain version
(``kernels.ref.attention_decode_int8_ref``, which ``ops`` runs for CPU and
``meta`` tensors) against the torch ops that ``layers.attention_decode``
ran for an int8 cache before they moved there, bit for bit; the wrapper's
checks; the kernel's split plan; the kernel source's names; and the
output's budget against the plain version (``tests/_decode_tol.py``),
which the kernel's arithmetic emulated in torch ops keeps and emulated
wrong kernels (bf16 scores, fp8 probabilities) exceed.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).
"""

import math
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import attention_decode_int8 as ad
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from tests.conftest import reduced
from tests.test_torch_dense import INT8_DECODE_CASES
import _decode_tol  # tests/_decode_tol.py, beside this file

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "attention_decode_int8.cu")


def _int8_branch_before(cfg, params, x, cache, pos, window):
    """``layers.attention_decode`` for an int8 cache as it read before its
    torch ops moved into ``kernels.ref``, kept here unchanged."""
    b = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = L._qkv(cfg, params, x)
    where = torch.tensor([pos], device=x.device)
    q = L.apply_rope(q, where, cfg.rope_theta)
    k = L.apply_rope(k, where, cfg.rope_theta)

    def quantize_kv(t):
        xf = t.float()
        absmax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
        sc = absmax / absmax.new_full((), 127.0)
        return torch.clamp(torch.round(xf / sc), -127, 127).to(
            torch.int8), sc

    def dequantize_kv(qv, sc, dtype):
        return (qv.float() * sc).to(dtype)

    s_max = cache["k"].shape[1]
    write_at = pos % window if window else pos
    new_cache = {n: t.clone() for n, t in cache.items()}
    for n, t in (("k", k), ("v", v)):
        vals, absmax = quantize_kv(t)
        new_cache[n][:, write_at] = vals[:, 0]
        new_cache[n + "_scale"][:, write_at] = absmax[:, 0]
    ck = dequantize_kv(new_cache["k"], new_cache["k_scale"], k.dtype)
    cv = dequantize_kv(new_cache["v"], new_cache["v_scale"], v.dtype)
    scores = torch.einsum("bikgd,bjkd->bkgj", q.float(), ck.float()) * scale
    slot = torch.arange(s_max, device=x.device)
    if window:
        valid = (slot <= write_at) | (pos >= window)
    else:
        valid = slot <= pos
    scores = torch.where(valid[None, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", probs.to(cv.dtype), cv)
    out = out.reshape(b, 1, cfg.q_dim) @ params["wo"]
    return out, new_cache


def _case(pos, window, s_max, kv_heads, dtype, seed=0):
    kw = {} if kv_heads is None else {"num_kv_heads": kv_heads}
    cfg = reduced("deepseek-7b", dtype=dtype, **kw)
    gen = torch.Generator().manual_seed(seed + pos)
    params = {n: (torch.randn(p.shape, generator=gen)
                  / math.sqrt(p.shape[0])).to(getattr(torch, dtype))
              for n, p in L.attention_defs(cfg).items()}
    x = torch.randn((2, 1, cfg.d_model), generator=gen).to(params["wq"].dtype)
    shape = (2, s_max, cfg.num_kv_heads, cfg.head_dim)
    cache = {}
    for n in ("k", "v"):
        cache[n], cache[n + "_scale"] = L.quantize_kv(
            torch.randn(shape, generator=gen) * 3.0)
    return cfg, params, x, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,window,s_max,kv_heads", INT8_DECODE_CASES)
def test_plain_version_equals_the_int8_branch_before_the_move(
        pos, window, s_max, kv_heads, dtype):
    cfg, params, x, cache = _case(pos, window, s_max, kv_heads, dtype)
    old = {n: t.clone() for n, t in cache.items()}
    want_out, want_cache = _int8_branch_before(cfg, params, x, cache, pos,
                                               window)
    before = ops.launch_count("attention_decode_int8")
    out, new_cache = L.attention_decode(cfg, params, x, cache, pos,
                                        window=window)
    assert ops.launch_count("attention_decode_int8") == before
    assert out.dtype == want_out.dtype and torch.equal(out, want_out)
    assert sorted(new_cache) == sorted(want_cache)
    for n in want_cache:
        assert new_cache[n].dtype == want_cache[n].dtype
        assert torch.equal(new_cache[n], want_cache[n]), n
        assert torch.equal(cache[n], old[n]), f"{n} written in place"
        assert new_cache[n].data_ptr() != cache[n].data_ptr()


def _wrapper_inputs(b=2, s_max=20, kv=2, g=3, hd=16):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((b, 1, kv, g, hd), generator=gen)
    k = torch.randn((b, 1, kv, hd), generator=gen)
    v = torch.randn((b, 1, kv, hd), generator=gen)
    cache = {}
    for n in ("k", "v"):
        cache[n], cache[n + "_scale"] = L.quantize_kv(
            torch.randn((b, s_max, kv, hd), generator=gen))
    return q, k, v, cache


def test_wrapper_runs_the_plain_version_on_cpu_and_meta():
    q, k, v, cache = _wrapper_inputs()
    out, new_cache = ops.attention_decode_int8(q, k, v, cache, 7)
    assert out.shape == (2, 2, 3, 16) and out.dtype == q.dtype
    assert torch.equal(new_cache["k"][:, 8:], cache["k"][:, 8:])
    meta = [t.to("meta") for t in (q, k, v)]
    out, new_cache = ops.attention_decode_int8(
        *meta, {n: t.to("meta") for n, t in cache.items()}, 25, window=16)
    assert out.device.type == "meta" and out.shape == (2, 2, 3, 16)
    assert {n: tuple(t.shape) for n, t in new_cache.items()} == {
        n: tuple(t.shape) for n, t in cache.items()}


def _int8_to_float(cache):
    cache["k"] = cache["k"].float()


def _scale_wrong_shape(cache):
    cache["k_scale"] = cache["k_scale"][..., 0]


def _scale_not_fp32(cache):
    cache["v_scale"] = cache["v_scale"].double()


def _not_contiguous(cache):
    cache["v"] = cache["v"].transpose(0, 1).contiguous().transpose(0, 1)


@pytest.mark.parametrize("spoil,pos,window,error", [
    (_int8_to_float, 7, 0, TypeError),       # a cache that is not int8
    (_scale_wrong_shape, 7, 0, ValueError),  # scales [B, S, KV], no last 1
    (_scale_not_fp32, 7, 0, ValueError),     # fp64 scales
    (None, 20, 0, ValueError),               # write_at == S_max
    (None, 45, 24, ValueError),              # a window wider than the cache
    (_not_contiguous, 7, 0, ValueError),     # a strided view of the cache
])
def test_wrapper_checks_refuse(spoil, pos, window, error):
    q, k, v, cache = _wrapper_inputs()
    ops._check_attention_decode_int8(q, k, v, cache, 7, 0)
    if spoil is not None:
        spoil(cache)
    with pytest.raises(error):
        ops._check_attention_decode_int8(q, k, v, cache, pos, window)


def test_split_plan():
    """256 slots a CTA at deepseek-7b's decode (8 x 32 (batch row, KV
    head) pairs, 4,065 slots filled: 16 splits); halved while a launch
    would leave SMs with fewer than two CTAs."""
    assert ad.plan_chunk(8 * 32, 4065, 132) == 256
    assert ad.plan_chunk(1, 4096, 132) == 32
    assert ad.plan_chunk(16, 4096, 132) == 128
    assert ad.plan_chunk(64, 1, 132) == 32
    assert [ad.group_chunk(g) for g in (1, 2, 3, 4, 5, 8, 10)] == [
        1, 2, 4, 4, 8, 8, 8]


def test_no_kernel_is_named_flash_attention():
    """h100bench/metrics/flash_attention_roofline.py counts every kernel of
    the profiled call whose name holds ``flash_attention`` as prefill's
    attention; a decode kernel named so would add its launches there."""
    text = SOURCE.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)\s*\(", text)
    assert names == ["attention_decode_int8_kernel"]
    assert not any("flash_attention" in n for n in names)


@pytest.mark.parametrize("hd,dtype,error", [
    (64, torch.bfloat16, ValueError), (256, torch.bfloat16, ValueError),
    (128, torch.float32, TypeError), (128, torch.float16, TypeError)])
def test_kernel_is_built_for_hd128_bf16_alone(hd, dtype, error):
    """The CUDA kernel has instances for HD 128 in bf16 only (deepseek-7b,
    the one model with an int8 cache); the wrapper raises for the rest on
    the card, as ``ops._check_attention_decode_int8`` calls this check
    for CUDA tensors."""
    ad.check_supported(torch.zeros((2, 1, 4, 1, 128), dtype=torch.bfloat16))
    with pytest.raises(error):
        ad.check_supported(torch.zeros((2, 1, 4, 1, hd), dtype=dtype))


def _wide_inputs(b, s_max, kv, g, seed):
    """bf16 inputs drawn as the card's checks draw them: cache rows of
    randn times exp(randn), so their magnitudes span about e^4."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    q = rnd(b, 1, kv, g, 128).bfloat16()
    k = (2.0 * rnd(b, 1, kv, 128)).bfloat16()
    v = (2.0 * rnd(b, 1, kv, 128)).bfloat16()
    cache = {}
    for n in ("k", "v"):
        rows = rnd(b, s_max, kv, 128) * torch.exp(rnd(b, s_max, kv, 1))
        cache[n], cache[n + "_scale"] = L.quantize_kv(rows.bfloat16())
    return q, k, v, cache


@pytest.mark.parametrize("b,s_max,kv,g,pos,window", [
    (4, 1024, 8, 1, 1000, 0),
    (2, 300, 4, 1, 299, 0),
    (3, 16, 2, 4, 37, 16),    # a wrapped window
    (2, 700, 4, 2, 650, 0),
    (1, 600, 1, 10, 555, 0),
])
@pytest.mark.parametrize("wrong", [
    None,                                       # the kernel's arithmetic
    {"scores_dtype": torch.bfloat16},
    {"probs_dtype": torch.float8_e4m3fn},
], ids=["fp32", "bf16_scores", "fp8_probs"])
def test_output_budget_takes_the_kernel_and_refuses_wrong_ones(
        b, s_max, kv, g, pos, window, wrong):
    """Each output's budget, 2^-8 sum_j p_j |v_j| + 2^-7 |want|, holds the
    kernel's arithmetic (fp32 probabilities, one bf16 rounding) against the
    plain version with room, and refuses the same arithmetic with the
    scores rounded to bf16 or the probabilities to fp8, which the former
    rule (2^-8 of the largest |v| in the cache) let through."""
    q, k, v, cache = _wide_inputs(b, s_max, kv, g, s_max + pos)
    want, new_cache = ref.attention_decode_int8_ref(q, k, v, cache, pos,
                                                    window=window)
    bound = _decode_tol.budget(q, new_cache, pos, window, want)
    got = _decode_tol.emulate(q, new_cache, pos, window, **(wrong or {}))
    used = _decode_tol.share(got, want, bound)
    if wrong is None:
        assert used < 0.8
    else:
        assert used > 1.4
