"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here is marked ``cuda`` and skips on a machine
without a CUDA device.  This file imports neither JAX nor the reference
package, so it also runs where JAX is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

# The kernel and its plain version add the same fp32 values in the same
# order without fused multiply-adds, so they should agree bit for bit;
# the tolerance is that of the reference comparison (different orders).
RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (sm_90a)")
    return torch.device("cuda")


def _inputs(b, n, d, t, seed, device):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((b, n, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, t)).astype(np.int32)
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(idx).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,t", [(3, 40, 96, 13), (4, 64, 4096, 512),
                                     (2, 17, 30, 21), (1, 8, 1028, 0)])
def test_kernel_matches_plain_version(cuda, b, n, d, t):
    x, i = _inputs(b, n, d, t, b + n + d + t, cuda)
    before = ops.launch_count()
    got = ops.subsample_stats(x, i)
    torch.cuda.synchronize()
    assert ops.launch_count() == before + 1
    want = ref.subsample_stats_ref(x, i)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    singles = torch.cat([ops.subsample_stats(x[k:k + 1], i[k:k + 1])
                         for k in range(b)])
    assert torch.equal(got, singles)


@pytest.mark.cuda
def test_kernel_rejects_cpu_indices_with_cuda_data(cuda):
    x, i = _inputs(1, 8, 16, 8, 0, cuda)
    with pytest.raises(ValueError):
        ops.subsample_stats(x, i.cpu())


# -- rwkv6_chunked -----------------------------------------------------------

# The kernel and its plain version (kernels.ref.rwkv6_chunk_form_ref) compute
# the same fp32 chunk form from the same inputs, but add the products in
# other orders and take the cumulative sum of the decays another way (the
# plain version's torch.cumsum is a parallel scan on the card): outputs of
# order 10 agree to a few ulps of the sums.
RW_TOL = 1e-4


def _rwkv_inputs(b, h, s, hd, dtype, logw_dtype, seed, device):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, hd)).astype(
        np.float32)).to(device, dtype) for _ in range(3))
    logw = torch.from_numpy((-0.05 - 2.45 * rng.random((b, h, s, hd))).astype(
        np.float32)).to(device, logw_dtype)
    u = torch.from_numpy((0.3 * rng.standard_normal((h, hd))).astype(
        np.float32)).to(device, dtype)
    state = torch.from_numpy((0.5 * rng.standard_normal((b, h, hd, hd))
                              ).astype(np.float32)).to(device)
    return r, k, v, logw, u, state


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,hd,chunk,dtype,logw_dtype", [
    (2, 4, 256, 64, 64, torch.bfloat16, torch.float32),   # the model's types
    (1, 3, 13, 64, 64, torch.bfloat16, torch.float32),    # one short chunk
    (2, 2, 96, 32, 32, torch.float32, torch.float32),     # hd = 32
    (1, 2, 40, 64, 8, torch.float32, torch.bfloat16),     # bf16 decays
    (3, 1, 21, 32, 7, torch.bfloat16, torch.bfloat16),    # odd chunk
])
def test_rwkv6_kernel_matches_plain_version(cuda, b, h, s, hd, chunk, dtype,
                                            logw_dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    r, k, v, logw, u, state = _rwkv_inputs(b, h, s, hd, dtype, logw_dtype,
                                           b * h + s, cuda)
    before = ops.launch_count("rwkv6_chunked")
    out, state_out = ops.rwkv6_chunked(r, k, v, logw, u, chunk=chunk,
                                       state=state)
    torch.cuda.synchronize()
    assert ops.launch_count("rwkv6_chunked") == before + 1
    want, want_state = ref.rwkv6_chunk_form_ref(r, k, v, logw, u, state,
                                                min(chunk, s))
    torch.testing.assert_close(out, want, rtol=RW_TOL, atol=RW_TOL)
    torch.testing.assert_close(state_out, want_state, rtol=RW_TOL,
                               atol=RW_TOL)


@pytest.mark.cuda
def test_rwkv6_kernel_from_zero_state_matches_sequential_recurrence(cuda):
    r, k, v, logw, u, _ = _rwkv_inputs(1, 2, 64, 64, torch.float32,
                                       torch.float32, 9, cuda)
    out, _ = ops.rwkv6_chunked(r, k, v, logw, u, chunk=16)
    # chunked closed form vs sequential scan: the reference's 2e-3
    torch.testing.assert_close(out, ref.rwkv6_chunked_ref(r, k, v, logw, u),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd16", "chunk128", "strided"])
def test_rwkv6_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    hd = 16 if bad == "hd16" else 64
    r, k, v, logw, u, _ = _rwkv_inputs(1, 2, 128, hd, torch.float32,
                                       torch.float32, 0, cuda)
    chunk = 128 if bad == "chunk128" else 64
    if bad == "strided":                   # same shape, not contiguous
        r = torch.cat([r, r], dim=-1)[..., :hd]
    before = ops.launch_count("rwkv6_chunked")
    with pytest.raises(ValueError):
        ops.rwkv6_chunked(r, k, v, logw, u, chunk=chunk)
    assert ops.launch_count("rwkv6_chunked") == before


# -- rglru_scan --------------------------------------------------------------


def _scan_inputs(b, s, w, seed, device):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.99, (b, s, w)).astype(np.float32)
    bb = (0.5 * rng.standard_normal((b, s, w))).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (a, bb, h0))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,w", [(4, 512, 2560), (2, 13, 100), (1, 1, 7),
                                   (3, 67, 64)])
def test_rglru_kernel_equals_plain_version(cuda, b, s, w):
    """Both round a·h, then add b, step by step: equal bit for bit."""
    a, bb, h0 = _scan_inputs(b, s, w, b + s + w, cuda)
    before = ops.launch_count("rglru_scan")
    out = ops.rglru_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert ops.launch_count("rglru_scan") == before + 1
    assert torch.equal(out, ref.linear_scan_ref(a, bb, h0))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["bf16", "strided"])
def test_rglru_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    a, bb, h0 = _scan_inputs(2, 16, 32, 0, cuda)
    if bad == "bf16":
        a = a.to(torch.bfloat16)
    else:
        a = torch.cat([a, a], dim=-1)[..., :32]
    before = ops.launch_count("rglru_scan")
    with pytest.raises((ValueError, TypeError)):
        ops.rglru_scan(a, bb, h0)
    assert ops.launch_count("rglru_scan") == before


# -- flash_attention ---------------------------------------------------------

# fp32 runs on the CUDA cores: the same fp32 scores and softmax as the plain
# version, products and the online softmax's rescaled partial sums added in
# other orders, so outputs of order 1 agree to ~1e-5.  bf16 runs on the
# tensor cores: products of bf16 values are exact in fp32, so the scores
# differ from the plain version's only in the order of summation, and P
# enters P V as a bf16 high and low part, which keeps each weight to about
# 2^-17; the fp32 output agrees to ~1e-5 again, and the bf16 output is one
# rounding of it, so the two may differ by one bf16 ulp (2^-8 relative).
FA_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _attn_inputs(bh, sq, skv, hd, group, dtype, seed, device):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bh // group, skv, hd)).astype(np.float32)
            for _ in range(2))
    return tuple(torch.from_numpy(x).to(device, dtype) for x in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("bh,sq,skv,hd,causal,window,group,dtype", [
    (20, 300, 300, 256, True, 128, 10, torch.bfloat16),  # the model's form
    (4, 256, 256, 64, True, 0, 1, torch.float32),        # the TPU function
    (4, 256, 256, 64, False, 0, 1, torch.bfloat16),      # not causal
    (6, 100, 100, 32, True, 16, 3, torch.float32),       # HD 32, ragged
    (2, 70, 150, 128, True, 0, 2, torch.float32),        # Sq < Skv
    (3, 1, 1, 256, True, 0, 1, torch.float32),           # one token
    # bf16, the tensor-core body: every HD, ragged lengths, both windows
    (4, 577, 1000, 32, False, 0, 2, torch.bfloat16),     # HD 32, Sq < Skv
    (4, 1000, 577, 64, True, 16, 1, torch.bfloat16),     # window < a tile
    (20, 1000, 1000, 128, True, 300, 10, torch.bfloat16),  # window > a tile
    (10, 577, 577, 256, False, 0, 10, torch.bfloat16),   # group 10, not causal
    (2, 70, 150, 256, True, 0, 2, torch.bfloat16),       # Sq < Skv, causal
    (4, 1000, 577, 64, True, 300, 1, torch.bfloat16),    # rows that see no key
    (3, 1, 1, 256, True, 0, 1, torch.bfloat16),          # one token
    (3, 1, 1000, 128, False, 0, 1, torch.bfloat16),      # Sq = 1, many keys
])
def test_flash_kernel_matches_plain_version(cuda, bh, sq, skv, hd, causal,
                                            window, group, dtype):
    q, k, v = _attn_inputs(bh, sq, skv, hd, group, dtype, bh + sq + hd, cuda)
    before = ops.launch_count("flash_attention")
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              group=group)
    torch.cuda.synchronize()
    assert ops.launch_count("flash_attention") == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   group=group)
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_kernel_bf16_with_large_score_gaps(cuda, hd):
    """q and k scaled by 8: scores spread over hundreds, so the running max
    moves by large steps from tile to tile and the online rescale runs on
    weights that underflow to 0 in between."""
    q, k, v = _attn_inputs(8, 700, 700, hd, 2, torch.float32, hd, cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q * 8, k * 8, v))
    out = ops.flash_attention(q, k, v, causal=True, window=0, group=2)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=0, group=2)
    assert torch.isfinite(out.float()).all()
    rtol, atol = FA_TOL[torch.bfloat16]
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_repeats_bit_for_bit(cuda, dtype):
    """No atomics, one CTA an output tile: two launches on the same inputs
    are equal."""
    q, k, v = _attn_inputs(20, 1000, 1000, 256, 10, dtype, 7, cuda)
    first = ops.flash_attention(q, k, v, causal=True, window=300, group=10)
    second = ops.flash_attention(q, k, v, causal=True, window=300, group=10)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["hd48", "strided", "group"])
def test_flash_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    hd = 48 if bad == "hd48" else 64
    q, k, v = _attn_inputs(4, 32, 32, hd, 1, torch.float32, 0, cuda)
    kwargs = {}
    if bad == "strided":
        q = torch.cat([q, q], dim=-1)[..., :hd]
    elif bad == "group":
        kwargs["group"] = 3
    before = ops.launch_count("flash_attention")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, **kwargs)
    assert ops.launch_count("flash_attention") == before


# -- subsample_gather --------------------------------------------------------


def _gather_inputs(n, d, t, dtype, seed, device):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, t).astype(np.int32)
    return (torch.from_numpy(data).to(device, dtype),
            torch.from_numpy(idx).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 1030, 65536])
@pytest.mark.parametrize("t", [1, 13, 512])
def test_gather_kernel_equals_plain_version(cuda, dtype, d, t):
    """Both add row after row into fp32, the square rounded first: equal
    bit for bit, with n_valid below, at and above T."""
    x, i = _gather_inputs(64, d, t, dtype, d + t, cuda)
    for n_valid in (t // 2, t, t + 5):
        nv = torch.full((1,), n_valid, dtype=torch.int32, device=cuda)
        before = ops.launch_count("subsample_gather")
        gathered, stats = ops._subsample_gather_padded(x, i, nv)
        torch.cuda.synchronize()
        assert ops.launch_count("subsample_gather") == before + 1
        want_g, want_s = ref.subsample_gather_ref(x, i, nv)
        assert gathered.dtype == dtype and stats.dtype == torch.float32
        assert torch.equal(gathered, x[i.long()])
        assert torch.equal(gathered, want_g)
        assert torch.equal(stats, want_s)


@pytest.mark.cuda
def test_gather_op_counts_one_launch_a_call(cuda):
    x, i = _gather_inputs(64, 4096, 512, torch.float32, 0, cuda)
    before = ops.launch_count("subsample_gather")
    for k in range(3):
        ops.subsample_gather(x, i)
        assert ops.launch_count("subsample_gather") == before + k + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["strided", "int64", "cpu_n_valid", "fp16"])
def test_gather_kernel_rejects_cuda_inputs_it_cannot_take(cuda, bad):
    x, i = _gather_inputs(16, 64, 8, torch.float32, 0, cuda)
    nv = torch.full((1,), 8, dtype=torch.int32, device=cuda)
    if bad == "strided":
        x = torch.cat([x, x], dim=-1)[:, :64]
    elif bad == "int64":
        i = i.long()
    elif bad == "cpu_n_valid":
        nv = nv.cpu()
    else:
        x = x.half()
    before = ops.launch_count("subsample_gather")
    with pytest.raises((ValueError, TypeError)):
        ops._subsample_gather_padded(x, i, nv)
    assert ops.launch_count("subsample_gather") == before
