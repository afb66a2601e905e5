"""Shared layer primitives (the reference's ``repro.models.layers``): RMS
norm, RoPE, causal and sliding-window attention with its decode cache, the
gated MLP, embedding and the LM head.

Parameters are nested dicts of tensors made from ``ParamDef`` trees
(``repro_torch.parallel.sharding``).  Activations keep the reference's
layouts:

  tokens      [B, S]              int
  hidden      [B, S, D]           the model's dtype
  q           [B, S, KV, G, HD]   (GQA grouping explicit)
  k, v        [B, S, KV, HD]
  KV cache    [B, S_max, KV, HD]  (a rolling buffer of the window for LOCAL)

Prefill attention, full (``ATTN``) or sliding-window (``LOCAL``), runs
through ``kernels.ops.flash_attention``: the hand-written CUDA kernel on
the card, its plain version on the CPU.  The kernel keeps the softmax
probabilities in fp32 where the reference's ``_attend_block`` rounds them
to v's type before the product with v.  With ``kv_cache_dtype="int8"``
the cache holds int8 values and one fp32 absmax scale per (batch,
position, KV head), ``k_scale``, ``v_scale [B, S_max, KV, 1]``, quantized
with the reference's arithmetic, and decode attention over it runs
through ``kernels.ops.attention_decode_int8``: the hand-written CUDA kernel
on the card (the new token quantized and written, the int8 values and
scales read in place), its plain version (the reference's torch ops) on
the CPU.  Decode over an unquantized cache is torch ops, as in the
reference.  :func:`cross_entropy` is training's mean next-token loss.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (
    BATCH, EMBED, HEADS, KV_SEQ, REPL, VOCAB, ParamDef,
)
from repro_torch.spans import span


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm_defs(d: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((d,), (REPL,), init="ones")}


def rms_norm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis, in fp32 inside, cast back to x's type."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # [HD/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, ..., HD]; positions [S] or [B, S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # [HD/2]
    if positions.dim() == 1:
        positions = positions[None, :]                     # [1, S]
    angles = positions[..., None].float() * freqs          # [B?,S,HD/2]
    for _ in range(x.dim() - 3):                           # head dims
        angles = angles[:, :, None]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (causal / sliding-window prefill, decode against a cache)
# ---------------------------------------------------------------------------


def attention_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    defs = {
        "wq": ParamDef((d, qd), (EMBED, HEADS)),
        "wk": ParamDef((d, kvd), (EMBED, HEADS)),
        "wv": ParamDef((d, kvd), (EMBED, HEADS)),
        "wo": ParamDef((qd, d), (HEADS, EMBED)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((qd,), (HEADS,), init="zeros")
        defs["bk"] = ParamDef((kvd,), (HEADS,), init="zeros")
        defs["bv"] = ParamDef((kvd,), (HEADS,), init="zeros")
    return defs


def _qkv(cfg: ModelConfig, params, x: torch.Tensor):
    b, s, _ = x.shape
    kv, g, hd = (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                 cfg.head_dim)
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return (q.reshape(b, s, kv, g, hd), k.reshape(b, s, kv, hd),
            v.reshape(b, s, kv, hd))


def attention_apply(
    cfg: ModelConfig, params, x: torch.Tensor, positions: torch.Tensor, *,
    window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal (optionally windowed) self-attention for prefill, through the
    ``flash_attention`` kernel.  Returns (output [B,S,D], cache {k, v}):
    the full-sequence K/V, which *is* the prefill KV cache."""
    b, s, _ = x.shape
    kv, g, hd = (cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                 cfg.head_dim)
    q, k, v = _qkv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    # heads first: q [B·KV·G, S, HD] reads k, v [B·KV, S, HD] in groups of
    # G (at B = 1 the reshapes can be strided views: the kernel takes
    # contiguous tensors)
    qh = q.permute(0, 2, 3, 1, 4).reshape(b * kv * g, s, hd).contiguous()
    kh = k.permute(0, 2, 1, 3).reshape(b * kv, s, hd).contiguous()
    vh = v.permute(0, 2, 1, 3).reshape(b * kv, s, hd).contiguous()
    out = ops.flash_attention(qh, kh, vh, causal=True, window=window,
                              group=g)
    out = out.reshape(b, kv, g, s, hd).permute(0, 3, 1, 2, 4)
    out = out.reshape(b, s, cfg.q_dim) @ params["wo"]
    return out, {"k": k, "v": v}


def attention_decode(
    cfg: ModelConfig, params, x: torch.Tensor,
    cache: Dict[str, torch.Tensor], pos: int, *, window: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode.  x [B,1,D]; cache k/v [B,S_max,KV,HD] (int8
    with ``k_scale``/``v_scale`` where the cache is quantized); ``pos``
    the current length.  For windowed layers the cache is a rolling buffer
    written at ``pos % window``; slots past the write are masked until the
    buffer has wrapped.  The cache is not written in place: the new one is
    returned, as the reference's is.  A cache that holds ``k_scale`` goes
    through ``ops.attention_decode_int8``: one hand-written kernel on the
    card, its plain version (``kernels.ref.attention_decode_int8_ref``) on
    the CPU; any other cache through the torch ops below."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"attention_decode takes one token, got {s}")
    q, k, v = _qkv(cfg, params, x)
    where = torch.tensor([pos], device=x.device)
    q = apply_rope(q, where, cfg.rope_theta)
    k = apply_rope(k, where, cfg.rope_theta)

    s_max = cache["k"].shape[1]
    write_at = pos % window if window else pos
    if write_at >= s_max:
        raise ValueError(f"decode writes slot {write_at} of a {s_max}-slot "
                         "cache: grow it first (serving.grow_caches)")
    if "k_scale" in cache:
        with span("attention.cache"):
            out, new_cache = ops.attention_decode_int8(q, k, v, cache, pos,
                                                       window=window)
        return out.reshape(b, 1, cfg.q_dim) @ params["wo"], new_cache
    with span("attention.cache"):
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, write_at] = k[:, 0].to(ck.dtype)
        cv[:, write_at] = v[:, 0].to(cv.dtype)
        new_cache = {"k": ck, "v": cv}

    scale = 1.0 / math.sqrt(cfg.head_dim)
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


def attention_cache_defs(cfg: ModelConfig, batch: int, seq: int,
                         dtype=None) -> Dict[str, ParamDef]:
    shape = (batch, seq, cfg.num_kv_heads, cfg.head_dim)
    logical = (BATCH, KV_SEQ, None, None)
    if cfg.kv_cache_dtype == "int8":
        sshape = (batch, seq, cfg.num_kv_heads, 1)
        return {
            "k": ParamDef(shape, logical, dtype=torch.int8, init="zeros"),
            "v": ParamDef(shape, logical, dtype=torch.int8, init="zeros"),
            "k_scale": ParamDef(sshape, logical, dtype=torch.float32,
                                init="zeros"),
            "v_scale": ParamDef(sshape, logical, dtype=torch.float32,
                                init="zeros"),
        }
    return {"k": ParamDef(shape, logical, dtype=dtype, init="zeros"),
            "v": ParamDef(shape, logical, dtype=dtype, init="zeros")}


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,S,KV,HD] → (int8 values, fp32 absmax scale [B,S,KV,1]): the
    reference's arithmetic, rounding half to even."""
    xf = x.float()
    absmax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    # divided by a tensor on x's device: PyTorch's CUDA division by a
    # Python number multiplies by its fp32 reciprocal, which can part from
    # the reference's division by one ulp
    scale = absmax / absmax.new_full((), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def maybe_quantize_cache(cfg: ModelConfig, kv: Dict[str, torch.Tensor]):
    """A prefill's k/v cache as the model keeps it: int8 values and scales
    where ``kv_cache_dtype`` is ``"int8"``, else as given."""
    if cfg.kv_cache_dtype != "int8":
        return kv
    k, ks = quantize_kv(kv["k"])
    v, vs = quantize_kv(kv["v"])
    return {"k": k, "v": v, "k_scale": ks, "v_scale": vs}


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_defs(d: int, ff: int) -> Dict[str, ParamDef]:
    return {
        "wi": ParamDef((d, ff), (EMBED, HEADS)),
        "wg": ParamDef((d, ff), (EMBED, HEADS)),
        "wd": ParamDef((ff, d), (HEADS, EMBED)),
    }


def mlp_apply(params, x: torch.Tensor) -> torch.Tensor:
    h = (x @ params["wi"]) * F.silu(x @ params["wg"])
    return h @ params["wd"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    if cfg.opt_local_vocab and not cfg.tie_embeddings:
        return {
            "embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                                  (REPL, HEADS)),
            "head": ParamDef((cfg.d_model, cfg.vocab_size),
                             (REPL, VOCAB)),
        }
    defs = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                                  (VOCAB, EMBED))}
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                (EMBED, VOCAB))
    return defs


def embed_apply(cfg: ModelConfig, params, tokens: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    # F.embedding, not indexing: its backward sums each row's gradient in a
    # fixed order on the card, where indexing's (index_put_ with
    # accumulate) may not
    return F.embedding(tokens, params["embedding"]).to(dtype)


def head_apply(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """hidden ``[B, S, D]`` → logits ``[B, S, V]`` fp32.  The product runs
    in fp32, as the reference's ``preferred_element_type=float32`` keeps
    its logits unrounded; the soft cap applies where set."""
    if cfg.tie_embeddings:
        logits = x.float() @ params["embedding"].float().t()
    else:
        logits = x.float() @ params["head"].float()
    if cfg.logit_soft_cap:
        c = cfg.logit_soft_cap
        logits = c * torch.tanh(logits / c)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  onehot: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy: ``logits [B, S, V]`` fp32, ``labels
    [B, S]`` int, ``mask [B, S]`` fp32 weights (the mean runs over
    ``max(Σ mask, 1)``).  ``onehot=True`` takes the gold logit by a masked
    reduction over the vocabulary, as the reference does for its sharded
    vocabulary; else by a gather (``take_along_axis``)."""
    lse = torch.logsumexp(logits, dim=-1)
    if onehot:
        hit = (torch.arange(logits.shape[-1], device=logits.device)
               == labels[..., None])
        gold = torch.sum(torch.where(hit, logits, torch.zeros_like(logits)),
                         dim=-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
