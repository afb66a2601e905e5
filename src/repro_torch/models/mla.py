"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1) with
YaRN-scaled rotary positions, over a latent KV cache.

A token's keys and values are kept as one latent: ``c = rms_norm(x ·
W_kva[:, :r])`` of width ``r = kv_lora_rank`` and one roped key ``k_pe =
rope(x · W_kva[:, r:])`` of width ``qk_rope_head_dim`` that every head
shares.  Head ``h`` reads

  k_h = [c · W_UK_h, k_pe]   (qk_nope_head_dim + qk_rope_head_dim)
  v_h = c · W_UV_h            (v_head_dim)

with ``W_kvb = [W_UK_h, W_UV_h]`` over the heads, and its query ``q_h = [x
· W_q, rope(x · W_q)]`` split the same way (q at full rank: the source's
``q_lora_rank`` is null).  The cache (``c_kv [B, S, r]``, ``k_pe [B, S,
rope]``) holds 576 values a token and layer at DeepSeek-V2-Lite's widths,
where expanded keys and values would hold 16 · (192 + 128).

* Prefill expands the latent to every head's k and v and runs the
  ``flash_attention`` kernel, q and k (192) and v (128) zero-padded to the
  kernel's head size 256 (zeros add nothing to q·k, and the padded output
  columns are dropped).  The kernel scales scores by 1/sqrt(256), so q
  carries the rest of the model's softmax scale: q_nope is multiplied in
  place as it is laid out (one bf16 rounding), q_pe in fp32 with its
  rotation, before its cast.
* Decode takes the absorbed form in fp32: the query moves into latent
  space (``q_nope · W_UK``), scores are that against the cached latents
  plus ``q_pe · k_pe``, and the output is ``(p · c) · W_UV``, so no key or
  value is expanded.  The new token's latent is written into the cache at
  ``pos``, in place.

RoPE rotates consecutive pairs ``(2i, 2i + 1)``, as the source does (the
port's ``layers.apply_rope`` rotates halves), at YaRN's frequencies
(``transformers``' ``_compute_yarn_parameters``): each frequency ramps
between its extrapolated and its interpolated (``/ factor``) value over the
dimensions whose wavelengths lie between ``beta_fast`` and ``beta_slow``
rotations of the original context.  The cos/sin factor is
``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``, 1 where the two
are equal, and the softmax scale is ``mscale(factor, mscale_all_dim)² /
sqrt(qk_nope + qk_rope)``, as DeepSeek's own modelling code applies it.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import (BATCH, EMBED, HEADS, KV_SEQ,
                                           ParamDef)
from repro_torch.spans import span

KERNEL_HD = 256          # the flash_attention head size prefill pads to


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: ModelConfig) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies ``[rope / 2]`` fp32 on the CPU, cos/sin factor)
    of the roped part: plain RoPE where ``rope_scaling`` is empty, else
    YaRN's ramp, step for step as ``_compute_yarn_parameters`` takes it
    (correction range truncated to whole dimensions)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extra = 1.0 / pos_freqs
    y = cfg.yarn
    if not y:
        return extra, 1.0
    factor = y["factor"]
    inter = 1.0 / (factor * pos_freqs)
    orig = y["original_max_position_embeddings"]

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(y.get("beta_fast") or 32)), 0)
    high = min(math.ceil(corr(y.get("beta_slow") or 1)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1 - ramp                       # the extrapolated share
    inv = inter * (1 - keep) + extra * keep
    att = (_mscale(factor, y["mscale"]) / _mscale(factor, y["mscale_all_dim"])
           if y.get("mscale") and y.get("mscale_all_dim")
           else _mscale(factor, 1.0))
    return inv, float(att)


@functools.lru_cache(maxsize=None)
def _inv_freq_on(cfg: ModelConfig, device: torch.device):
    """:func:`yarn_inv_freq` on ``device``, made once (decode asks for it
    twice a layer and step)."""
    inv, att = yarn_inv_freq(cfg)
    return inv.to(device), att


def softmax_scale(cfg: ModelConfig) -> float:
    """``1 / sqrt(qk)`` times ``mscale(factor, mscale_all_dim)²`` under
    YaRN."""
    scale = 1.0 / math.sqrt(cfg.mla_qk_dim)
    y = cfg.yarn
    if y.get("mscale_all_dim"):
        scale *= _mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return scale


def rope_pairs(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, gain: float = 1.0) -> torch.Tensor:
    """``x [B, S, ..., rope]`` rotated by position, consecutive pairs
    ``(x[2i], x[2i+1])`` turning by ``pos · inv_freq[i]``, and multiplied
    by ``gain``; ``positions [S]``.  In fp32, cast back to x's type."""
    inv, att = _inv_freq_on(cfg, x.device)
    ang = positions.float()[:, None] * inv                       # [S, R/2]
    for _ in range(x.dim() - 3):
        ang = ang[:, None]
    cos, sin = torch.cos(ang) * (att * gain), torch.sin(ang) * (att * gain)
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.flatten(-2).to(x.dtype)


def mla_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    return {
        "wq": ParamDef((d, h * cfg.mla_qk_dim), (EMBED, HEADS)),
        "w_kva": ParamDef((d, r + cfg.qk_rope_head_dim), (EMBED, None)),
        "kv_norm": L.rms_norm_defs(r),
        "w_kvb": ParamDef((r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                          (None, HEADS)),
        "wo": ParamDef((h * cfg.v_head_dim, d), (HEADS, EMBED)),
    }


def mla_cache_defs(cfg: ModelConfig, batch: int, seq: int,
                   dtype=None) -> Dict[str, ParamDef]:
    logical = (BATCH, KV_SEQ, None)
    return {"c_kv": ParamDef((batch, seq, cfg.kv_lora_rank), logical,
                             dtype=dtype, init="zeros"),
            "k_pe": ParamDef((batch, seq, cfg.qk_rope_head_dim), logical,
                             dtype=dtype, init="zeros")}


def _project(cfg: ModelConfig, params, x: torch.Tensor):
    """x [B, S, D] → (q_nope [B,S,H,nope], q_pe [B,S,H,rope], normed
    latent c [B,S,r], k_pe [B,S,rope]), in x's type; the rope parts not
    yet rotated."""
    b, s, _ = x.shape
    h, nope, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = (x @ params["wq"]).view(b, s, h, cfg.mla_qk_dim)
    kva = x @ params["w_kva"]
    c = L.rms_norm(params["kv_norm"], kva[..., :r], cfg.norm_eps)
    return q[..., :nope], q[..., nope:], c, kva[..., r:]


def mla_apply(cfg: ModelConfig, params, x: torch.Tensor,
              positions: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal latent attention over the whole sequence (prefill and
    training): x [B, S, D] → (out [B, S, D], cache {c_kv, k_pe})."""
    b, s, _ = x.shape
    h, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd = cfg.v_head_dim
    # the softmax scale past the kernel's own 1/sqrt(KERNEL_HD), carried by q
    fold = softmax_scale(cfg) * math.sqrt(KERNEL_HD)
    q_nope, q_pe, c, k_pe = _project(cfg, params, x)
    with span("mla.expand"):
        q_pe = rope_pairs(q_pe, positions, cfg, gain=fold)
        k_pe = rope_pairs(k_pe, positions, cfg)
        kv = (c @ params["w_kvb"]).view(b, s, h, nope + vd)
        # heads first, zero-padded to the kernel's head size
        qh = x.new_zeros((b, h, s, KERNEL_HD))
        kh = x.new_zeros((b, h, s, KERNEL_HD))
        vh = x.new_zeros((b, h, s, KERNEL_HD))
        qh[..., :nope] = q_nope.transpose(1, 2)
        qh[..., :nope].mul_(fold)
        qh[..., nope:nope + rope] = q_pe.transpose(1, 2)
        kh[..., :nope] = kv[..., :nope].transpose(1, 2)
        kh[..., nope:nope + rope] = k_pe[:, None]
        vh[..., :vd] = kv[..., nope:].transpose(1, 2)
        del kv
    out = ops.flash_attention(qh.view(b * h, s, KERNEL_HD),
                              kh.view(b * h, s, KERNEL_HD),
                              vh.view(b * h, s, KERNEL_HD), causal=True)
    out = out.view(b, h, s, KERNEL_HD)[..., :vd].transpose(1, 2)
    out = out.reshape(b, s, h * vd) @ params["wo"]
    return out, {"c_kv": c, "k_pe": k_pe}


def mla_decode(cfg: ModelConfig, params, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token, absorbed form: x [B, 1, D]; cache c_kv [B, S_max, r],
    k_pe [B, S_max, rope]; ``pos`` the current length.  Writes the token's
    latent at ``pos`` in place and returns (out [B, 1, D], the cache)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"mla_decode takes one token, got {s}")
    h, nope, vd = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    s_max = cache["c_kv"].shape[1]
    if pos >= s_max:
        raise ValueError(f"decode writes slot {pos} of a {s_max}-slot "
                         "cache: grow it first (serving.grow_caches)")
    # a fill on the device, not an upload: no wait for the host's copy
    where = torch.full((1,), pos, dtype=torch.float32, device=x.device)
    q_nope, q_pe, c, k_pe = _project(cfg, params, x)
    q_pe = rope_pairs(q_pe, where, cfg)
    k_pe = rope_pairs(k_pe, where, cfg)
    with span("attention.latent"):
        cache["c_kv"][:, pos] = c[:, 0]
        cache["k_pe"][:, pos] = k_pe[:, 0]
        ck = cache["c_kv"][:, :pos + 1].float()                 # [B, T, r]
        kp = cache["k_pe"][:, :pos + 1].float()                 # [B, T, rope]
        w = params["w_kvb"].float().view(-1, h, nope + vd)      # [r, H, .]
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                             w[..., :nope])
        scores = (torch.einsum("bhr,btr->bht", q_lat, ck)
                  + torch.einsum("bhp,btp->bht", q_pe[:, 0].float(), kp))
        probs = torch.softmax(scores * softmax_scale(cfg), dim=-1)
        o_lat = torch.einsum("bht,btr->bhr", probs, ck)
        out = torch.einsum("bhr,rhv->bhv", o_lat, w[..., nope:])
    out = out.to(x.dtype).reshape(b, 1, h * vd) @ params["wo"]
    return out, cache
