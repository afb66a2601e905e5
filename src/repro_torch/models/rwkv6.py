"""RWKV6 (Finch): attention-free time mix with data-dependent decay (the
reference's ``repro.models.rwkv6``).

Per head, a matrix-valued state ``S ∈ R^{hd_k × hd_v}`` with

    out_t = r_t · (S_t + u ⊙ k_t v_tᵀ)
    S_{t+1} = diag(w_t) S_t + k_t v_tᵀ,     w_t = exp(-exp(d_t))

where the decay ``d_t`` comes from a low-rank projection of the
token-shifted input.  Prefill runs the chunked recurrence through
``kernels.ops.rwkv6_chunked``: the hand-written CUDA kernel on the card,
its plain version on the CPU.  The reference's ``chunk_body`` lives on as
that plain version's building block, ``kernels.ref.chunk_body``.  Decode is
the single-step formula in torch ops, with no kernel, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import BATCH, EMBED, HEADS, REPL, ParamDef

# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------


def time_mix_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    h, hd = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    lora = cfg.rwkv_lora_decay
    return {
        # token-shift mixing coefficients for (r, k, v, g, w)
        "mix": ParamDef((5, d), (None, REPL), init="zeros"),
        "wr": ParamDef((d, d), (EMBED, HEADS)),
        "wk": ParamDef((d, d), (EMBED, HEADS)),
        "wv": ParamDef((d, d), (EMBED, HEADS)),
        "wg": ParamDef((d, d), (EMBED, HEADS)),
        "wo": ParamDef((d, d), (HEADS, EMBED)),
        "decay_bias": ParamDef((d,), (REPL,), init="zeros"),
        "decay_a": ParamDef((d, lora), (EMBED, None)),
        "decay_b": ParamDef((lora, d), (None, HEADS)),
        "bonus_u": ParamDef((h, hd), (HEADS, None), init="zeros"),
        "ln_x": ParamDef((d,), (REPL,), init="ones"),   # per-head group norm
    }


def channel_mix_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mix": ParamDef((2, d), (None, REPL), init="zeros"),   # (k, r)
        "wk": ParamDef((d, ff), (EMBED, HEADS)),
        "wv": ParamDef((ff, d), (HEADS, EMBED)),
        "wr": ParamDef((d, d), (EMBED, HEADS)),
    }


def state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    h, hd = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    d = cfg.d_model
    return {
        "wkv": ParamDef((batch, h, hd, hd), (BATCH, HEADS, None, None),
                        dtype=torch.float32, init="zeros"),
        "shift_tm": ParamDef((batch, d), (BATCH, None),
                             dtype=torch.float32, init="zeros"),
        "shift_cm": ParamDef((batch, d), (BATCH, None),
                             dtype=torch.float32, init="zeros"),
    }


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """xs[t] = x[t-1], xs[0] = prev.  x [B,S,D], prev [B,D]."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _projections(cfg: ModelConfig, params, x, xs):
    """Returns r,k,v,g [B,S,H,hd] and log-decay logw [B,S,H,hd] (<= 0)."""
    b, s, d = x.shape
    h, hd = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    mix = params["mix"].to(x.dtype)                        # [5, D]
    delta = xs - x
    xr, xk, xv, xg, xw = (x + mix[i] * delta for i in range(5))
    r = (xr @ params["wr"]).reshape(b, s, h, hd)
    k = (xk @ params["wk"]).reshape(b, s, h, hd)
    v = (xv @ params["wv"]).reshape(b, s, h, hd)
    g = (xg @ params["wg"]).reshape(b, s, h, hd)
    lora = torch.tanh(xw @ params["decay_a"]) @ params["decay_b"]
    dlog = params["decay_bias"].float() + lora.float()
    logw = -torch.exp(dlog).reshape(b, s, h, hd)           # <= 0
    return r, k, v, g, logw


def _group_norm(cfg: ModelConfig, params, x: torch.Tensor, eps: float):
    """Per-head RMS norm on [B,S,H,hd], fp32 out."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    _, _, h, hd = x.shape
    return xf * params["ln_x"].reshape(h, hd).float()


# ---------------------------------------------------------------------------
# Chunked sequence form (prefill)
# ---------------------------------------------------------------------------


def time_mix_apply(
    cfg: ModelConfig, params, x: torch.Tensor, state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence time mix, x [B,S,D], from the carried ``state``.  The
    sequence is padded to a multiple of ``min(cfg.chunk_len, S)`` with
    ``k = 0`` (adds nothing to the state) and ``logw = 0`` (leaves it
    undecayed), so the padded positions are inert and sliced off."""
    b, s, d = x.shape
    h, hd = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    cl = min(cfg.chunk_len, s)
    xs = _token_shift(x, state["shift_tm"])
    r, k, v, g, logw = _projections(cfg, params, x, xs)
    pad = (-s) % cl

    def heads_first(t):   # [B,S,H,hd] -> [B,H,S+pad,hd], contiguous
        return F.pad(t.transpose(1, 2), (0, 0, 0, pad)).contiguous()

    out, final_state = ops.rwkv6_chunked(
        heads_first(r), heads_first(k), heads_first(v), heads_first(logw),
        params["bonus_u"], chunk=cl,
        state=state["wkv"].float().contiguous())
    out = out.transpose(1, 2)[:, :s]                       # [B,S,H,hd]
    out = _group_norm(cfg, params, out, cfg.norm_eps)
    out = (out * F.silu(g.float())).reshape(b, s, d)
    out = out.to(x.dtype) @ params["wo"]
    new = {"wkv": final_state,
           "shift_tm": x[:, -1, :].float(),
           "shift_cm": state["shift_cm"]}
    return out, new


def time_mix_decode(
    cfg: ModelConfig, params, x: torch.Tensor, state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode.  x [B,1,D]."""
    b, _, d = x.shape
    xs = state["shift_tm"][:, None, :].to(x.dtype)
    r, k, v, g, logw = _projections(cfg, params, x, xs)
    r, k, v, g, logw = (t[:, 0] for t in (r, k, v, g, logw))   # [B,H,hd]
    rf, kf, vf = (t.float() for t in (r, k, v))
    u = params["bonus_u"].float()
    s0 = state["wkv"]
    kv = kf[..., :, None] * vf[..., None, :]                   # [B,H,hdk,hdv]
    out = torch.einsum("bhd,bhde->bhe", rf, s0 + u[None, :, :, None] * kv)
    new_wkv = torch.exp(logw)[..., None] * s0 + kv
    out = _group_norm(cfg, params, out[:, None, :, :], cfg.norm_eps)
    out = (out * F.silu(g.float())[:, None]).reshape(b, 1, d)
    out = out.to(x.dtype) @ params["wo"]
    new = {"wkv": new_wkv,
           "shift_tm": x[:, -1, :].float(),
           "shift_cm": state["shift_cm"]}
    return out, new


# ---------------------------------------------------------------------------
# Channel mix
# ---------------------------------------------------------------------------


def channel_mix_apply(cfg: ModelConfig, params, x: torch.Tensor,
                      state: Dict[str, torch.Tensor], decode: bool):
    prev = state["shift_cm"]
    if decode:
        xs = prev[:, None, :].to(x.dtype)
    else:
        xs = _token_shift(x, prev)
    mix = params["mix"].to(x.dtype)
    delta = xs - x
    xk = x + mix[0] * delta
    xr = x + mix[1] * delta
    k = torch.square(torch.relu(xk @ params["wk"]))
    out = torch.sigmoid(xr @ params["wr"]) * (k @ params["wv"])
    new = dict(state)
    new["shift_cm"] = x[:, -1, :].float()
    return out, new
