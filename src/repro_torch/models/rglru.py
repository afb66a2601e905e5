"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; the
reference's ``repro.models.rglru``).

Block:  x ──► W_x ──► causal depthwise conv(width 4) ──► RG-LRU ──┐
        x ──► W_y ──► GeLU ────────────────────────────────────── ⊙ ──► W_out

RG-LRU recurrence (per channel):

    r_t = σ(w_a ⊙ u_t + b_a)          recurrence gate
    i_t = σ(w_x ⊙ u_t + b_x)          input gate
    log a_t = −c · r_t · softplus(Λ)   (a = σ(Λ)^{c·r_t}, c = 8)
    h_t = a_t · h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ u_t)

The gates use diagonal (per-channel) weights, as in the reference.
Prefill runs the gates and the recurrence through
``kernels.ops.rglru_gated_scan``: on the card the hand-written CUDA kernel
forms ``a`` and the gated input from ``u`` and walks the recurrence; on
the CPU its plain version, ``kernels.ref.rglru_gated_scan_ref``, runs the
gates as torch ops (its own copy of ``_gates`` below) and the recurrence
one step after another.  The reference evaluates the recurrence with an associative scan, which
agrees to rounding.  Decode is the one-step formula in torch ops, as in
the reference.

Two numerical points follow the reference where PyTorch's defaults differ
from JAX's: the GeLU is the tanh approximation (``jax.nn.gelu`` defaults
to it, ``F.gelu`` to the erf form), and the causal conv is the reference's
shifted multiply-adds in its order, not ``F.conv1d`` (which goes through
cuDNN, in TF32 by default for fp32).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import BATCH, EMBED, HEADS, ParamDef

_C = 8.0  # Griffin's fixed exponent scale


def rglru_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, w = cfg.d_model, cfg.lru_dim
    cw = cfg.conv_width
    return {
        "w_x": ParamDef((d, w), (EMBED, HEADS)),
        "w_y": ParamDef((d, w), (EMBED, HEADS)),
        "w_out": ParamDef((w, d), (HEADS, EMBED)),
        "conv_w": ParamDef((cw, w), (None, HEADS)),
        "conv_b": ParamDef((w,), (HEADS,), init="zeros"),
        "lam": ParamDef((w,), (HEADS,), init="ones"),       # Λ
        "gate_a_w": ParamDef((w,), (HEADS,), init="ones"),
        "gate_a_b": ParamDef((w,), (HEADS,), init="zeros"),
        "gate_x_w": ParamDef((w,), (HEADS,), init="ones"),
        "gate_x_b": ParamDef((w,), (HEADS,), init="zeros"),
    }


def rglru_state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    w, cw = cfg.lru_dim, cfg.conv_width
    return {
        "h": ParamDef((batch, w), (BATCH, HEADS), dtype=torch.float32,
                      init="zeros"),
        "conv": ParamDef((batch, cw - 1, w), (BATCH, None, HEADS),
                         dtype=torch.float32, init="zeros"),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


def _conv_taps(params, full: torch.Tensor, s: int) -> torch.Tensor:
    """Σ_i full[:, i:i+s] · conv_w[i] + conv_b, the taps added in the
    reference's order."""
    w = params["conv_w"].to(full.dtype)
    out = full[:, 0:s] * w[0]
    for i in range(1, w.shape[0]):
        out = out + full[:, i:i + s] * w[i]
    return out + params["conv_b"].to(full.dtype)


def _causal_conv(params, u: torch.Tensor, conv_state: torch.Tensor):
    """Depthwise causal conv, width cw.  u [B,S,W]; conv_state [B,cw-1,W]."""
    cw = params["conv_w"].shape[0]
    full = torch.cat([conv_state.to(u.dtype), u], dim=1)
    out = _conv_taps(params, full, u.shape[1])
    new_state = full[:, full.shape[1] - (cw - 1):].float()
    return out, new_state


def _gates(params, u: torch.Tensor):
    uf = u.float()
    r = torch.sigmoid(params["gate_a_w"] * uf + params["gate_a_b"])
    i = torch.sigmoid(params["gate_x_w"] * uf + params["gate_x_b"])
    log_a = -_C * r * F.softplus(params["lam"].float())
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-6)) * (i * uf)
    return a, gated


def rglru_apply(
    cfg: ModelConfig, params, x: torch.Tensor, state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence block from the carried ``state``.  x [B,S,D] →
    ([B,S,D], new state)."""
    u = x @ params["w_x"]
    y = _gelu(x @ params["w_y"])
    u, conv_state = _causal_conv(params, u, state["conv"])
    h = ops.rglru_gated_scan(
        u, params["gate_a_w"], params["gate_a_b"], params["gate_x_w"],
        params["gate_x_b"], F.softplus(params["lam"].float()),
        state["h"].float().contiguous())                 # fp32 [B,S,W]
    out = (h * y.float()).to(x.dtype) @ params["w_out"]
    return out, {"h": h[:, -1, :], "conv": conv_state}


def rglru_decode(
    cfg: ModelConfig, params, x: torch.Tensor, state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode.  x [B,1,D]."""
    u = x @ params["w_x"]
    y = _gelu(x @ params["w_y"])
    full = torch.cat([state["conv"].to(u.dtype), u], dim=1)
    u1 = _conv_taps(params, full, 1)
    a, gated = _gates(params, u1)                      # [B,1,W]
    h = a[:, 0] * state["h"] + gated[:, 0]
    out = (h[:, None, :] * y.float()).to(x.dtype) @ params["w_out"]
    return out, {"h": h, "conv": full[:, 1:].float()}
