"""Shared layer primitives, the part RWKV6 needs: RMS norm, embedding and
the LM head (the reference's ``repro.models.layers``).

Parameters are nested dicts of tensors made from ``ParamDef`` trees
(``repro_torch.parallel.sharding``).  Activations keep the reference's
layouts: tokens ``[B, S]`` int, hidden ``[B, S, D]`` in the model's dtype.
Attention, RoPE, the MLP and cross-entropy come with the RecurrentGemma
slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.parallel.sharding import EMBED, HEADS, REPL, VOCAB, ParamDef

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
    return params["embedding"][tokens].to(dtype)


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
