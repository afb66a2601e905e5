"""Plain fp32 decoder of the llama architecture (DeepSeek LLM 7B,
arXiv:2401.02954): RMS norm, rotary positions on half-split heads, causal
multi-head attention, a SiLU-gated MLP, an untied head.

:func:`served_logits` reads a served request the way it was served: the
prompt and the served tokens in one causal pass, the logits at each
position that chose a served token.  Where the configuration keeps its
KV cache in int8 (``kv_cache_dtype``), a served token's query reads every
key and value as the cache holds them: each position's key and value
rounded to int8 under one absmax scale a head, half to even; the prompt's
last position, which the prefill reads, sees them unrounded.  Layer by
layer, a sequence's attention at a time, so that it fits beside nothing.
Imports nothing of the program; the weights are the benchmark's, by their
paths in the program's tree.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import Dict

import torch
import torch.nn.functional as F


def _plain():
    spec = importlib.util.spec_from_file_location(
        "h100bench_reference_plain", Path(__file__).with_name("_plain.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P = _plain()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [B, T, H, D]`` rotated by position: the halves ``x1, x2`` of each
    head turn by ``pos / theta^(2i / D)``."""
    t, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def int8_round_trip(x: torch.Tensor) -> torch.Tensor:
    """Each row of the last axis rounded to int8 under its absmax / 127."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale


def _attend(q, k, v, mask):
    """``q [H, R, D]`` against ``k, v [H, C, D]`` where ``mask [R, C]``."""
    s = (q @ k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def attention(cfg: Dict, w, x, prompt_len: int, mm):
    b, t, d = x.shape
    h, hd = cfg["num_heads"], cfg["head_dim"]
    kvh = cfg["num_kv_heads"]
    q = rope(mm(x, w["mix/wq"]).reshape(b, t, h, hd), cfg["rope_theta"])
    k = rope(mm(x, w["mix/wk"]).reshape(b, t, kvh, hd), cfg["rope_theta"])
    v = mm(x, w["mix/wv"]).reshape(b, t, kvh, hd)
    int8 = cfg.get("kv_cache_dtype") == "int8"
    rows = torch.arange(t, device=x.device)
    out = torch.empty(b, t, h, hd, dtype=x.dtype, device=x.device)
    g = h // kvh
    for i in range(b):
        qi = q[i].transpose(0, 1)                              # [H, T, D]
        ki = k[i].transpose(0, 1).repeat_interleave(g, 0)
        vi = v[i].transpose(0, 1).repeat_interleave(g, 0)
        p = prompt_len
        causal = rows[:p, None] >= rows[None, :p]
        out[i, :p] = _attend(qi[:, :p], ki[:, :p], vi[:, :p],
                             causal).transpose(0, 1)
        if t > p:
            kc = int8_round_trip(ki) if int8 else ki
            vc = int8_round_trip(vi) if int8 else vi
            causal = rows[p:, None] >= rows[None, :]
            out[i, p:] = _attend(qi[:, p:], kc, vc, causal).transpose(0, 1)
    return mm(out.reshape(b, t, h * hd), w["mix/wo"])


def layer(cfg: Dict, w, x, prompt_len: int, mm):
    eps = cfg["norm_eps"]
    w = {n: t.float() for n, t in w.items()}
    x = x + attention(cfg, w, P.rms_norm(x, w["ln1/scale"], eps),
                      prompt_len, mm)
    hdn = P.rms_norm(x, w["ln2/scale"], eps)
    return x + mm(mm(hdn, w["ffn/wi"]) * F.silu(mm(hdn, w["ffn/wg"])),
                  w["ffn/wd"])


@torch.no_grad()
def served_logits(cfg: Dict, weights: Dict[str, torch.Tensor],
                  prompts: torch.Tensor, served: torch.Tensor,
                  precision: str = "fp32") -> torch.Tensor:
    """``prompts [B, P]`` and the tokens served after them ``served [B,
    N]`` → the logits ``[B, N, V]`` fp32 at the positions ``P - 1 .. P + N
    - 2``, each the distribution its served token was chosen from."""
    mm = P.Products(precision)
    p = prompts.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
    with P.exact_fp32():
        x = F.embedding(tokens, weights["embed/embedding"]).float()
        for w in P.layer_leaves(weights, cfg["num_layers"]):
            x = layer(cfg, w, x, p, mm)
        x = P.rms_norm(x[:, p - 1:], weights["final_norm/scale"].float(),
                       cfg["norm_eps"])
        return mm(x, weights["embed/head"].float())


def widest_gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """For each request, the widest gap by which a chosen token's logit
    lies below the best logit at its position: ``logits [B, N, V]``,
    ``chosen [B, N]`` → ``[B]``."""
    best = logits.amax(dim=-1)
    got = torch.gather(logits, -1, chosen[..., None].long())[..., 0]
    return (best - got).amax(dim=-1)
