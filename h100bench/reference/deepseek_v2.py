"""Plain fp32 DeepSeek-V2 decoder (DeepSeek-V2-Lite, arXiv:2405.04434):
RMS norm; multi-head latent attention in its expanded form (each head's
key ``[c · W_UK, k_pe]`` and value ``c · W_UV`` formed from the normed
latent ``c``, one roped key ``k_pe`` shared by the heads, q at full rank),
causal, at the softmax scale ``mscale(factor, mscale_all_dim)² /
sqrt(qk_nope + qk_rope)``; rotary positions on consecutive pairs ``(2i,
2i + 1)`` at YaRN's ramped frequencies; a SiLU-gated dense MLP in the
leading layers and after them a mixture of experts: softmax over the
routed experts in fp32, the top k (equal scores to the lower index), gates
the top-k probabilities (renormalised only where ``norm_topk_prob``) times
``routed_scaling_factor``, each expert run on exactly the tokens routed to
it (nothing dropped), plus the shared experts; an untied head.

:func:`served_logits` reads a served request in one causal pass over the
prompt and the served tokens; the latent cache is bf16 as the
configuration keeps it, which the pass does not round (as the llama
reference reads a bf16 cache).  One layer's weights are cast to fp32 as
the pass reaches them, and attention runs a sequence and a block of
queries at a time, so that 32k-token prompts fit.  Imports nothing of the
program; the weights are the benchmark's, by their paths in the program's
tree.
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
QUERY_BLOCK = 1024          # query rows a block of attention scores


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn(cfg: Dict):
    """(inverse frequencies ``[rope / 2]``, cos/sin factor, softmax
    scale): YaRN as the source's ``rope_scaling`` states it (the ramp
    between the extrapolated and the interpolated frequency over the
    dimensions whose wavelengths lie between ``beta_fast`` and
    ``beta_slow`` rotations of the original context, bounds truncated to
    whole dimensions), plain RoPE where it is absent."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    qk = cfg["qk_nope_head_dim"] + dim
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    y = cfg.get("rope_scaling") or {}
    if not y:
        return 1.0 / pos_freqs, 1.0, 1.0 / math.sqrt(qk)
    factor, orig = y["factor"], y["original_max_position_embeddings"]

    def dim_of(rotations):
        return (dim * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(dim_of(y["beta_fast"])), 0)
    high = min(math.ceil(dim_of(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    inv = (1.0 / (factor * pos_freqs)) * ramp + (1.0 / pos_freqs) * (1 - ramp)
    cos_sin = _mscale(factor, y["mscale"]) / _mscale(factor,
                                                      y["mscale_all_dim"])
    scale = _mscale(factor, y["mscale_all_dim"]) ** 2 / math.sqrt(qk)
    return inv, cos_sin, scale


def rope_pairs(x: torch.Tensor, inv: torch.Tensor, att: float) -> torch.Tensor:
    """``x [B, T, ..., R]`` rotated by position: the pairs ``(x[2i],
    x[2i+1])`` as complex numbers times ``att · e^{i · pos · inv[i]}``."""
    t = x.shape[1]
    ang = (torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
           * inv.to(x.device))
    for _ in range(x.dim() - 3):
        ang = ang[:, None]
    rot = torch.polar(torch.full_like(ang, att), ang)
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2)
                              .contiguous())
    return torch.view_as_real(z * rot).flatten(-2)


def attention(cfg: Dict, w, x, mm):
    b, t, _ = x.shape
    h, r = cfg["num_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    inv, att, scale = yarn(cfg)
    q = mm(x, w["mix/wq"]).reshape(b, t, h, nope + rope)
    kva = mm(x, w["mix/w_kva"])
    c = P.rms_norm(kva[..., :r], w["mix/kv_norm/scale"], cfg["norm_eps"])
    k_pe = rope_pairs(kva[..., r:], inv, att)                  # [B, T, R]
    q = torch.cat([q[..., :nope], rope_pairs(q[..., nope:], inv, att)], -1)
    kv = mm(c, w["mix/w_kvb"]).reshape(b, t, h, nope + vd)
    rows = torch.arange(t, device=x.device)
    out = torch.empty(b, t, h, vd, dtype=x.dtype, device=x.device)
    for i in range(b):
        k = torch.cat([kv[i, ..., :nope],
                       k_pe[i, :, None].expand(t, h, rope)], -1)
        k, v = k.transpose(0, 1), kv[i, ..., nope:].transpose(0, 1)
        qi = q[i].transpose(0, 1)                              # [H, T, .]
        for lo in range(0, t, QUERY_BLOCK):
            hi = min(t, lo + QUERY_BLOCK)
            s = (qi[:, lo:hi] @ k[:, :hi].transpose(1, 2)) * scale
            s = s.masked_fill(rows[None, lo:hi, None] < rows[None, None, :hi],
                              float("-inf"))
            out[i, lo:hi] = (torch.softmax(s, dim=-1)
                             @ v[:, :hi]).transpose(0, 1)
    return mm(out.reshape(b, t, h * vd), w["mix/wo"])


def _mlp(x, wi, wg, wd, mm):
    return mm(mm(x, wi) * F.silu(mm(x, wg)), wd)


def moe(cfg: Dict, w, x, mm):
    """Every expert on exactly the tokens routed to it."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    probs = torch.softmax(mm(x, w["ffn/router"]), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg["moe_top_k"]]
    gate = probs.gather(-1, idx)
    if cfg.get("norm_topk_prob", True):
        gate = gate / gate.sum(dim=-1, keepdim=True)
    gate = gate * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = _mlp(x[tok], w["ffn/we_i"][e], w["ffn/we_g"][e],
                     w["ffn/we_d"][e], mm)
            out.index_add_(0, tok, y * gate[tok, choice][:, None])
    if cfg.get("num_shared_experts"):
        out = out + _mlp(x, w["ffn/shared/wi"], w["ffn/shared/wg"],
                         w["ffn/shared/wd"], mm)
    return out.reshape(shape)


def layer(cfg: Dict, w, x, dense: bool, mm):
    eps = cfg["norm_eps"]
    w = {n: t.float() for n, t in w.items()}
    x = x + attention(cfg, w, P.rms_norm(x, w["ln1/scale"], eps), mm)
    hdn = P.rms_norm(x, w["ln2/scale"], eps)
    if dense:
        return x + _mlp(hdn, w["ffn/wi"], w["ffn/wg"], w["ffn/wd"], mm)
    return x + moe(cfg, w, hdn, mm)


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
    dense = cfg.get("first_dense_layers", 0)
    with P.exact_fp32():
        x = F.embedding(tokens, weights["embed/embedding"]).float()
        for i, w in enumerate(P.layer_leaves(weights, cfg["num_layers"])):
            x = layer(cfg, w, x, i < dense, mm)
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
