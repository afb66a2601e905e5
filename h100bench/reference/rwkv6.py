"""Plain fp32 RWKV6 ("Finch", arXiv:2404.05892): the language model's
loss, its gradients by autograd, and AdamW, step by step.

Per head, a matrix state ``S`` with ``out_t = r_t (S_t + diag(u) k_t v_tᵀ)``
and ``S_{t+1} = diag(w_t) S_t + k_t v_tᵀ``, ``w_t = exp(-exp(d_t))``, the
decay ``d_t`` from a low-rank projection of the token-shifted input; a
per-head RMS norm and a SiLU gate on the output; then a channel mix
``sigmoid(x_r W_r) ⊙ (relu(x_k W_k)² W_v)`` with its own token shift.

The recurrence is computed exactly in chunks: inside a chunk every pair's
decay ``exp(Σ_{j<m<i} log w_m)`` is formed per channel (each exponent ≤ 0),
across chunks the state is carried.  Every layer is checkpointed, so that
the reference fits beside its optimizer state.  Imports nothing of the
program; the weights are the benchmark's, by their paths in the program's
tree.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _plain():
    spec = importlib.util.spec_from_file_location(
        "h100bench_reference_plain", Path(__file__).with_name("_plain.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P = _plain()
CHUNK = 32


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """``r, k, v, logw [B, S, H, D]`` fp32 (log decay ≤ 0), ``u [H, D]`` →
    ``out [B, S, H, D]``, from a zero state."""
    b, s, h, d = r.shape
    c = min(chunk, s)
    pad = (-s) % c
    tr = [F.pad(t.transpose(1, 2), (0, 0, 0, pad)) for t in (r, k, v, logw)]
    n = (s + pad) // c
    r_, k_, v_, lw = (t.reshape(b, h, n, c, d) for t in tr)
    cum = torch.cumsum(lw, dim=3)                      # Σ_{m <= i}
    excl = F.pad(cum, (0, 0, 1, 0))[..., :-1, :]       # Σ_{m < i}
    # inside a chunk: the pair (i, j < i) decays by exp(excl_i - cum_j),
    # a sum of log decays over j < m < i (≤ 0); the pairs j >= i are
    # zeroed before the exponential, so that no gradient meets an inf
    below = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    diff = (excl[..., :, None, :] - cum[..., None, :, :]).masked_fill(
        ~below[:, :, None], 0.0)
    decay = torch.exp(diff) * below[:, :, None]
    a = torch.einsum("bhnid,bhnjd,bhnijd->bhnij", r_, k_, decay)
    bonus = torch.einsum("bhnid,hd,bhnid->bhni", r_, u, k_)
    out = a @ v_ + bonus[..., None] * v_
    # across chunks: the state entering each chunk
    total = cum[..., -1, :]                            # [B, H, N, D]
    inc = torch.einsum("bhncd,bhnce->bhnde",
                       k_ * torch.exp(total[..., None, :] - cum), v_)
    state = torch.zeros(b, h, d, d, dtype=r.dtype, device=r.device)
    entering = []
    for i in range(n):
        entering.append(state)
        state = torch.exp(total[:, :, i])[..., None] * state + inc[:, :, i]
    states = torch.stack(entering, dim=2)              # [B, H, N, D, D]
    out = out + torch.einsum("bhncd,bhnde->bhnce", r_ * torch.exp(excl),
                             states)
    return out.reshape(b, h, n * c, d)[:, :, :s].transpose(1, 2)


def _shift(x):
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def time_mix(w: Dict[str, torch.Tensor], x, cfg, mm):
    b, s, d = x.shape
    hd = cfg["rwkv_head_dim"]
    h = d // hd
    delta = _shift(x) - x
    xr, xk, xv, xg, xw = (x + w["mix/mix"][i] * delta for i in range(5))
    r, k, v, g = (mm(t, w[f"mix/{n}"]).reshape(b, s, h, hd)
                  for t, n in ((xr, "wr"), (xk, "wk"), (xv, "wv"),
                               (xg, "wg")))
    lora = mm(torch.tanh(mm(xw, w["mix/decay_a"])), w["mix/decay_b"])
    logw = -torch.exp(w["mix/decay_bias"] + lora).reshape(b, s, h, hd)
    out = wkv(r, k, v, logw, w["mix/bonus_u"])
    out = out * torch.rsqrt(torch.mean(out * out, dim=-1, keepdim=True)
                            + cfg["norm_eps"]) * w["mix/ln_x"].reshape(h, hd)
    out = (out * F.silu(g)).reshape(b, s, d)
    return mm(out, w["mix/wo"])


def channel_mix(w: Dict[str, torch.Tensor], x, mm):
    delta = _shift(x) - x
    xk = x + w["ffn/mix"][0] * delta
    xr = x + w["ffn/mix"][1] * delta
    k = torch.square(torch.relu(mm(xk, w["ffn/wk"])))
    return torch.sigmoid(mm(xr, w["ffn/wr"])) * mm(k, w["ffn/wv"])


def layer(w, x, cfg, mm):
    eps = cfg["norm_eps"]
    x = x + time_mix(w, P.rms_norm(x, w["ln1/scale"], eps), cfg, mm)
    return x + channel_mix(w, P.rms_norm(x, w["ln2/scale"], eps), mm)


def loss(params: Dict[str, torch.Tensor], tokens, labels, cfg, mm):
    """Mean next-token cross-entropy of ``tokens [B, S]`` against
    ``labels``, every layer checkpointed."""
    x = F.embedding(tokens.long(), params["embed/embedding"])
    for w in P.layer_leaves(params, cfg["num_layers"]):
        x = checkpoint(lambda x, w=w: layer(w, x, cfg, mm), x,
                       use_reentrant=False)
    x = P.rms_norm(x, params["final_norm/scale"], cfg["norm_eps"])
    return P.cross_entropy(mm(x, params["embed/head"]), labels)


def train_readings(cfg: Dict, weights: Dict[str, torch.Tensor],
                   batches: List[Dict], n_mb: int, *, steps: int = 3,
                   precision: str = "fp32", half_batch: bool = False,
                   keep_grads=None) -> Dict:
    """``steps`` training steps from ``weights`` (the benchmark's, in the
    configuration's parameter type) on ``batches`` (``tokens``, ``labels``
    ``[B, S]`` numpy), each over ``n_mb`` microbatches, AdamW as
    ``cfg["train"]`` states.  Returns each step's loss, every leaf's first
    gradient as AdamW took it (clipped) and every leaf's change over the
    steps, and the first gradient itself (on the host) of each leaf that
    ``keep_grads`` names, by its name there, as ``(path, index)``: the
    whole leaf where the index is None, else that layer's slice of a
    stacked leaf.  ``half_batch`` takes each step over its first half of
    the microbatches alone (a fault for the check's tests)."""
    mm = P.Products(precision)
    dev = next(iter(weights.values())).device
    ptype = next(iter(weights.values())).dtype
    with P.exact_fp32():
        params = {n: t.to(torch.float32, copy=True).requires_grad_()
                  for n, t in weights.items()}
        opt = P.AdamW(params, cfg["train"], ptype)
        losses, first, kept = [], None, {}
        use = n_mb // 2 if half_batch else n_mb
        for step in range(steps):
            tok = torch.as_tensor(batches[step]["tokens"], device=dev)
            lab = torch.as_tensor(batches[step]["labels"], device=dev)
            per = tok.shape[0] // n_mb
            total = 0.0
            for i in range(use):
                part = slice(i * per, (i + 1) * per)
                value = loss(params, tok[part], lab[part], cfg, mm)
                value.backward()
                total += float(value.detach())
            grads = {n: p.grad.mul_(1.0 / use) for n, p in params.items()}
            clip = opt.clip(grads)
            if first is None:
                kept = {name: ((grads[p] if i is None else grads[p][i])
                               * clip).cpu()
                        for name, (p, i) in (keep_grads or {}).items()}
            norms = opt.step(params, grads, P.lr_at(cfg["train"], step))
            del grads
            for p in params.values():
                p.grad = None
            losses.append(total / use)
            if first is None:
                first = norms
        change = {n: float(torch.linalg.vector_norm(
            p.detach() - weights[n].float())) for n, p in params.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "first_grads": kept}

