"""Mixture-of-Experts FFN (the reference's ``repro.models.moe``), on one
device.

Two dispatch modes, as the reference has them:

* ``einsum`` — the one-hot dispatch/combine formulation: the combine
  tensor ``[T, E, C]`` holds each kept (token, choice) pair's gate at its
  expert and slot, and the output is its product with the experts'
  outputs.  The reference builds ``combine`` as an einsum of four one-hot
  operands; for a given (t, e, c) at most one choice is non-zero (a
  token's k experts differ), so scattering the gates gives the same
  tensor bit for bit without the ``[T, k, E, C]`` intermediate.  Its
  dispatch, ``(combine > 0)`` times the tokens, has one non-zero term a
  slot: it is the row gather done here, bit for bit.
* ``scatter`` — slot-scatter dispatch: tokens go straight into the
  ``[E, C, D]`` expert buffer and come back by a gather; the k weighted
  outputs of a token are added one choice at a time, in choice order and
  in the experts' dtype, as the reference's scatter-add does (never by
  atomics, whose order would differ from run to run and between a
  forward and its recomputation under remat).

Capacity is the reference's ``C = ceil(T·k/E · capacity_factor)`` rounded
up to a multiple of 8 (at least 8).  Slots are handed out in token-major,
choice-minor order; pairs past an expert's capacity are dropped.  The
router picks the top k probabilities with ties broken to the lower expert
index (``jax.lax.top_k``'s order; ``torch.topk`` breaks them otherwise),
by a stable descending sort.  The expert products are batched matrix
products (``torch.bmm``), as the reference's einsums.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.parallel.sharding import EMBED, EXPERT, HEADS, ParamDef

DISPATCH_MODE = "einsum"      # the mode where neither call nor config names one


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    if cfg.opt_moe_ff_shard:
        # the reference's FSDP layout on the ff dim: only the logical axes
        # differ
        defs = {
            "router": ParamDef((d, e), (None, EXPERT)),
            "we_i": ParamDef((e, d, ff), (EXPERT, None, EMBED)),
            "we_g": ParamDef((e, d, ff), (EXPERT, None, EMBED)),
            "we_d": ParamDef((e, ff, d), (EXPERT, EMBED, None)),
        }
    else:
        defs = {
            "router": ParamDef((d, e), (EMBED, EXPERT)),
            "we_i": ParamDef((e, d, ff), (EXPERT, EMBED, None)),
            "we_g": ParamDef((e, d, ff), (EXPERT, EMBED, None)),
            "we_d": ParamDef((e, ff, d), (EXPERT, None, EMBED)),
        }
    if cfg.num_shared_experts:
        sff = cfg.num_shared_experts * cfg.moe_d_ff
        defs["shared"] = {
            "wi": ParamDef((d, sff), (EMBED, HEADS)),
            "wg": ParamDef((d, sff), (EMBED, HEADS)),
            "wd": ParamDef((sff, d), (HEADS, EMBED)),
        }
    return defs


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = math.ceil(num_tokens * cfg.moe_top_k / cfg.num_experts
                  * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))


def top_k_lower_first(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, largest
    first and equal values in ascending index order, as
    ``jax.lax.top_k``: a stable descending sort, its first k."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return probs.gather(-1, idx), idx


def _route(cfg: ModelConfig, params, xf: torch.Tensor):
    """xf [T, D] → (expert_idx [T,k], gate [T,k], aux_loss, probs [T,E])."""
    logits = (xf @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k_lower_first(probs, cfg.moe_top_k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch): E · Σ_e f_e · p_e
    e = cfg.num_experts
    experts = torch.arange(e, device=idx.device)
    counts = (idx.reshape(-1, 1) == experts).sum(dim=0).float()
    frac_tokens = counts / (xf.shape[0] * cfg.moe_top_k)
    frac_probs = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return idx, gate, aux, probs


def _expert_ffn(cfg, params, xe: torch.Tensor) -> torch.Tensor:
    """xe [E, C, D] → [E, C, D] through each expert's gated MLP."""
    h = torch.bmm(xe, params["we_i"])
    g = torch.bmm(xe, params["we_g"])
    return torch.bmm(h * F.silu(g), params["we_d"])


def _slots(cfg, idx: torch.Tensor, c: int):
    """Each (token, choice) pair's place in its expert's queue, pairs in
    token-major, choice-minor order: (flat slot ``expert · c + slot``
    [T*k], keep [T*k] where the slot is below ``c``)."""
    flat_e = idx.reshape(-1)
    experts = torch.arange(cfg.num_experts, device=idx.device)
    # each expert's queue as a running count over the pairs, scanned along
    # the last dimension: on the card a scan along the first one runs a
    # thread a column, E threads for T*k steps
    queue = torch.cumsum(experts[:, None] == flat_e, dim=1)      # [E, T*k]
    slot = queue.gather(0, flat_e[None, :])[0] - 1
    keep = slot < c
    return flat_e * c + torch.clamp(slot, max=c - 1), keep


def _fill_experts(xf: torch.Tensor, rows: torch.Tensor, live: torch.Tensor,
                  e: int, c: int) -> torch.Tensor:
    """The expert buffer [E, C, D]: pair i's token (i // k) at flat slot
    ``rows[i]`` where ``live[i]``, zeros in the slots no pair holds.  The
    other pairs go to a spare row past the buffer, so that no boolean
    mask (and no wait for the device) is needed."""
    t, d = xf.shape
    k = rows.shape[0] // t
    buf = xf.new_zeros((e * c + 1, d))
    buf.index_put_((torch.where(live, rows, e * c),),
                   xf.repeat_interleave(k, dim=0))
    return buf[:e * c].view(e, c, d)


def _dispatch_einsum(cfg, params, xf, idx, gate):
    t, d = xf.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    c = capacity(cfg, t)
    rows, keep = _slots(cfg, idx, c)
    gates = gate.reshape(-1)
    # combine [T, E, C]: each kept pair's gate at its expert and slot
    # (dropped pairs land in a spare row past the last token)
    tok = torch.arange(t, device=xf.device).repeat_interleave(k)
    combine = gate.new_zeros((t + 1, e * c))
    combine.index_put_((torch.where(keep, tok, t), rows), gates)
    combine = combine[:t].view(t, e, c)
    # dispatch = (combine > 0) times the tokens: a row gather
    xe = _fill_experts(xf, rows, keep & (gates > 0), e, c)
    ye = _expert_ffn(cfg, params, xe)
    return torch.einsum("tec,ecd->td", combine.to(ye.dtype), ye)


def _dispatch_scatter(cfg, params, xf, idx, gate):
    t, d = xf.shape
    e, k = cfg.num_experts, cfg.moe_top_k
    c = capacity(cfg, t)
    rows, keep = _slots(cfg, idx, c)
    ye = _expert_ffn(cfg, params, _fill_experts(xf, rows, keep, e, c))
    gathered = ye.reshape(e * c, d)[rows]                    # [T*k, D]
    w = (gate.reshape(-1) * keep).to(ye.dtype)
    terms = (w[:, None] * gathered).view(t, k, d)
    out = torch.zeros((t, d), dtype=ye.dtype, device=xf.device)
    for j in range(k):               # the reference's scatter-add order
        out = out + terms[:, j]
    return out


def _shared_ffn(params, xf: torch.Tensor) -> torch.Tensor:
    sh = params["shared"]
    return ((xf @ sh["wi"]) * F.silu(xf @ sh["wg"])) @ sh["wd"]


def moe_apply(cfg: ModelConfig, params, x: torch.Tensor, *,
              dispatch: str = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] → (y [B,S,D], aux_loss scalar fp32).

    Where ``cfg.moe_seq_chunk`` divides S and is shorter, the positions go
    in segments of that length, each holding every row (T = B · segment),
    and the aux loss is the segments' mean, as in the reference.
    """
    b, s, d = x.shape
    seg = cfg.moe_seq_chunk
    if seg and s > seg and s % seg == 0:
        xs = x.reshape(b, s // seg, seg, d).movedim(1, 0)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for si in range(s // seg):
            y, aux = moe_apply(cfg, params, xs[si], dispatch=dispatch)
            aux_total = aux_total + aux
            ys.append(y)
        y = torch.stack(ys).movedim(0, 1).reshape(b, s, d)
        return y, aux_total / (s // seg)
    xf = x.reshape(b * s, d)
    idx, gate, aux, _ = _route(cfg, params, xf)
    mode = dispatch or cfg.moe_dispatch or DISPATCH_MODE
    if mode == "scatter":
        y = _dispatch_scatter(cfg, params, xf, idx, gate.to(xf.dtype))
    elif mode == "einsum":
        y = _dispatch_einsum(cfg, params, xf, idx, gate.float())
    else:
        raise ValueError(f"moe dispatch {mode!r}: einsum or scatter")
    y = y.to(x.dtype)
    if cfg.num_shared_experts:
        y = y + _shared_ffn(params, xf)
    return y.reshape(b, s, d), aux
