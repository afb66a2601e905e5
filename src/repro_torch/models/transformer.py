"""Decoder assembly (the reference's ``repro.models.transformer``) for
every architecture family: RWKV6, RG-LRU, full (``ATTN``) and local
(sliding-window) attention layers, and multi-head latent attention
(``MLA``, ``models.mla``, which the reference lacks, with its latent
cache); each RG-LRU and attention layer with
the dense gated MLP or, in a mixture-of-experts model past its leading
dense layers, the MoE FFN (``models.moe``, with arctic's dense residual
FFN beside it).  Attention caches are int8 with fp32 scales where the
config's ``kv_cache_dtype`` is ``"int8"``.  A ``patch`` frontend projects
precomputed patch embeddings and prepends them to the token stream.

Layer stacks keep the reference's organisation: ``prefix`` (unrolled
leading layers) + ``blocks`` (homogeneous pattern units whose parameters
are stacked ``[n_blocks, ...]``, so that weights carry across one to one)
+ ``tail`` (the unrolled pattern remainder, e.g. RecurrentGemma's
26 = 8·(R,R,L) + 2·R).  The reference scans the blocks with ``lax.scan``;
the port loops over the block index in Python.

Modes:
  train    — full sequence, no caches, remat per block
  prefill  — full sequence, returns per-layer caches (KV / recurrent state)
  decode   — one token against caches (``pos`` = current length)
Every mode returns the mean auxiliary (MoE load-balancing) loss beside the
hidden state and caches.

Training takes every layer kind: full and windowed attention, RWKV6 and
RG-LRU, each kernel differentiable through its own backward kernel.
Remat follows ``cfg.remat`` per block, as the reference's
``jax.checkpoint(block_body)``: ``"full"`` keeps a block's input alone,
``"dots"`` also the outputs of its plain matrix products, ``"none"``
everything.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.config.base import ATTN, LOCAL, MLA, RGLRU, RWKV, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as ML
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.parallel.sharding import EMBED, LAYERS, ParamDef
from repro_torch.spans import span
from repro_torch.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# Per-layer definitions
# ---------------------------------------------------------------------------


def _ffn_kind(cfg: ModelConfig, layer_idx: int) -> str:
    if cfg.family == "moe" and layer_idx >= cfg.first_dense_layers:
        return "moe"
    return "dense"


def _dense_ff(cfg: ModelConfig, layer_idx: int) -> int:
    if (cfg.family == "moe" and layer_idx < cfg.first_dense_layers
            and cfg.first_dense_d_ff):
        return cfg.first_dense_d_ff
    return cfg.d_ff


def layer_defs(cfg: ModelConfig, layer_idx: int) -> Dict[str, Any]:
    kind = cfg.layer_kind(layer_idx)
    d = cfg.d_model
    defs: Dict[str, Any] = {"ln1": L.rms_norm_defs(d),
                            "ln2": L.rms_norm_defs(d)}
    if kind == RWKV:
        defs["mix"] = RW.time_mix_defs(cfg)
        defs["ffn"] = RW.channel_mix_defs(cfg)
        return defs
    if kind == RGLRU:
        defs["mix"] = RG.rglru_defs(cfg)
    elif kind == MLA:
        defs["mix"] = ML.mla_defs(cfg)
    else:
        defs["mix"] = L.attention_defs(cfg)
    if _ffn_kind(cfg, layer_idx) == "moe":
        defs["ffn"] = MOE.moe_defs(cfg)
        if cfg.moe_dense_residual:
            defs["dense_res"] = L.mlp_defs(d, cfg.d_ff)
    else:
        defs["ffn"] = L.mlp_defs(d, _dense_ff(cfg, layer_idx))
    return defs


def layer_cache_defs(cfg: ModelConfig, layer_idx: int, batch: int,
                     seq: int, cache_dtype=None) -> Dict[str, Any]:
    kind = cfg.layer_kind(layer_idx)
    if kind == ATTN:
        return L.attention_cache_defs(cfg, batch, seq, cache_dtype)
    if kind == LOCAL:
        w = min(cfg.local_window or seq, seq)
        return L.attention_cache_defs(cfg, batch, w, cache_dtype)
    if kind == MLA:
        return ML.mla_cache_defs(cfg, batch, seq, cache_dtype)
    if kind == RGLRU:
        return RG.rglru_state_defs(cfg, batch)
    if kind == RWKV:
        return RW.state_defs(cfg, batch)
    raise ValueError(kind)


def _stack_defs(tree, n: int):
    return tree_map(
        lambda p: ParamDef((n,) + p.shape, (LAYERS,) + p.logical,
                           dtype=p.dtype, init=p.init,
                           init_scale=p.init_scale),
        tree)


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """How the depth dimension is organized into stacked blocks."""
    prefix: Tuple[int, ...]          # unrolled leading layer indices
    n_blocks: int                    # stacked pattern repetitions
    pattern: Tuple[str, ...]         # kinds at each position in a block
    pattern_idx: Tuple[int, ...]     # representative layer index per position
    tail: Tuple[int, ...]            # unrolled trailing layer indices


def stack_plan(cfg: ModelConfig) -> StackPlan:
    pat = len(cfg.layer_pattern)
    prefix_n = cfg.first_dense_layers
    if not cfg.scan_layers:
        return StackPlan(tuple(range(cfg.num_layers)), 0, (), (), ())
    rest = cfg.num_layers - prefix_n
    n_blocks, rem = divmod(rest, pat)
    if n_blocks <= 1:   # not worth stacking
        return StackPlan(tuple(range(cfg.num_layers)), 0, (), (), ())
    pattern_idx = tuple(prefix_n + p for p in range(pat))
    pattern = tuple(cfg.layer_kind(i) for i in pattern_idx)
    tail = tuple(prefix_n + n_blocks * pat + i for i in range(rem))
    return StackPlan(tuple(range(prefix_n)), n_blocks, pattern,
                     pattern_idx, tail)


def build_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    plan = stack_plan(cfg)
    defs: Dict[str, Any] = {
        "embed": L.embed_defs(cfg),
        "final_norm": L.rms_norm_defs(cfg.d_model),
    }
    if cfg.frontend == "patch":
        defs["frontend"] = {
            "proj": ParamDef((cfg.frontend_dim, cfg.d_model), (None, EMBED)),
        }
    defs["prefix"] = [layer_defs(cfg, i) for i in plan.prefix]
    defs["blocks"] = [_stack_defs(layer_defs(cfg, i), plan.n_blocks)
                      for i in plan.pattern_idx]
    defs["tail"] = [layer_defs(cfg, i) for i in plan.tail]
    return defs


def build_cache_defs(cfg: ModelConfig, batch: int, seq: int,
                     cache_dtype=None, *, mode: str = "prefill"
                     ) -> Dict[str, Any]:
    """Prefill caches mirror the stacked parameter layout (``blocks``);
    decode caches are flat per-layer trees (``blocks_flat``)."""
    plan = stack_plan(cfg)
    mk = lambda i: layer_cache_defs(cfg, i, batch, seq, cache_dtype)
    out = {
        "prefix": [mk(i) for i in plan.prefix],
        "tail": [mk(i) for i in plan.tail],
    }
    if mode == "decode":
        out["blocks_flat"] = [[mk(i) for i in plan.pattern_idx]
                              for _ in range(plan.n_blocks)]
    else:
        out["blocks"] = [_stack_defs(mk(i), plan.n_blocks)
                         for i in plan.pattern_idx]
    return out


def prefill_to_decode_caches(cfg: ModelConfig, caches):
    """Re-home stacked prefill caches into the flat decode layout (views
    of the stacked tensors, no copy)."""
    plan = stack_plan(cfg)
    out = {"prefix": caches["prefix"], "tail": caches["tail"],
           "blocks_flat": []}
    for bi in range(plan.n_blocks):
        out["blocks_flat"].append([
            tree_map(lambda x: x[bi], caches["blocks"][p])
            for p in range(len(plan.pattern_idx))])
    return out


# ---------------------------------------------------------------------------
# Per-layer application
# ---------------------------------------------------------------------------


def layer_apply(cfg: ModelConfig, kind: str, ffn_kind: str, params,
                x: torch.Tensor, *, positions: Optional[torch.Tensor], cache,
                mode: str, pos: Optional[int]
                ) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
    """Returns (x, new_cache, aux_loss); ``new_cache`` is None in ``train``
    mode, ``aux_loss`` the MoE layer's load-balancing loss (None for a
    dense FFN, which adds zero: no tensor is made for it)."""
    aux = None
    h = L.rms_norm(params["ln1"], x, cfg.norm_eps)
    decode = mode == "decode"

    with span("layer.mix"):
        if kind in (ATTN, LOCAL):
            window = cfg.local_window if kind == LOCAL else 0
            if decode:
                mix_out, new_cache = L.attention_decode(
                    cfg, params["mix"], h, cache, pos, window=window)
            else:
                mix_out, new_cache = L.attention_apply(
                    cfg, params["mix"], h, positions, window=window)
                s = h.shape[1]
                if mode == "train":
                    new_cache = None
                else:
                    if window and window < s:
                        # roll the sequence's tail into the circular buffer
                        slots = (torch.arange(s - window, s, device=x.device)
                                 % window)
                        rolled = {}
                        for n in ("k", "v"):
                            buf = torch.zeros_like(new_cache[n][:, :window])
                            buf[:, slots] = new_cache[n][:, -window:]
                            rolled[n] = buf
                        new_cache = rolled
                    new_cache = L.maybe_quantize_cache(cfg, new_cache)
        elif kind == MLA:
            if decode:
                mix_out, new_cache = ML.mla_decode(cfg, params["mix"], h,
                                                   cache, pos)
            else:
                mix_out, new_cache = ML.mla_apply(cfg, params["mix"], h,
                                                  positions)
                if mode == "train":
                    new_cache = None
        elif kind in (RGLRU, RWKV):
            state = cache if cache is not None else _zero_state(
                cfg, kind, x.shape[0], x.device)
            if kind == RGLRU:
                fn = RG.rglru_decode if decode else RG.rglru_apply
            else:
                fn = RW.time_mix_decode if decode else RW.time_mix_apply
            mix_out, new_cache = fn(cfg, params["mix"], h, state)
        else:
            raise ValueError(kind)
    x = x + mix_out.to(x.dtype)

    h = L.rms_norm(params["ln2"], x, cfg.norm_eps)
    with span("layer.ffn"):
        if kind == RWKV:
            ffn_out, new_cache = RW.channel_mix_apply(
                cfg, params["ffn"], h, new_cache, decode)
        elif ffn_kind == "moe":
            ffn_out, aux = MOE.moe_apply(cfg, params["ffn"], h)
            if cfg.moe_dense_residual:
                ffn_out = ffn_out + L.mlp_apply(params["dense_res"], h)
        else:
            ffn_out = L.mlp_apply(params["ffn"], h)
    return x + ffn_out.to(x.dtype), new_cache, aux


def _zero_state(cfg: ModelConfig, kind: str, batch: int,
                device: torch.device):
    defs = (RG.rglru_state_defs(cfg, batch) if kind == RGLRU
            else RW.state_defs(cfg, batch))
    return tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                          device=device), defs)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def _dots_saveable(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy (the reference's
    ``dots_with_no_batch_dims_saveable``): keep the outputs of the plain
    matrix products, recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, body):
    """``body(*args)`` checkpointed as ``cfg.remat`` asks."""
    if cfg.remat == "none":
        return body
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}: none, full or dots")
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    return lambda *args: checkpoint(body, *args, use_reentrant=False, **kw)


def _add_aux(total: torch.Tensor, aux: Optional[torch.Tensor]
             ) -> torch.Tensor:
    return total if aux is None else total + aux


def forward(cfg: ModelConfig, params, hidden: torch.Tensor, *, caches,
            mode: str, positions: Optional[torch.Tensor] = None,
            pos: Optional[int] = None):
    """hidden [B,S,D] → (hidden after the final norm, new caches (None in
    ``train`` mode), mean auxiliary loss).  The auxiliary loss is each
    layer's summed in layer order and divided by ``num_layers`` (dense
    layers add zero), as the reference's.  ``positions [S]`` are the full
    sequence's token positions, ``pos`` the decode step's (the current
    length); attention layers read them."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: train, prefill or decode")
    plan = stack_plan(cfg)
    x = hidden
    if mode == "train":
        return _train_forward(cfg, params, plan, x, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    new_prefix = []
    for j, i in enumerate(plan.prefix):
        c = None if caches is None else caches["prefix"][j]
        x, nc, aux = layer_apply(
            cfg, cfg.layer_kind(i), _ffn_kind(cfg, i), params["prefix"][j],
            x, positions=positions, cache=c, mode=mode, pos=pos)
        new_prefix.append(nc)
        aux_total = _add_aux(aux_total, aux)

    pat_ffn = tuple(_ffn_kind(cfg, i) for i in plan.pattern_idx)
    per_block = []
    for bi in range(plan.n_blocks):
        ncs = []
        for p, kind in enumerate(plan.pattern):
            bp = tree_map(lambda t: t[bi], params["blocks"][p])
            if caches is None:
                c = None
            elif mode == "decode":
                c = caches["blocks_flat"][bi][p]
            else:
                c = tree_map(lambda t: t[bi], caches["blocks"][p])
            x, nc, aux = layer_apply(cfg, kind, pat_ffn[p], bp, x,
                                     positions=positions, cache=c, mode=mode,
                                     pos=pos)
            ncs.append(nc)
            aux_total = _add_aux(aux_total, aux)
        per_block.append(ncs)

    new_tail = []
    for j, i in enumerate(plan.tail):
        c = None if caches is None else caches["tail"][j]
        x, nc, aux = layer_apply(
            cfg, cfg.layer_kind(i), _ffn_kind(cfg, i), params["tail"][j], x,
            positions=positions, cache=c, mode=mode, pos=pos)
        new_tail.append(nc)
        aux_total = _add_aux(aux_total, aux)

    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    aux_mean = aux_total / max(1, cfg.num_layers)
    if mode == "decode":
        return x, {"prefix": new_prefix, "blocks_flat": per_block,
                   "tail": new_tail}, aux_mean
    # prefill: stack each pattern position's caches over the blocks, as
    # the reference's scan does
    blocks = [tree_map(lambda *ts: torch.stack(ts),
                       *[per_block[bi][p] for bi in range(plan.n_blocks)])
              for p in range(len(plan.pattern))]
    return x, {"prefix": new_prefix, "blocks": blocks,
               "tail": new_tail}, aux_mean


def _unstack(tree, n: int) -> list:
    """A tree of stacked ``[n, ...]`` tensors as ``n`` trees of their
    blocks, each leaf split with one ``unbind``."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    out = []
    for bi in range(n):
        it = iter([u[bi] for u in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


def _train_forward(cfg: ModelConfig, params, plan: StackPlan,
                   x: torch.Tensor, positions: torch.Tensor):
    def apply(kind, ffn_kind, p, x, aux_acc):
        x, _, aux = layer_apply(cfg, kind, ffn_kind, p, x,
                                positions=positions, cache=None,
                                mode="train", pos=None)
        return x, _add_aux(aux_acc, aux)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, i in enumerate(plan.prefix):
        x, aux = apply(cfg.layer_kind(i), _ffn_kind(cfg, i),
                       params["prefix"][j], x, aux)
    # the stacked block parameters split once: the backward of unbind
    # stacks the blocks' gradients in one copy, where indexing a block
    # (t[bi]) would add a zero-filled gradient of the whole stack a block
    blocks = [_unstack(params["blocks"][p], plan.n_blocks)
              for p in range(len(plan.pattern))]
    pat_ffn = tuple(_ffn_kind(cfg, i) for i in plan.pattern_idx)
    for bi in range(plan.n_blocks):
        def block_body(x, aux, bi=bi):
            for p, kind in enumerate(plan.pattern):
                x, aux = apply(kind, pat_ffn[p], blocks[p][bi], x, aux)
            return x, aux

        x, aux = _remat(cfg, block_body)(x, aux)
    for j, i in enumerate(plan.tail):
        x, aux = apply(cfg.layer_kind(i), _ffn_kind(cfg, i),
                       params["tail"][j], x, aux)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, None, aux / max(1, cfg.num_layers)


def embed_inputs(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """tokens (+ optional patch embeddings) → hidden [B,S,D]: with a
    ``patch`` frontend, ``batch["patch_embeds"] [B, P, frontend_dim]``
    projected to the model width and prepended to the tokens' embeddings."""
    h = L.embed_apply(cfg, params["embed"], batch["tokens"], dtype)
    if cfg.frontend == "patch" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(dtype) @ params["frontend"]["proj"]
        h = torch.cat([pe, h], dim=1)
    return h
