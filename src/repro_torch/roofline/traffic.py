"""Analytic HBM-traffic model (per-device bytes per step), the reference's
``repro.roofline.traffic`` unchanged in its arithmetic.

Why this exists: neither a compiled artifact's byte count (the
reference's XLA CPU module, which materializes every dtype convert) nor
the port's count of each eager op's inputs and outputs (``launch.dryrun``,
no fusion) is the traffic a fused step moves; the memory roofline term
comes from this explicit, documented model, and the dry run reports the
counted bytes beside it.

Model (per device, bf16 params/activations, fp32 accumulations):

  train step   n_mb·[ param all-gather (P/tp)·2·2  +  grad (P/tp)·4·2 ]
               + optimizer (P/chips)·(8 + moment_rw)
               + n_mb·activation_traffic + n_mb·logit_traffic
  prefill      params (P/tp)·2 + activation_traffic + cache write
  decode       params min(P, B·P_active)/tp·2 + cache read/write + logits

  activation_traffic per layer ≈ r·t_dev·(2·d + 2·ff_eff)·2B, with
  r = 3 for train (forward + backward + per-layer remat recompute),
  r = 1 for inference; ff_eff = d_ff (dense) or top-k·moe_d_ff + shared
  (+ dense residual) for MoE.  Flash-blocked attention adds no O(S²) HBM
  term (scores stay on chip); the KV read is the cache term.
"""

from __future__ import annotations

from repro_torch.config.base import (ATTN, LOCAL, MLA, RGLRU, RWKV, MeshConfig,
                                     ModelConfig, ShapeConfig, TrainConfig)
from repro_torch.roofline.analysis import CellCost

_MOMENT_RW = {"float32": 16.0, "bfloat16": 8.0, "int8": 4.0}


def _ff_eff(cfg: ModelConfig, layer_idx: int) -> float:
    if cfg.family == "moe" and layer_idx >= cfg.first_dense_layers:
        ff = cfg.moe_top_k * cfg.moe_d_ff
        ff += cfg.num_shared_experts * cfg.moe_d_ff
        if cfg.moe_dense_residual:
            ff += cfg.d_ff
        return ff
    if cfg.family == "moe" and cfg.first_dense_d_ff:
        return cfg.first_dense_d_ff
    return cfg.d_ff


def _cache_bytes_per_chip(cfg: ModelConfig, batch: int, seq: int,
                          chips: int) -> float:
    """Total KV/state cache bytes divided across chips."""
    # int8 cache: 1 byte/elem + fp32 scale per (pos, kv-head) ≈ 1.03×
    kvb = 1.03 if cfg.kv_cache_dtype == "int8" else 2.0
    total = 0.0
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == ATTN:
            total += batch * seq * cfg.kv_dim * 2 * kvb
        elif kind == LOCAL:
            total += batch * min(cfg.local_window, seq) * cfg.kv_dim * 2 * kvb
        elif kind == RGLRU:
            total += batch * cfg.lru_dim * 4 + batch * 3 * cfg.lru_dim * 4
        elif kind == RWKV:
            total += batch * cfg.d_model * cfg.rwkv_head_dim * 4
        elif kind == MLA:                      # the latent and roped key
            total += batch * seq * (cfg.kv_lora_rank
                                    + cfg.qk_rope_head_dim) * 2
    return total / chips


def memory_traffic(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshConfig,
                   *, n_mb: int = 1,
                   tcfg: TrainConfig = TrainConfig()) -> float:
    """Per-device HBM bytes for one step of this cell."""
    p = float(cfg.param_count())
    p_active = float(cfg.active_param_count())
    tp = mesh.tp_size
    dp = mesh.dp_size
    chips = mesh.num_devices
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        t_dev = b * s / dp / n_mb                       # tokens/mb/device
        act = sum(3.0 * t_dev * (2 * cfg.d_model + 2 * _ff_eff(cfg, i)) * 2
                  for i in range(cfg.num_layers))
        logits = t_dev * cfg.vocab_size / tp * 4 * 3
        params_ag = (p / tp) * 2 * 2                    # ag write + read
        grads = (p / tp) * 4 * 2
        opt = (p / chips) * (8.0 + _MOMENT_RW[tcfg.moment_dtype])
        return n_mb * (params_ag + grads + act + logits) + opt

    if shape.kind == "prefill":
        t_dev = b * s / dp
        act = sum(1.0 * t_dev * (2 * cfg.d_model + 2 * _ff_eff(cfg, i)) * 2
                  for i in range(cfg.num_layers))
        cache_w = _cache_bytes_per_chip(cfg, b, s, chips)
        return (p / tp) * 2 + act + cache_w

    # decode: the full cache is read once; the write is one position
    params = min(p, b * p_active) / tp * 2
    cache_rw = 1.02 * _cache_bytes_per_chip(cfg, b, s, chips)
    t_dev = max(1.0, b / dp)
    act = sum(1.0 * t_dev * (2 * cfg.d_model + 2 * _ff_eff(cfg, i)) * 2
              for i in range(cfg.num_layers))
    logits = t_dev * cfg.vocab_size / tp * 4
    return params + cache_rw + act + logits


def cost_with_model_memory(cost: CellCost, model_bytes: float) -> CellCost:
    """Swap the counted bytes for the analytic traffic model."""
    return CellCost(cost.flops, model_bytes, cost.coll_bytes, cost.coll_ops)
