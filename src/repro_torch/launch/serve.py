"""Serving launcher: batched prefill and greedy decode of one model with
random weights made from a seed, on the card unless ``--device cpu``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --reduced --device cpu --batch 2 --prompt-len 24 --new-tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --batch 4 --prompt-len 1000 --new-tokens 32      # full width, on an H100
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --reduced --device cpu --batch 2 --prompt-len 24 --new-tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --batch 4 --prompt-len 4064 --new-tokens 32      # int8 KV cache, H100

Every config but the mixture-of-experts and patch-frontend ones serves:
``rwkv6-7b``, ``recurrentgemma-2b`` and the dense decoders (full
attention; ``deepseek-7b`` with the reference's int8 KV cache).  Weights
are drawn at full width, so a model whose bf16 weights pass one card's
memory (``qwen2-72b`` and ``deepseek-67b`` on an 80 GB card) needs
``--reduced``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Optional, Sequence

logger = logging.getLogger(__name__)


def reduced_variant(cfg):
    """A small config of the same family and structure (the reference's
    ``repro.launch.train.reduced_variant``)."""
    small = dict(
        num_layers=min(cfg.num_layers, 4), d_model=128, d_ff=256,
        vocab_size=1024, chunk_len=16, microbatch_tokens_per_device=256)
    if cfg.num_heads:
        small.update(num_heads=4,
                     num_kv_heads=(4 if cfg.num_kv_heads == cfg.num_heads
                                   else 2),
                     head_dim=32)
    if cfg.family == "moe":
        small.update(num_experts=8, moe_top_k=min(cfg.moe_top_k, 2),
                     moe_d_ff=64, moe_seq_chunk=0)
        if cfg.first_dense_layers:
            small.update(first_dense_d_ff=256)
    if cfg.frontend == "patch":
        small.update(num_patches=4, frontend_dim=16)
    if cfg.local_window:
        small.update(local_window=16)
    if cfg.lru_width:
        small.update(lru_width=128)
    pat = len(cfg.layer_pattern)
    small["num_layers"] = cfg.first_dense_layers + 2 * pat
    return dataclasses.replace(cfg, **small)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_variant(cfg)
    model = build_model(cfg, device=args.device)
    logger.info("serving %s (%.1fM params) on %s", cfg.name,
                cfg.param_count() / 1e6, model.device)

    params = model.init(model.generator(args.seed))
    engine = ServingEngine(model, params, max_new_tokens=args.new_tokens)
    shape = ShapeConfig("serve", "prefill", args.prompt_len, args.batch)
    batch = model.make_inputs(shape, model.generator(args.seed + 1))
    out = engine.generate(batch, new_tokens=args.new_tokens)
    logger.info("prefill %.1f ms, decode %.1f ms, %.0f tok/s",
                out.prefill_seconds * 1e3, out.decode_seconds * 1e3,
                out.tokens_per_second)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
