"""Training launcher: a model with random weights made from the run's
seed, trained on the subsampling input pipeline with microbatches, AdamW
and optional job-level checkpoints, on the card unless ``--device cpu``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \
      --reduced --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \
      --batch 8 --seq 2048 --steps 5      # all 48 layers, one H100
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b \
      --reduced --device cpu --steps 3

Every config trains: the dense decoders (``musicgen-medium``,
``deepseek-7b``, ``internlm2-20b``, ...), the mixture-of-experts models
(``deepseek-moe-16b``, ``arctic-480b``), ``llava-next-34b``, whose batches
carry zero patch embeddings before the ``--seq`` text tokens, as the
reference's launcher gives them, and the recurrent models ``rwkv6-7b``
(RWKV6 layers, through ``rwkv6_chunked``'s backward kernel) and
``recurrentgemma-2b`` (RG-LRU layers and windowed attention, through the
backward kernels of ``rglru_scan`` and ``flash_attention``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \
      --batch 4 --seq 4096 --steps 3     # all 26 layers, one H100

``--dry-run`` trains nothing: it runs the dry run
(``repro_torch.launch.dryrun``) for ``--arch`` at ``train_4k`` on the
single-pod mesh, on ``meta`` tensors (no card needed), and returns its
cell:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b --dry-run
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Sequence

logger = logging.getLogger(__name__)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="run a reduced same-family config")
    ap.add_argument("--dry-run", action="store_true",
                    help="count and size the full config's train_4k step "
                         "on the single-pod mesh (repro_torch.launch."
                         "dryrun); trains nothing")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    if args.dry_run:
        from repro_torch.launch import dryrun
        return dryrun.run_cell(args.arch, "train_4k", "single")

    import numpy as np

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import (MeshConfig, RunConfig, ShapeConfig,
                                    TrainConfig, get_config)
    from repro_torch.data import (PipelineConfig, SubsamplingBatchPipeline,
                                  lm_token_corpus)
    from repro_torch.launch.serve import reduced_variant
    from repro_torch.models.model import build_model
    from repro_torch.train import train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_variant(cfg)
    model = build_model(cfg, device=args.device)
    logger.info("arch=%s params=%.1fM device=%s", cfg.name,
                cfg.param_count() / 1e6, model.device)

    p = cfg.num_patches if cfg.frontend == "patch" else 0
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("train", "train", args.seq + p, args.batch),
        mesh=MeshConfig((1, 1), ("data", "model")),
        train=TrainConfig(total_steps=args.steps))

    corpus = lm_token_corpus(1 << 18, cfg.vocab_size, shard_tokens=1 << 14)
    pipe = SubsamplingBatchPipeline(
        corpus, PipelineConfig(batch_size=args.batch, seq_len=args.seq))

    def batches():
        for b in pipe.batches(None):
            if p:
                b["patch_embeds"] = np.zeros(
                    (args.batch, p, cfg.frontend_dim), np.float32)
            yield b

    mgr = (CheckpointManager(args.ckpt_dir, keep=2)
           if args.ckpt_dir else None)
    report = train(model, run, batches(), num_steps=args.steps,
                   checkpoint_manager=mgr, log_every=10)
    logger.info("done: %d steps, loss %.3f → %.3f, %.1fs",
                report.steps,
                report.losses[0] if report.losses else float("nan"),
                report.final_loss, report.seconds)
    return report


if __name__ == "__main__":
    main()
