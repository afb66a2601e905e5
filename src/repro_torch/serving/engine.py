"""Batched serving engine: prefill, then greedy decode (the reference's
``repro.serving.engine``).

The port runs eagerly: there is no ``jit``, and on the card a
``torch.cuda.synchronize()`` closes each timed phase where the reference
waits with ``block_until_ready``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving.kvcache import grow_caches


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # [B, new_tokens]
    prefill_seconds: float
    decode_seconds: float
    tokens_per_second: float


class ServingEngine:
    def __init__(self, model: Model, params, *, max_new_tokens: int = 32):
        self.model = model
        self.params = params
        self.max_new_tokens = max_new_tokens

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, torch.Tensor],
                 new_tokens: Optional[int] = None) -> GenerationResult:
        """Prefill ``batch["tokens"] [B, S]`` (after ``patch_embeds [B, P,
        ...]`` where the model has a patch frontend), then decode
        ``new_tokens`` tokens by greedy argmax from position S (+ P).
        Returns the tokens and the host seconds of each phase, each closed
        by a synchronise on the card."""
        n_new = new_tokens or self.max_new_tokens
        cfg = self.model.cfg
        self._sync()
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(self.params, batch)
        prompt_len = batch["tokens"].shape[1]
        if cfg.frontend == "patch" and "patch_embeds" in batch:
            prompt_len += batch["patch_embeds"].shape[1]
        caches = grow_caches(caches, prompt_len + n_new, cfg.local_window)
        caches = self.model.prefill_to_decode(caches)
        self._sync()
        t1 = time.perf_counter()

        b = logits.shape[0]
        out = torch.zeros((b, n_new), dtype=torch.int64,
                          device=logits.device)
        tok = torch.argmax(logits, dim=-1)[:, None]
        for i in range(n_new):
            out[:, i] = tok[:, 0]
            logits, caches = self.model.decode_step(
                self.params, tok, caches, prompt_len + i)
            tok = torch.argmax(logits, dim=-1)[:, None]
        self._sync()
        t2 = time.perf_counter()
        return GenerationResult(
            tokens=out.cpu().numpy().astype(np.int32),
            prefill_seconds=t1 - t0,
            decode_seconds=t2 - t1,
            tokens_per_second=b * n_new / max(t2 - t1, 1e-9),
        )
