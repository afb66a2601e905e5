"""Public model bundle (the reference's ``repro.models.model``): one object
per architecture exposing what the training loop and the serving engine
call.  Parameters and caches are explicit trees of tensors.

The model runs on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``, where the kernel wrappers run their plain versions;
asking for the card where there is none raises.  Random weights and
inputs come from an explicit ``torch.Generator`` on the model's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.device import check_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import init_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Model:
    """Functional model wrapper (params are explicit trees of tensors)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        if cfg.family == "subsample":
            raise ValueError(f"{cfg.name} is the platform's workload "
                             "configuration, not a model")
        T.check_supported(cfg)
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.device = check_device(device)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the model's device, seeded with ``seed``."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- parameters ----------------------------------------------------------
    def param_defs(self) -> Dict[str, Any]:
        return T.build_param_defs(self.cfg)

    def init(self, generator: torch.Generator,
             param_dtype: Optional[torch.dtype] = None):
        """Random parameters drawn from ``generator`` (on the model's
        device), in the model's dtype unless ``param_dtype`` is given."""
        return init_params(self.param_defs(), param_dtype or self.dtype,
                           self.device, generator)

    def cache_defs(self, batch: int, seq: int, cache_dtype=None,
                   mode: str = "decode"):
        return T.build_cache_defs(self.cfg, batch, seq,
                                  cache_dtype or self.dtype, mode=mode)

    def init_cache(self, batch: int, seq: int, cache_dtype=None,
                   mode: str = "decode"):
        return init_params(
            self.cache_defs(batch, seq, cache_dtype, mode=mode),
            cache_dtype or self.dtype, self.device, self.generator(0))

    def prefill_to_decode(self, caches):
        return T.prefill_to_decode_caches(self.cfg, caches)

    # -- training ------------------------------------------------------------
    def loss(self, params, batch: Dict[str, torch.Tensor]):
        """``tokens, labels [B, S]`` → (loss, ``{"ce", "aux"}``): the mean
        next-token cross-entropy over the labels ``>= 0`` plus
        ``router_aux_weight`` × the mean auxiliary loss."""
        cfg = self.cfg
        h = T.embed_inputs(cfg, params, batch, self.dtype)
        positions = torch.arange(h.shape[1], device=h.device)
        x, _, aux = T.forward(cfg, params, h, caches=None, mode="train",
                              positions=positions)
        logits = L.head_apply(cfg, params["embed"], x)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        ce = L.cross_entropy(logits, torch.clamp(labels, min=0), mask,
                             onehot=cfg.opt_onehot_ce)
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    # -- serving -------------------------------------------------------------
    def prefill(self, params, batch: Dict[str, torch.Tensor]):
        """tokens [B,S] → (last-token logits [B,V] fp32, caches)."""
        cfg = self.cfg
        h = T.embed_inputs(cfg, params, batch, self.dtype)
        positions = torch.arange(h.shape[1], device=h.device)
        x, caches = T.forward(cfg, params, h, caches=None, mode="prefill",
                              positions=positions)
        logits = L.head_apply(cfg, params["embed"], x[:, -1:])[:, 0]
        return logits, caches

    def decode_step(self, params, tokens: torch.Tensor, caches, pos: int):
        """tokens [B,1], ``pos`` the current length (read by attention
        layers; recurrent layers carry their state) → (logits [B,V] fp32,
        new caches)."""
        cfg = self.cfg
        h = L.embed_apply(cfg, params["embed"], tokens, self.dtype)
        x, new_caches = T.forward(cfg, params, h, caches=caches,
                                  mode="decode", pos=int(pos))
        logits = L.head_apply(cfg, params["embed"], x)[:, 0]
        return logits, new_caches

    # -- inputs --------------------------------------------------------------
    def make_inputs(self, shape: ShapeConfig, generator: torch.Generator):
        """Random token inputs for one (shape) cell, drawn from
        ``generator`` (on the model's device): ``tokens [B, S]`` for
        prefill, ``tokens [B, 1]`` and ``pos`` for decode."""
        b = shape.global_batch
        vocab = max(2, self.cfg.vocab_size)
        seq = 1 if shape.kind == "decode" else shape.seq_len
        out = {"tokens": torch.randint(0, vocab, (b, seq),
                                       generator=generator,
                                       device=self.device)}
        if shape.kind == "decode":
            out["pos"] = shape.seq_len - 1
        return out


def build_model(cfg: ModelConfig, *, device="cuda") -> Model:
    return Model(cfg, device=device)
