"""Public model bundle (the reference's ``repro.models.model``): one object
per architecture exposing what the training loop and the serving engine
call.  Parameters and caches are explicit trees of tensors.

The model runs on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``, where the kernel wrappers run their plain versions;
asking for the card where there is none raises.  Random weights and
inputs come from an explicit ``torch.Generator`` on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig, ShapeConfig
from repro_torch.device import check_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import BATCH, SEQ, init_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """One model input of a cell without its data: ``struct`` a ``meta``
    tensor of its shape and dtype (the reference's ``ShapeDtypeStruct``),
    ``logical`` its logical axes."""
    struct: torch.Tensor
    logical: Tuple[Optional[str], ...]


class Model:
    """Functional model wrapper (params are explicit trees of tensors)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        if cfg.family == "subsample":
            raise ValueError(f"{cfg.name} is the platform's workload "
                             "configuration, not a model")
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
        """``tokens, labels [B, S_text]`` (+ ``patch_embeds [B, P,
        frontend_dim]``) → (loss, ``{"ce", "aux"}``): the mean next-token
        cross-entropy over the labels ``>= 0`` plus ``router_aux_weight`` ×
        the mean auxiliary loss.  With a patch frontend the text's logits
        are read from the positions ``P - 1 .. S - 2`` of the sequence with
        the patches prepended, as the reference reads them."""
        cfg = self.cfg
        h = T.embed_inputs(cfg, params, batch, self.dtype)
        s = h.shape[1]
        positions = torch.arange(s, device=h.device)
        x, _, aux = T.forward(cfg, params, h, caches=None, mode="train",
                              positions=positions)
        p = cfg.num_patches if cfg.frontend == "patch" else 0
        if p:
            x = x[:, p - 1:s - 1]
        logits = L.head_apply(cfg, params["embed"], x)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        ce = L.cross_entropy(logits, torch.clamp(labels, min=0), mask,
                             onehot=cfg.opt_onehot_ce)
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    # -- serving -------------------------------------------------------------
    def prefill(self, params, batch: Dict[str, torch.Tensor]):
        """tokens [B,S] (+ ``patch_embeds [B, P, frontend_dim]``, prepended)
        → (last-token logits [B,V] fp32, caches)."""
        cfg = self.cfg
        h = T.embed_inputs(cfg, params, batch, self.dtype)
        positions = torch.arange(h.shape[1], device=h.device)
        x, caches, _ = T.forward(cfg, params, h, caches=None, mode="prefill",
                              positions=positions)
        logits = L.head_apply(cfg, params["embed"], x[:, -1:])[:, 0]
        return logits, caches

    def decode_step(self, params, tokens: torch.Tensor, caches, pos: int):
        """tokens [B,1], ``pos`` the current length (read by attention
        layers; recurrent layers carry their state) → (logits [B,V] fp32,
        new caches)."""
        cfg = self.cfg
        h = L.embed_apply(cfg, params["embed"], tokens, self.dtype)
        x, new_caches, _ = T.forward(cfg, params, h, caches=caches,
                                  mode="decode", pos=int(pos))
        logits = L.head_apply(cfg, params["embed"], x)[:, 0]
        return logits, new_caches

    # -- inputs --------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, InputSpec]:
        """Stand-ins for every model input of this cell, the reference's
        layout: int32 ``tokens`` (and ``labels`` for training) ``[B, S -
        P]`` with ``patch_embeds [B, P, frontend_dim]`` where the model
        has a patch frontend; one token and an int32 scalar ``pos`` for
        decode."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        p = cfg.num_patches if cfg.frontend == "patch" else 0
        specs: Dict[str, InputSpec] = {}

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        def tok(name, bb, ss):
            specs[name] = InputSpec(meta((bb, ss), torch.int32),
                                    (BATCH, SEQ))

        if shape.kind in ("train", "prefill"):
            tok("tokens", b, s - p)
            if shape.kind == "train":
                tok("labels", b, s - p)
            if p:
                specs["patch_embeds"] = InputSpec(
                    meta((b, p, cfg.frontend_dim), self.dtype),
                    (BATCH, SEQ, None))
        else:  # decode: one new token against a seq_len cache
            tok("tokens", b, 1)
            specs["pos"] = InputSpec(meta((), torch.int32), ())
        return specs

    def make_inputs(self, shape: ShapeConfig, generator: torch.Generator):
        """Random inputs for one (shape) cell, drawn from ``generator`` (on
        the model's device): ``tokens [B, S]`` for prefill, ``tokens [B,
        1]`` and ``pos`` for decode.  With a patch frontend, a prefill's S
        positions are ``num_patches`` patch embeddings (``patch_embeds [B,
        P, frontend_dim]``, standard normal in the model's dtype) and S - P
        tokens, as the reference's ``input_specs`` lays them out."""
        cfg = self.cfg
        b = shape.global_batch
        vocab = max(2, cfg.vocab_size)
        p = (cfg.num_patches if cfg.frontend == "patch"
             and shape.kind != "decode" else 0)
        seq = 1 if shape.kind == "decode" else shape.seq_len - p
        out = {"tokens": torch.randint(0, vocab, (b, seq),
                                       generator=generator,
                                       device=self.device)}
        if p:
            out["patch_embeds"] = torch.randn(
                (b, p, cfg.frontend_dim), generator=generator,
                device=self.device).to(self.dtype)
        if shape.kind == "decode":
            out["pos"] = shape.seq_len - 1
        return out


def build_model(cfg: ModelConfig, *, device="cuda") -> Model:
    return Model(cfg, device=device)
