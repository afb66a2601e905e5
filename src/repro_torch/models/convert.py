"""Carry the reference's parameters, caches and training state into the
port.

The reference keeps them as JAX pytrees of nested dicts, lists and named
tuples; the caller hands them over as numpy arrays (``jax.tree.map(
np.asarray, tree)``), so this module needs no JAX.  The mapping is
structure and dtype only: every leaf keeps its shape and values, bf16
stays bf16.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWState, QuantMoment
from repro_torch.parallel.sharding import tree_shapes
from repro_torch.tree import tree_map


def _to_torch(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":       # ml_dtypes' bfloat16
        t = torch.from_numpy(np.array(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(tree: Any, cfg: ModelConfig, device) -> Any:
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device``.  Raises if its structure or shapes differ from the port's
    ``build_param_defs(cfg)``."""
    want = tree_shapes(T.build_param_defs(cfg))
    got = tree_map(lambda a: tuple(np.shape(a)), tree)
    if got != want:
        raise ValueError(f"{cfg.name}: the parameter tree differs from the "
                         "port's definitions")
    return tree_map(lambda a: _to_torch(a, device), tree)


def caches_from_jax(tree: Any, device) -> Any:
    """The reference's prefill or decode caches (numpy leaves) as the
    port's, on ``device``."""
    return tree_map(lambda a: _to_torch(a, device), tree)


def _moments_from_jax(tree: Any, device) -> Any:
    """A moment tree: dicts and lists of arrays, or of the reference's
    ``QuantMoment`` records (fields ``q, scale, mode``)."""
    if isinstance(tree, dict):
        return {k: _moments_from_jax(v, device) for k, v in tree.items()}
    if getattr(tree, "_fields", None) == QuantMoment._fields:
        return QuantMoment(*(_to_torch(a, device) for a in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_moments_from_jax(t, device) for t in tree)
    return _to_torch(tree, device)


def train_state_from_jax(state: Any, cfg: ModelConfig, device) -> Any:
    """The reference's ``TrainState`` (numpy leaves: ``params``, ``opt``
    with ``count``, ``mu`` and ``nu`` (``QuantMoment`` records for int8
    moments), ``error_feedback`` or None, ``step``) as the port's
    ``train.TrainState`` on ``device``, so that both start a step from the
    same state."""
    from repro_torch.train.loop import TrainState

    params = params_from_jax(state.params, cfg, device)
    opt = AdamWState(_to_torch(state.opt.count, device),
                     _moments_from_jax(state.opt.mu, device),
                     _moments_from_jax(state.opt.nu, device))
    ef = (None if state.error_feedback is None
          else tree_map(lambda a: _to_torch(a, device),
                        state.error_feedback))
    return TrainState(params, opt, ef, _to_torch(state.step, device))
