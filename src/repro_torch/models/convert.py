"""Carry the reference's parameters and caches into the port.

The reference keeps them as JAX pytrees of nested dicts and lists; the
caller hands them over as numpy arrays (``jax.tree.map(np.asarray,
tree)``), so this module needs no JAX.  The mapping is structure and dtype
only: every leaf keeps its shape and values, bf16 stays bf16.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import transformer as T
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
