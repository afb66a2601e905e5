"""Parameter definitions, and the wave mesh's placement.

A tree of :class:`ParamDef` describes every parameter and cache leaf of a
model: shape, logical axis names, dtype and initializer, as in the
reference's ``repro.parallel.sharding``.  The logical names are kept so
that the trees compare one to one with the reference's; the mesh rules
that map them onto devices wait for the port's training loop.

:func:`wave_sharding` is the platform's placement over a wave mesh
(``repro_torch.launch.mesh``): the reference's ``NamedSharding(mesh,
P("wave"))``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.tree import tree_map

# -- logical axis names ------------------------------------------------------
BATCH = "batch"          # activation batch
SEQ = "seq"              # activation sequence
EMBED = "embed"          # d_model dim of params (FSDP target)
VOCAB = "vocab"          # vocab dim of embeddings / lm head
HEADS = "heads"          # flattened q/kv head dims, ff dims, lru width
EXPERT = "expert"        # MoE expert dim
KV_SEQ = "kv_seq"        # KV-cache sequence dim (serve: sharded over model)
LAYERS = "layers"        # stacked-layer leading dim (scan-over-layers)
REPL = "repl"            # always replicated


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: Any = None                      # a torch dtype; None: the model's
    init: str = "normal"                   # normal | zeros | ones
    init_scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_param_def(x) -> bool:
    return isinstance(x, ParamDef)


def init_params(defs, dtype: torch.dtype, device: torch.device,
                generator: torch.Generator) -> Any:
    """Materialize a ParamDef tree on ``device``: ``normal × init_scale``,
    zeros or ones per leaf, drawn in fp32 from ``generator`` (which lives
    on ``device``) leaf after leaf in JAX's flatten order, then cast to the
    leaf's dtype (``dtype`` where the leaf names none)."""
    def make(p: ParamDef) -> torch.Tensor:
        leaf_dtype = p.dtype or dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=leaf_dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=leaf_dtype, device=device)
        t = torch.empty(p.shape, dtype=torch.float32, device=device)
        return t.normal_(generator=generator).mul_(p.init_scale).to(leaf_dtype)

    return tree_map(make, defs)


def tree_shapes(tree) -> Any:
    """The shape of every leaf (a ParamDef's or a tensor's) as a tuple."""
    return tree_map(lambda x: tuple(x.shape), tree)


@dataclasses.dataclass(frozen=True)
class WaveSharding:
    """A leading axis split over a wave mesh: a device-major ``[n_dev *
    per_dev, ...]`` array becomes ``n_dev`` contiguous blocks, block ``d``
    one tensor on the mesh's entry ``d``."""

    mesh: Any

    def place(self, array: np.ndarray) -> List[torch.Tensor]:
        n_dev = self.mesh.n_dev
        if array.shape[0] % n_dev:
            raise ValueError(f"a leading axis of {array.shape[0]} does not "
                             f"split over {n_dev} devices")
        per_dev = array.shape[0] // n_dev
        host = torch.from_numpy(np.ascontiguousarray(array))
        return [host[d * per_dev:(d + 1) * per_dev].to(device)
                for d, device in enumerate(self.mesh.devices)]


def wave_sharding(mesh) -> WaveSharding:
    """Leading-axis placement over the platform's wave mesh
    (``launch.mesh.make_wave_mesh``): the arena's task axis — one
    contiguous block a device."""
    return WaveSharding(mesh)
