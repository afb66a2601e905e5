"""Logical-axis sharding rules, parameter definitions, and the wave
mesh's placement (the reference's ``repro.parallel.sharding``).

Every parameter and activation of the model zoo is annotated with
*logical* axis names; a rule table maps them to physical mesh axes.  Two
presets, the reference's:

* ``TRAIN_RULES`` — FSDP (ZeRO-3) + TP: parameter ``embed`` dims over the
  ``data`` axis, feature dims over ``model``, batch over ``("pod",
  "data")``.
* ``SERVE_RULES`` — TP only: parameters replicated over ``data``, feature
  dims over ``model``, the KV cache sequence-sharded over ``model``.

Divisibility fallback: where a dimension does not divide by the product
of its mesh axes, the axis tuple is trimmed from the end until it does,
and the dimension is replicated where nothing is left.

A spec is a tuple with one entry a dimension, ``None``, an axis name or a
tuple of names (``logical_to_spec`` strips trailing ``None`` entries):
the reference's ``PartitionSpec`` as plain data.  A mesh is any object with
``axis_names`` and a ``shape`` mapping from axis name to size
(``repro_torch.launch.mesh.Mesh``, or the tests' ``FakeMesh``).  The port
runs on one card, so the rules place nothing: the dry run
(``repro_torch.launch.dryrun``) reads them to size each leaf on a
production mesh, as the reference's lowering does.

:func:`wave_sharding` is the platform's placement over a wave mesh
(``repro_torch.launch.mesh``): the reference's ``NamedSharding(mesh,
P("wave"))``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.tree import tree_leaves, tree_map

AxisVal = Union[None, str, Tuple[str, ...]]

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

TRAIN_RULES: Mapping[str, AxisVal] = {
    BATCH: ("pod", "data"),
    SEQ: None,
    EMBED: ("data", "pod"),     # ZeRO-3 spans pods on the multi-pod mesh
    VOCAB: "model",
    HEADS: "model",
    EXPERT: "model",
    KV_SEQ: None,
    LAYERS: None,
    REPL: None,
}


def serve_rules(cfg) -> Mapping[str, AxisVal]:
    """Serve-time rules; archs too big to replicate over ``data`` (arctic)
    keep FSDP sharding on embed dims and gather weights per layer."""
    if getattr(cfg, "serve_shard_embed", False):
        return dict(SERVE_RULES, **{EMBED: "data"})
    return SERVE_RULES


SERVE_RULES: Mapping[str, AxisVal] = {
    BATCH: ("pod", "data"),
    SEQ: None,
    EMBED: None,           # no optimizer → replicate over data
    VOCAB: "model",
    HEADS: "model",
    EXPERT: "model",
    KV_SEQ: "model",       # sequence-sharded KV cache (flash-decoding)
    LAYERS: None,
    REPL: None,
}


def _resolve(axis: AxisVal, mesh) -> Tuple[str, ...]:
    """Drop mesh axes that don't exist (e.g. 'pod' on the single-pod mesh)."""
    if axis is None:
        return ()
    if isinstance(axis, str):
        axis = (axis,)
    return tuple(a for a in axis if a in mesh.axis_names)


def _axis_size(axes: Tuple[str, ...], mesh) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _trim(axes: Tuple[str, ...], dim: int, mesh) -> Tuple[str, ...]:
    """The divisibility fallback: ``axes`` trimmed from the end until
    ``dim`` divides by their product (nothing left: replicated)."""
    while axes and dim % _axis_size(axes, mesh):
        axes = axes[:-1]
    return axes


def _entry(axes: Tuple[str, ...]) -> AxisVal:
    """A spec entry: one axis bare, several as a tuple, none ``None``."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def logical_to_spec(logical: Sequence[Optional[str]], mesh,
                    rules: Mapping[str, AxisVal],
                    shape: Optional[Sequence[int]] = None) -> tuple:
    """A tuple of logical axis names as a spec tuple.

    ``shape`` (if given) enables the divisibility fallback per dimension.
    """
    parts: List[AxisVal] = []
    for i, name in enumerate(logical):
        axes = () if name is None else _resolve(rules.get(name), mesh)
        if shape is not None:
            axes = _trim(axes, shape[i], mesh)
        parts.append(_entry(axes))
    # strip trailing Nones for tidier specs
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``jax.sharding.NamedSharding``
    as data."""
    mesh: Any
    spec: tuple

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of the block each device holds (every sharded
        dimension divides, by the fallback)."""
        out = list(shape)
        for i, part in enumerate(self.spec):
            if part is not None:
                axes = (part,) if isinstance(part, str) else part
                out[i] //= _axis_size(axes, self.mesh)
        return tuple(out)


def named_sharding(logical: Sequence[Optional[str]], mesh,
                   rules: Mapping[str, AxisVal],
                   shape: Optional[Sequence[int]] = None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical, mesh, rules, shape))


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


def tree_shape_structs(tree, default_dtype: torch.dtype) -> Any:
    """A ParamDef tree as ``meta`` tensors of each leaf's shape and dtype
    (``default_dtype`` where the leaf names none): no storage, the
    reference's ``ShapeDtypeStruct`` stand-ins, which the port's ops run
    on to count and size a step without a card."""
    return tree_map(lambda p: torch.empty(p.shape,
                                          dtype=p.dtype or default_dtype,
                                          device="meta"), tree)


def tree_shardings(tree, mesh, rules: Mapping[str, AxisVal]) -> Any:
    return tree_map(lambda p: named_sharding(p.logical, mesh, rules,
                                             p.shape), tree)


def tree_specs(tree, mesh, rules: Mapping[str, AxisVal]) -> Any:
    return tree_map(lambda p: logical_to_spec(p.logical, mesh, rules,
                                              p.shape), tree)


def param_count(tree) -> int:
    return int(sum(int(np.prod(p.shape)) for p in tree_leaves(tree)))


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


class hint_mesh:
    """Context manager making :func:`hint` active: inside it, each hint
    resolves the spec the reference's ``with_sharding_constraint`` would
    pin on that mesh and records it in :attr:`pins` as ``(shape,
    spec)``.  The dry run enters it around a step on ``meta`` tensors;
    nothing else does, so hints are the identity there."""

    _active: List["hint_mesh"] = []

    def __init__(self, mesh):
        self.mesh = mesh
        self.pins: List[Tuple[Tuple[int, ...], tuple]] = []

    def __enter__(self):
        hint_mesh._active.append(self)
        return self

    def __exit__(self, *exc):
        hint_mesh._active.remove(self)
        return False


def hint(x: Any, *axes: AxisVal) -> Any:
    """The reference's best-effort sharding constraint on an intermediate
    tensor: ``x`` itself outside :class:`hint_mesh`; inside, the given
    mesh axes a dimension, with the same divisibility fallback as
    parameter shardings, recorded on the innermost context.  The port's
    single-card arithmetic is the same either way."""
    if not hint_mesh._active:
        return x
    ctx = hint_mesh._active[-1]
    spec = []
    for i, a in enumerate(axes):
        cand = (a,) if isinstance(a, str) else tuple(a or ())
        cand = tuple(c for c in cand if c in ctx.mesh.axis_names)
        spec.append(_entry(_trim(cand, x.shape[i], ctx.mesh)))
    ctx.pins.append((tuple(x.shape), tuple(spec)))
    return x
