"""Weights made by the benchmark from the run's seed, the same for the
program and for the plain reference.

A leaf is named by its path in the program's parameter tree
(``blocks/0/mix/wr``); :func:`leaf_specs` lists each leaf's path, shape,
type and initialiser from the model's parameter definitions.  :func:`make`
draws every normal leaf of one type with one call into one flat buffer on
the device (each leaf a view of it), so that set-up spends milliseconds
and not a launch a leaf; the same seed, specs and device give the same
values, which is how the reference gets them again after the program's
state is freed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    path: str
    shape: tuple
    dtype: torch.dtype
    init: str                       # normal | zeros | ones
    scale: float


def _walk(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaf_specs(defs: Any, default_dtype: torch.dtype) -> List[LeafSpec]:
    """Each leaf of a tree of parameter definitions (anything with
    ``shape``, ``dtype``, ``init`` and ``init_scale``), in path order."""
    return [LeafSpec(path, tuple(d.shape), d.dtype or default_dtype,
                     d.init, float(d.init_scale))
            for path, d in _walk(defs)]


def make(specs: List[LeafSpec], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``specs`` on ``device``: normal leaves N(0, scale²)
    drawn in their own type by one call a type from a generator seeded
    with ``seed``; zeros and ones as named."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    by_type: Dict[tuple, List[LeafSpec]] = {}
    for s in specs:
        if s.init == "zeros":
            out[s.path] = torch.zeros(s.shape, dtype=s.dtype, device=device)
        elif s.init == "ones":
            out[s.path] = torch.ones(s.shape, dtype=s.dtype, device=device)
        elif s.init == "normal":
            by_type.setdefault((s.dtype, s.scale), []).append(s)
        else:
            raise ValueError(f"{s.path}: initialiser {s.init!r}")
    for (dtype, scale), group in sorted(by_type.items(),
                                        key=lambda kv: str(kv[0])):
        total = sum(_numel(s.shape) for s in group)
        flat = torch.empty(total, dtype=dtype, device=device)
        flat.normal_(0.0, scale, generator=gen)
        at = 0
        for s in group:
            n = _numel(s.shape)
            out[s.path] = flat[at:at + n].view(s.shape)
            at += n
    return out


def build_tree(defs: Any, leaves: Dict[str, torch.Tensor]) -> Any:
    """The program's parameter tree: ``defs``' structure with each leaf
    taken from ``leaves`` by its path."""
    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(tree[k], f"{prefix}{k}/") for k in sorted(tree)}
        if isinstance(tree, list):
            return [build(t, f"{prefix}{i}/") for i, t in enumerate(tree)]
        if isinstance(tree, tuple):
            return tuple(build(t, f"{prefix}{i}/") for i, t in enumerate(tree))
        return leaves[prefix[:-1]]
    return build(defs, "")


def flatten(tree: Any) -> Dict[str, torch.Tensor]:
    """A tree of tensors (the program's parameters) by path."""
    return dict(_walk(tree))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
