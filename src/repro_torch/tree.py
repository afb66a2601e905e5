"""Nested dicts and lists of tensors: the port's counterpart of a JAX
pytree of parameters or caches.

Walks go in JAX's order, so that leaves line up one to one with the
reference's ``jax.tree.flatten``: dict keys sorted, lists, tuples and
named tuples (the training state's records) in order, ``None`` a subtree
with no leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple


@dataclasses.dataclass(frozen=True)
class AttrKey:
    """A named tuple's field on a leaf's path (JAX's ``GetAttrKey``)."""
    name: str


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which share its structure), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: Tuple = ()
                          ) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` in JAX's flatten order; a path holds the dict keys,
    list indices and named-tuple fields (:class:`AttrKey`) from the root to
    the leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves_with_path(tree[key], path + (key,))
    elif _is_namedtuple(tree):
        for name, t in zip(type(tree)._fields, tree):
            yield from tree_leaves_with_path(t, path + (AttrKey(name),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_leaves_with_path(t, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
