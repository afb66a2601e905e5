"""Nested dicts and lists of tensors: the port's counterpart of a JAX
pytree of parameters or caches.

Walks go in JAX's order, so that leaves line up one to one with the
reference's ``jax.tree.flatten``: dict keys sorted, lists and tuples in
order, ``None`` a subtree with no leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which share its structure), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: Tuple = ()
                          ) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` in JAX's flatten order; a path holds the dict keys
    and list indices from the root to the leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves_with_path(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from tree_leaves_with_path(t, path + (i,))
    else:
        yield path, tree
