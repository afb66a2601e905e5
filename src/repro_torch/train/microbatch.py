"""Gradient accumulation over kneepoint-sized microbatches (the
reference's ``repro.train.microbatch``).

The global batch is split into ``n_mb`` tiny tasks run back to back, each
microbatch's activations at the kneepoint
(``ModelConfig.microbatch_tokens_per_device``); the reference's
``lax.scan`` is a Python loop here.  Gradients come from
``torch.autograd.grad`` of the loss and are summed in ``accum_dtype`` in
microbatch order (in place in the accumulator, which the caller never
sees), then multiplied by ``1 / n_mb``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.spans import span
from repro_torch.tree import tree_leaves, tree_map


def split_microbatches(batch: Dict[str, torch.Tensor], n_mb: int
                       ) -> Dict[str, torch.Tensor]:
    """[B, ...] → [n_mb, B/n_mb, ...] on every leaf."""
    def split(x):
        b = x.shape[0]
        if b % n_mb:
            raise ValueError(f"a batch of {b} does not split into {n_mb} "
                             "microbatches")
        return x.reshape(n_mb, b // n_mb, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params: Any,
                   batch: Dict[str, torch.Tensor]):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``, the
    grads a tree like ``params`` in their types (``jax.value_and_grad``
    with ``has_aux``)."""
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(ps)
        loss, metrics = loss_fn(ps, batch)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(it), params))


def accumulate_gradients(
    loss_fn: Callable[[Any, Dict[str, torch.Tensor]], Tuple[torch.Tensor,
                                                             Dict]],
    params: Any,
    batch: Dict[str, torch.Tensor],
    n_mb: int,
    accum_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """Mean loss, metrics and grads over ``n_mb`` sequential
    microbatches."""
    if n_mb <= 1:
        with span("train.microbatch"):
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        return loss, metrics, grads

    mbs = split_microbatches(batch, n_mb)
    device = tree_leaves(params)[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    metrics_acc = {"ce": torch.zeros((), dtype=torch.float32, device=device),
                   "aux": torch.zeros((), dtype=torch.float32, device=device)}
    grads_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                               device=p.device), params)
    for i in range(n_mb):
        with span("train.microbatch"):
            mb = {k: v[i] for k, v in mbs.items()}
            (loss, metrics), grads = value_and_grad(loss_fn, params, mb)
            for a, g in zip(tree_leaves(grads_acc), tree_leaves(grads)):
                a.add_(g.to(a.dtype))
            del grads
            metrics_acc = {k: metrics_acc[k] + metrics[k]
                           for k in metrics_acc}
            loss_acc = loss_acc + loss
    inv = 1.0 / n_mb
    for a in tree_leaves(grads_acc):
        a.mul_(inv)
    return (loss_acc * inv, {k: m * inv for k, m in metrics_acc.items()},
            grads_acc)
