"""Int8 gradient compression with error feedback (the reference's
``repro.parallel.compression``).

Gradients are quantized to int8 (per-row absmax) and dequantized, which is
what the receiving end of an int8 all-reduce sees; the residual is carried
in an error-feedback buffer and added to the next step's gradient.  The
scale divides by a tensor on the gradient's device: PyTorch's CUDA
division by a Python number multiplies by its fp32 reciprocal and can
part from the reference's division by one ulp.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` → (int8 values in x's shape, fp32 scales ``[rows, 1]``), one
    absmax scale a row of ``x`` flattened to ``[x.shape[0], -1]``."""
    flat = x.reshape(x.shape[0], -1) if x.dim() > 1 else x.reshape(1, -1)
    absmax = torch.clamp(torch.amax(torch.abs(flat), dim=-1, keepdim=True),
                         min=1e-12)
    scale = absmax / absmax.new_full((), 127.0)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    flat = q.reshape(q.shape[0], -1) if q.dim() > 1 else q.reshape(1, -1)
    return (flat.float() * scale).reshape(shape)


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads, error_feedback):
    """Returns (the grads quantized and dequantized, the new error
    feedback: what the round trip lost)."""
    def one(g, e):
        g = g.float() + e
        q, s = quantize_int8(g)
        gq = dequantize_int8(q, s, g.shape)
        return gq, g - gq

    outs = [one(g, e) for g, e in zip(tree_leaves(grads),
                                       tree_leaves(error_feedback))]
    it_g = iter([o[0] for o in outs])
    it_e = iter([o[1] for o in outs])
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_e), grads))
