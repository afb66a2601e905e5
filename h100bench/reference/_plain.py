"""Pieces the plain references share: matrix products at a stated
precision, RMS norm, cross-entropy and AdamW.

Plain PyTorch in float32 with TF32 off: no kernel, cache or batching of
the program's, and nothing imported from it.  ``Products("fp8")`` is the
control's precision: every operand of a matrix product (and, in a
backward, the incoming gradient) rounded to float8 e4m3 under one absmax
scale a tensor, the products summed in float32, as fp8 training and
serving on Hopper's tensor cores compute them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """float32 products with TF32 off, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one absmax scale, as float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g)
        ga = qg @ qb.t()
        gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


class _Bf16Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = (t.to(torch.bfloat16).float() for t in (a, b))
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = g.to(torch.bfloat16).float()
        ga = qg @ qb.t()
        gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


class Products:
    """``a @ b`` (b a 2-D weight) in ``"fp32"``, ``"bf16"`` or ``"fp8"``
    (operands rounded, sums in float32)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}: fp32, bf16 or fp8")
        self.precision = precision

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a, b)
        if self.precision == "bf16":
            return _Bf16Matmul.apply(a, b)
        return a @ b


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every position."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def lr_at(train: Dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then cosine decay to 10 % at
    ``total_steps``; ``step`` counts from 0."""
    warm = min(step / max(train["warmup_steps"], 1), 1.0)
    frac = min(max((step - train["warmup_steps"])
                   / max(train["total_steps"] - train["warmup_steps"], 1),
                   0.0), 1.0)
    return train["learning_rate"] * warm * (0.55 + 0.45 * math.cos(
        math.pi * frac))


class AdamW:
    """AdamW with global-norm clipping over float32 moments; parameters
    kept at ``param_dtype`` (each update rounded to it, as the
    configuration stores them) and computed with in float32."""

    def __init__(self, params: Dict[str, torch.Tensor], train: Dict,
                 param_dtype: torch.dtype):
        self.train = train
        self.param_dtype = param_dtype
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def clip(self, grads: Dict[str, torch.Tensor]) -> float:
        """The factor global-norm clipping scales ``grads`` by."""
        if not self.train["grad_clip"]:
            return 1.0
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                              for g in grads.values()))
        return min(self.train["grad_clip"] / max(gnorm, 1e-9), 1.0)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float) -> Dict[str, float]:
        """Updates ``params`` in place; returns each leaf's clipped
        gradient norm (the gradient the moments took)."""
        t = self.train
        self.count += 1
        clip = self.clip(grads)
        b1, b2, eps = t["beta1"], t["beta2"], t["eps"]
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        norms = {}
        for n, p in params.items():
            g = grads[n] * clip
            norms[n] = float(torch.linalg.vector_norm(g))
            self.mu[n].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[n].mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + eps)
            new = p - lr * (upd + t["weight_decay"] * p)
            p.copy_(new.to(self.param_dtype).float())
        return norms


def layer_leaves(weights: Dict[str, torch.Tensor], num_layers: int,
                 pattern_len: int = 1) -> List[Dict[str, torch.Tensor]]:
    """Each layer's weights by name within the layer (``mix/wr``), from a
    tree whose layers are ``prefix/<i>/``, ``blocks/<p>/`` stacked over
    the blocks (``[n_blocks, ...]``, a view a block) and ``tail/<j>/``."""
    def group(head):
        out = {}
        for path, t in weights.items():
            if path.startswith(head):
                out[path[len(head):]] = t
        return out

    prefix = []
    i = 0
    while any(p.startswith(f"prefix/{i}/") for p in weights):
        prefix.append(group(f"prefix/{i}/"))
        i += 1
    blocks = [group(f"blocks/{p}/") for p in range(pattern_len)]
    n_blocks = 0
    if blocks[0]:
        n_blocks = next(iter(blocks[0].values())).shape[0]
    tail = []
    j = 0
    while any(p.startswith(f"tail/{j}/") for p in weights):
        tail.append(group(f"tail/{j}/"))
        j += 1
    # one unbind a stacked leaf: its backward stacks the blocks' gradients
    # in one copy, where indexing would add a whole zero gradient a block
    split = [{n: t.unbind(0) for n, t in blocks[p].items()}
             for p in range(pattern_len)]
    layers = list(prefix)
    for bi in range(n_blocks):
        for p in range(pattern_len):
            layers.append({n: t[bi] for n, t in split[p].items()})
    layers += tail
    if len(layers) != num_layers:
        raise ValueError(f"found {len(layers)} layers, the configuration "
                         f"states {num_layers}")
    return layers
