"""AdamW with configurable moment precision (the reference's
``repro.optim.adamw``).

``moment_dtype``:

  float32   — exact AdamW
  bfloat16  — halves optimizer memory
  int8      — row-quantized moments (per-row absmax scales; the second
              moment in log space), as the reference keeps them

The order of operations in each leaf's update is the reference's, so that
one step from the same state agrees with it to rounding.  Divisions that
the reference takes by a Python number are taken here by a tensor on the
operand's device: PyTorch's CUDA division by a Python number multiplies by
its fp32 reciprocal, which can part from a true division by one ulp.

``init_structs`` and ``state_shardings`` describe the state without
allocating it, for the dry run: ``meta`` tensors of each leaf's shape and
dtype, and each leaf's :class:`~repro_torch.parallel.sharding.NamedSharding`
(the moments inherit the parameter's; an int8 moment's ``q`` keeps it and
its row scales drop the last dimension's axis), as the reference lays
them out for GSPMD.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.tree import tree_leaves, tree_map

# leaves of at least this many elements (and two dimensions) are updated
# in chunks of slices along their leading dimension, each chunk under this
# many elements, bounding the fp32 intermediates; the reference's lax.map
# takes one slice a step, which eagerly would cost a round of launches a
# slice (102,400 for deepseek-7b's embedding)
CHUNK_THRESHOLD = 1 << 28


def _chunks(leaf: torch.Tensor):
    """Slices ``[i, j)`` of the leading dimension, each under
    :data:`CHUNK_THRESHOLD` elements (at least one slice)."""
    step = max(1, CHUNK_THRESHOLD // max(1, leaf[0].numel()))
    return [(i, min(i + step, leaf.shape[0]))
            for i in range(0, leaf.shape[0], step)]


class QuantMoment(NamedTuple):
    """Row-wise 8-bit moment: ``q`` int8 in the parameter's shape, ``scale``
    fp32 ``[..., 1]`` (linear absmax, ``mode`` 0: the first moment) or
    ``[..., 2]`` (log-space lo/hi, ``mode`` 1: the second moment, whose
    range is too wide for a linear scale), ``mode`` an int32 scalar."""
    q: torch.Tensor
    scale: torch.Tensor
    mode: torch.Tensor


class AdamWState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` by a tensor on x's device (see the module's note)."""
    return x / x.new_full((), d)


def _quantize(x: torch.Tensor, log_space: bool) -> QuantMoment:
    xf = x.float()
    if log_space:
        lx = torch.log(torch.clamp(xf, min=1e-30))
        lo = torch.amin(lx, dim=-1, keepdim=True)
        hi = torch.amax(lx, dim=-1, keepdim=True)
        span = torch.clamp(hi - lo, min=1e-6)
        q = torch.clamp(torch.round((lx - lo) / span * 254.0) - 127,
                        -127, 127).to(torch.int8)
        return QuantMoment(q, torch.cat([lo, hi], -1),
                           torch.ones((), dtype=torch.int32,
                                      device=x.device))
    scale = _div(torch.clamp(torch.amax(torch.abs(xf), dim=-1, keepdim=True),
                             min=1e-30), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return QuantMoment(q, scale, torch.zeros((), dtype=torch.int32,
                                             device=x.device))


def _dequantize(m: QuantMoment) -> torch.Tensor:
    qf = m.q.float()
    if m.scale.shape[-1] == 2:                      # log mode
        lo, hi = m.scale[..., :1], m.scale[..., 1:]
        span = torch.clamp(hi - lo, min=1e-6)
        # entries at the floor of an all-(near)zero row decode to ~1e-30
        return torch.exp(_div(qf + 127.0, 254.0) * span + lo)
    return qf * m.scale


def _encode(x: torch.Tensor, dtype: str, log_space: bool = False):
    if dtype == "int8":
        return _quantize(x, log_space)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.float()


def _decode(m) -> torch.Tensor:
    if isinstance(m, QuantMoment):
        return _dequantize(m)
    return m.float()


def init(params, cfg: TrainConfig) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, count
    0, on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    mu = tree_map(lambda p: _encode(zeros(p), cfg.moment_dtype, False),
                  params)
    nu = tree_map(lambda p: _encode(zeros(p), cfg.moment_dtype, True),
                  params)
    device = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      mu, nu)


def _moment_struct(shape, cfg: TrainConfig, log_space: bool):
    """A ``meta`` stand-in for one moment leaf (no storage)."""
    if cfg.moment_dtype == "int8":
        sshape = tuple(shape[:-1]) + (2 if log_space else 1,)
        return QuantMoment(
            torch.empty(shape, dtype=torch.int8, device="meta"),
            torch.empty(sshape, dtype=torch.float32, device="meta"),
            torch.empty((), dtype=torch.int32, device="meta"))
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    return torch.empty(shape, dtype=dt, device="meta")


def init_structs(param_structs, cfg: TrainConfig) -> AdamWState:
    """An AdamWState of ``meta`` tensors in :func:`init`'s shapes and
    dtypes, beside ``param_structs`` (anything with a ``shape``)."""
    mu = tree_map(lambda p: _moment_struct(tuple(p.shape), cfg, False),
                  param_structs)
    nu = tree_map(lambda p: _moment_struct(tuple(p.shape), cfg, True),
                  param_structs)
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      mu, nu)


def state_shardings(param_shardings, param_structs, cfg: TrainConfig,
                    mesh, dp_spec) -> AdamWState:
    """Shardings matching :func:`init_structs`.

    fp32/bf16 moments inherit the parameter sharding exactly (FSDP/ZeRO);
    int8 moments keep the parameter sharding for ``q`` and drop the last
    dimension's axis for the row scales.  ``dp_spec`` is unused, as in the
    reference."""
    from repro_torch.parallel.sharding import NamedSharding

    def one(p_shard, p_struct, log_space):
        if cfg.moment_dtype != "int8":
            return p_shard
        ndim = len(p_struct.shape)
        spec = tuple(p_shard.spec) + (None,) * (ndim - len(p_shard.spec))
        scale_spec = spec[:-1] + (None,) if ndim else spec
        return QuantMoment(p_shard, NamedSharding(mesh, scale_spec),
                           NamedSharding(mesh, ()))

    repl = NamedSharding(mesh, ())
    mu = tree_map(lambda s, p: one(s, p, False), param_shardings,
                  param_structs)
    nu = tree_map(lambda s, p: one(s, p, True), param_shardings,
                  param_structs)
    return AdamWState(repl, mu, nu)


def global_norm(tree) -> torch.Tensor:
    """The fp32 L2 norm over every leaf, leaves summed in flatten order;
    a huge leaf's squares are summed chunk by chunk over its leading
    dimension (the reference's ``lax.map``, slice by slice)."""
    def sumsq(leaf):
        if leaf.numel() >= CHUNK_THRESHOLD and leaf.dim() >= 2:
            return torch.sum(torch.stack(
                [torch.sum(torch.square(leaf[i:j].float()))
                 for i, j in _chunks(leaf)]))
        return torch.sum(torch.square(leaf.float()))

    return torch.sqrt(sum(sumsq(leaf) for leaf in tree_leaves(tree)))


def update(grads, state: AdamWState, params, lr: torch.Tensor,
           cfg: TrainConfig) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step.  Returns (new_params, new_state, metrics); the
    arguments are not changed."""
    count = state.count + 1
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        clip = torch.clamp(gnorm.new_full((), cfg.grad_clip)
                           / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        clip = torch.ones((), dtype=torch.float32, device=gnorm.device)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def leaf_update(p, g, mu_e, nu_e):
        g = g.float() * clip
        mu = _decode(mu_e)
        nu = _decode(nu_e)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        step = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        pf = p.float()
        pf = pf - lr * (step + cfg.weight_decay * pf)
        return (pf.to(p.dtype),
                _encode(mu, cfg.moment_dtype, log_space=False),
                _encode(nu, cfg.moment_dtype, log_space=True))

    def dispatch_update(p, g, m, n):
        if p.numel() < CHUNK_THRESHOLD or p.dim() < 2:
            return leaf_update(p, g, m, n)
        # a huge leaf, chunk by chunk over its leading dimension (every
        # operation is elementwise or a row's, so the chunks change no
        # value)
        parts = [leaf_update(p[i:j], g[i:j], _slice(m, i, j),
                             _slice(n, i, j)) for i, j in _chunks(p)]
        return (torch.cat([a for a, _, _ in parts]),
                _cat([b for _, b, _ in parts]),
                _cat([c for _, _, c in parts]))

    is_q = lambda x: isinstance(x, QuantMoment)  # noqa: E731
    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_mu = _moment_leaves(state.mu, is_q)
    flat_nu = _moment_leaves(state.nu, is_q)
    out = [dispatch_update(p, g, m, n)
           for p, g, m, n in zip(flat_p, flat_g, flat_mu, flat_nu)]
    it_p = iter([o[0] for o in out])
    it_mu = iter([o[1] for o in out])
    it_nu = iter([o[2] for o in out])
    new_params = tree_map(lambda _: next(it_p), params)
    new_mu = tree_map(lambda _: next(it_mu), params)
    new_nu = tree_map(lambda _: next(it_nu), params)
    return (new_params, AdamWState(count, new_mu, new_nu),
            {"grad_norm": gnorm, "clip": clip})


def _moment_leaves(tree, is_q) -> list:
    """A moment tree's leaves, a :class:`QuantMoment` counting as one."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _moment_leaves(tree[k], is_q)]
    if isinstance(tree, (list, tuple)) and not is_q(tree):
        return [x for t in tree for x in _moment_leaves(t, is_q)]
    return [tree]


def _slice(m, i: int, j: int):
    if isinstance(m, QuantMoment):
        return QuantMoment(m.q[i:j], m.scale[i:j], m.mode)
    return m[i:j]


def _cat(parts):
    if isinstance(parts[0], QuantMoment):
        return QuantMoment(torch.cat([m.q for m in parts]),
                           torch.cat([m.scale for m in parts]),
                           parts[0].mode)
    return torch.cat(parts)


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 10%: an fp32 scalar on
    ``step``'s device."""
    s = step.float()
    warm = torch.clamp(_div(s, max(cfg.warmup_steps, 1)), max=1.0)
    frac = torch.clamp(_div(s - cfg.warmup_steps,
                            max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return cfg.learning_rate * warm * cos
