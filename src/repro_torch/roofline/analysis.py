"""Roofline accounting for the dry run (the reference's
``repro.roofline.analysis``).

Totals are assembled from *calibration* counts, as the reference
assembles them from its calibration compiles:

    per_unit  = cost(2u) − cost(1u)
    non_layer = cost(1u) − per_unit
    total     = non_layer + n_units · per_unit          (× n_mb for train)

(the dry run counts at two and three units and derives the 1-unit cost
by the same linearity, ``launch.dryrun``).

The reference reads its FLOPs and bytes from XLA's ``cost_analysis`` of
the compiled module and its collective bytes from the HLO text.  A
PyTorch program has neither: the port's counts come from running the step
on ``meta`` tensors (``launch.dryrun``), and the collective terms, which
only HLO shows, are ``None`` (not measured), never 0.  The HLO parser
(:func:`collective_bytes`) is kept for HLO text from elsewhere.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional

from repro_torch.roofline import hw

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_SHAPE_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*(\(?[^)=]*?\)?)\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")


def _shape_bytes(shape_token: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_token):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Sum output bytes of every collective op, by kind (per-device view:
    HLO shapes in a partitioned module are the per-device shard shapes)."""
    out = {k: 0.0 for k in _COLL_KINDS}
    count = {k: 0 for k in _COLL_KINDS}
    for m in _OP_RE.finditer(hlo_text):
        shape_token, kind, suffix = m.group(1), m.group(2), m.group(3)
        if suffix == "-done":
            continue
        out[kind] += _shape_bytes(shape_token)
        count[kind] += 1
    out["total"] = sum(out[k] for k in _COLL_KINDS)
    out["ops"] = float(sum(count.values()))
    return out


def _both(a: Optional[float], b: Optional[float],
          op: Callable[[float, float], float]) -> Optional[float]:
    """``op(a, b)``, or ``None`` where either was not measured."""
    return None if a is None or b is None else op(a, b)


@dataclasses.dataclass
class CellCost:
    """Per-device totals for one (arch × shape × mesh) cell.  ``coll_bytes``
    and ``coll_ops`` are ``None`` where no collective was counted (a
    PyTorch step has no HLO to read them from)."""
    flops: float
    bytes_accessed: float
    coll_bytes: Optional[float]
    coll_ops: Optional[float]

    def scaled(self, k: float) -> "CellCost":
        return CellCost(self.flops * k, self.bytes_accessed * k,
                        _both(self.coll_bytes, k, lambda a, b: a * b),
                        _both(self.coll_ops, k, lambda a, b: a * b))

    def plus(self, other: "CellCost") -> "CellCost":
        add = lambda a, b: a + b  # noqa: E731
        return CellCost(self.flops + other.flops,
                        self.bytes_accessed + other.bytes_accessed,
                        _both(self.coll_bytes, other.coll_bytes, add),
                        _both(self.coll_ops, other.coll_ops, add))

    def minus(self, other: "CellCost") -> "CellCost":
        sub = lambda a, b: a - b  # noqa: E731
        return CellCost(self.flops - other.flops,
                        self.bytes_accessed - other.bytes_accessed,
                        _both(self.coll_bytes, other.coll_bytes, sub),
                        _both(self.coll_ops, other.coll_ops, sub))


def extrapolate(cost_1u: CellCost, cost_2u: CellCost, n_units: float,
                n_repeat: float = 1.0,
                per_repeat_correction: Optional[CellCost] = None
                ) -> CellCost:
    """total = non_layer + n_units·per_unit, repeated n_repeat times
    (microbatches), minus (n_repeat−1)·per_repeat_correction (e.g. the
    optimizer update which runs once per step, not per microbatch)."""
    per_unit = cost_2u.minus(cost_1u)
    non_layer = cost_1u.minus(per_unit)
    one_pass = non_layer.plus(per_unit.scaled(n_units))
    total = one_pass.scaled(n_repeat)
    if n_repeat > 1 and per_repeat_correction is not None:
        total = total.minus(per_repeat_correction.scaled(n_repeat - 1))
    return total


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: Optional[float]  # None: no collective bytes counted
    dominant: str                  # the largest of the terms there are
    model_flops: float             # 6·N·D (active) per step, whole job
    hlo_flops_total: float         # per-device flops × chips
    useful_ratio: float            # model_flops / hlo_flops_total

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(cost: CellCost, *, chips: int, model_flops: float
             ) -> RooflineTerms:
    """cost holds PER-DEVICE totals; the terms divide by one H100's peaks
    (``hw``).  Without collective bytes the collective term is ``None``
    and ``dominant`` is chosen between compute and memory."""
    compute_s = cost.flops / hw.PEAK_FLOPS_BF16
    memory_s = cost.bytes_accessed / hw.HBM_BW
    coll_s = _both(cost.coll_bytes, hw.NVLINK_LINK_BW, lambda a, b: a / b)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max((k for k in terms if terms[k] is not None),
                   key=terms.get)
    hlo_total = cost.flops * chips
    return RooflineTerms(
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=model_flops,
        hlo_flops_total=hlo_total,
        useful_ratio=model_flops / hlo_total if hlo_total else 0.0)


def model_flops_per_step(cfg, shape, n_layers_override=None) -> float:
    """6·N_active·D for train, 2·N_active·D for inference (per step).

    decode: D = global_batch tokens (one step); prefill: D = batch·seq;
    train: D = batch·seq."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch
    return 2.0 * n_active * tokens
