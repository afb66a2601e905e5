"""LM training input pipeline built on the paper's machinery (the
reference's ``repro.data.pipeline``, the same numpy code: the same seed
gives the same batches bit for bit).

Training-batch construction *is* a subsampling workload: each microbatch
randomly samples windows from corpus shards (random access ⇒ cache-hostile)
— so the pipeline sizes its shard-reading tasks at the kneepoint, schedules
them through the two-phase scheduler's queue, stores shards in the
adaptive-replication datastore, and prefetches ``k`` batches ahead with the
dynamic look-ahead rule.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.datastore import ReplicatedDataStore
from repro_torch.core.kneepoint import CurvePoint, find_kneepoint
from repro_torch.core.prefetch import PrefetchPipeline


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    batch_size: int
    seq_len: int
    seed: int = 0
    prefetch_min: int = 2
    prefetch_max: int = 16


class SubsamplingBatchPipeline:
    """Yields {tokens, labels} int32 batches subsampled from token shards."""

    def __init__(self, shards: Dict[int, np.ndarray], cfg: PipelineConfig,
                 datastore: Optional[ReplicatedDataStore] = None):
        assert shards, "empty corpus"
        self.cfg = cfg
        self.shard_ids = sorted(shards)
        self.datastore = datastore
        if datastore is not None:
            datastore.put_all(shards)
            self._get = lambda sid: datastore.fetch(sid)
        else:
            self._get = lambda sid: shards[sid]
        self._shard_len = min(len(shards[s]) for s in self.shard_ids)
        self._rng = np.random.default_rng(cfg.seed)

    def _one_batch(self) -> Dict[str, np.ndarray]:
        b, s = self.cfg.batch_size, self.cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        for i in range(b):
            sid = self.shard_ids[self._rng.integers(len(self.shard_ids))]
            shard = self._get(sid)
            start = self._rng.integers(0, max(1, len(shard) - s - 1))
            window = shard[start:start + s + 1]
            if len(window) < s + 1:
                window = np.pad(window, (0, s + 1 - len(window)),
                                mode="wrap")
            toks[i] = window
        return {"tokens": toks[:, :-1].copy(),
                "labels": toks[:, 1:].copy()}

    def batches(self, n: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        def gen():
            i = 0
            while n is None or i < n:
                yield self._one_batch()
                i += 1
        return PrefetchPipeline(gen(), min_depth=self.cfg.prefetch_min,
                                max_depth=self.cfg.prefetch_max)


def tune_microbatch_tokens(
    seq_len: int,
    d_model: int,
    num_layers: int,
    *,
    hbm_per_device: float = 16 * 2**30,
    reserve: float = 0.45,
    dtype_bytes: int = 2,
) -> int:
    """Kneepoint-style microbatch sizing for the device plane: the
    activation working set of one rematerialized microbatch
    (≈ L·tokens·d·dtype_bytes of saved layer inputs) must stay under the
    HBM budget left after params/optimizer (``reserve`` fraction).  The
    curve cost(tokens) is flat until the working set spills, then grows
    sharply — the same first-growth-rate-increase rule as the paper's.
    """
    budget = hbm_per_device * reserve
    sizes = [seq_len * (1 << i) for i in range(0, 8)]
    pts = []
    for tokens in sizes:
        ws = num_layers * tokens * d_model * dtype_bytes
        # cost per token: fixed per-task dispatch overhead amortized, plus
        # a spill penalty once the working set exceeds the budget
        overhead = 1.0 / tokens
        spill = max(0.0, ws / budget - 1.0) * 10.0
        pts.append(CurvePoint(task_size=float(tokens),
                              cost=overhead + spill))
    res = find_kneepoint(pts)
    return int(res.task_size)
