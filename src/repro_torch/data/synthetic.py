"""Synthetic datasets statistically shaped like the thesis' workloads.

* EAGLET (§4.1.1.1): 400 families ≈ 230 MB with a heavy-tailed family-size
  distribution (one sample 15× the mean, another 7×); scaled-up variants are
  generated "statistically similar" exactly as the thesis did.
* Netflix (§4.1.1.2): per-movie rating tuples (month, rating), ≈118 KB per
  movie at full scale.
* LM corpus: Zipfian token shards for the training pipeline.

Sizes here default to container-friendly fractions of the originals; the
generators take explicit scale parameters so benchmarks can sweep job size
(Fig 10/11/15).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EagletSpec:
    n_families: int = 400
    mean_markers: int = 4096        # observations per family sample
    heavy_tail: bool = True         # thesis: 15× and 7× outliers
    seed: int = 0


def eaglet_dataset(spec: EagletSpec = EagletSpec()
                   ) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    """Returns (samples, months) keyed by family id; months unused (zeros)
    but kept so the two workloads share one task interface."""
    rng = np.random.default_rng(spec.seed)
    sizes = np.maximum(
        16, rng.lognormal(mean=0.0, sigma=0.35, size=spec.n_families)
        * spec.mean_markers).astype(int)
    if spec.heavy_tail and spec.n_families >= 2:
        sizes[0] = int(15 * spec.mean_markers)      # the 15× outlier
        sizes[1] = int(7 * spec.mean_markers)       # the 7× outlier
    samples, months = {}, {}
    for fid, n in enumerate(sizes):
        # SNP-like linkage signal: smooth genetic signal + noise, with a
        # "disease locus" bump for a subset of families
        base = rng.normal(0, 1, n).astype(np.float32)
        if fid % 3 == 0:
            locus = int(0.6 * n)
            base[max(0, locus - n // 20):locus + n // 20] += 1.5
        samples[fid] = base
        months[fid] = np.zeros(n, np.int32)
    return samples, months


@dataclasses.dataclass(frozen=True)
class NetflixSpec:
    n_movies: int = 256
    mean_ratings: int = 4096        # ≈118KB/movie at fp32+int32 full scale
    n_months: int = 120
    seed: int = 0


def netflix_dataset(spec: NetflixSpec = NetflixSpec()
                    ) -> Tuple[Dict[int, np.ndarray], Dict[int, np.ndarray]]:
    rng = np.random.default_rng(spec.seed)
    samples, months = {}, {}
    for mid in range(spec.n_movies):
        n = max(64, int(rng.lognormal(0.0, 0.5) * spec.mean_ratings))
        quality = rng.uniform(2.0, 4.5)
        trend = rng.uniform(-0.5, 0.5)
        mo = rng.integers(0, spec.n_months, n).astype(np.int32)
        r = np.clip(quality + trend * mo / spec.n_months
                    + rng.normal(0, 1.0, n), 1, 5).astype(np.float32)
        samples[mid] = r
        months[mid] = mo
    return samples, months


def lm_token_corpus(n_tokens: int, vocab_size: int, *, seed: int = 0,
                    shard_tokens: int = 1 << 16) -> Dict[int, np.ndarray]:
    """Zipfian token shards for the LM training pipeline."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    shards = {}
    for i in range(max(1, n_tokens // shard_tokens)):
        shards[i] = rng.choice(vocab_size, size=shard_tokens,
                               p=probs).astype(np.int32)
    return shards
