"""Back-compat facade over :mod:`repro_torch.platform` (thesis §4.1.3
configs).

The end-to-end tiny-task pipeline — kneepoint sizing, task partitioning,
scheduling, datastore fetch, streaming reduce — lives in
``repro_torch.platform`` (the Platform driver).  This module keeps the
original entry points (``PLATFORMS``, ``make_tasks``,
``run_subsampling_job``, ``measure_kneepoint``) so existing callers keep
working; new code should use :class:`repro_torch.platform.Platform`
directly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.platform.compute import pad_to_common
from repro_torch.platform.driver import (  # noqa: F401  (re-exported API)
    BASH_STARTUP,
    PLATFORMS,
    JobReport,
    Platform,
    PlatformConfig,
    PlatformSpec,
    make_tasks,
    measure_kneepoint,
)


def run_subsampling_job(
    samples: Dict[int, np.ndarray],
    months: Dict[int, np.ndarray],
    workload,
    *,
    platform: str = "BTS",
    n_workers: int = 4,
    knee_bytes: Optional[float] = None,
    datastore=None,
    seed: int = 0,
    device: str = "cuda",
) -> JobReport:
    """Execute a subsampling job on the threaded backend (real wall time),
    its map tasks on ``device`` (the card unless the caller asks for the
    CPU).

    Thin wrapper over :class:`repro_torch.platform.Platform`; the offline
    kneepoint phase, if needed and not supplied, runs first and is charged
    to the report (thesis accounting: offline ≈ 3% of online).
    """
    spec = PlatformSpec(platform=platform, n_workers=n_workers,
                        backend="threaded", knee_bytes=knee_bytes,
                        seed=seed, device=device)
    return Platform(spec, datastore=datastore).run(samples, months, workload)


def _pad_to_common(arrays: List[np.ndarray]) -> List[np.ndarray]:
    """Deprecated alias — moved to
    ``repro_torch.platform.compute.pad_to_common``."""
    return pad_to_common(arrays)
