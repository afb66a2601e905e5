"""Layout helpers shared by the kernels' launch wrappers."""

from __future__ import annotations

import torch


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes
    (the kernels that copy rows in 16-byte pieces, or by TMA, need that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
