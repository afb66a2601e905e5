"""Collectives of the wave mesh.

Only the host gather of the sharded wave path is here; the training
collectives of the reference's ``repro.parallel.collectives``
(``ring_all_reduce``, ``compressed_psum``, ``reduce_scatter``) come with
the port's training loop.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch


def gather_shards(parts: Sequence[torch.Tensor],
                  streams: Optional[Sequence] = None) -> np.ndarray:
    """Host-side deterministic gather of a sharded result: each part
    copied to the host, then concatenated along axis 0 in the order given
    (the mesh's order), as the reference combines per-device partials on
    the host in mesh-axis order.

    ``streams[i]`` is the CUDA stream that produced ``parts[i]`` (None:
    the current one).  Each copy is made on its part's own stream, so it
    waits for that stream's kernel and for no other: a copy made on
    another stream would read a result not yet written."""
    if streams is None:
        streams = [None] * len(parts)
    host = []
    for part, stream in zip(parts, streams, strict=True):
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            host.append(part.cpu().numpy())
    return np.concatenate(host, axis=0)
