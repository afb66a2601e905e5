"""Collectives over a mesh's entries (the reference's
``repro.parallel.collectives``), and the wave mesh's host gather.

The reference runs its collectives under ``shard_map``, one program a
device exchanging chunks by ``lax.ppermute``.  Here a collective takes a
list of shards, one tensor a mesh entry, and returns what each entry ends
with.  Each entry's work (a copy in from its ring neighbour, an add) is
issued on that entry's CUDA stream (``streams[i]``; None: the current
one), as :func:`gather_shards` copies each part on its own stream.  A
ring step reads what the previous step wrote on another entry and
overwrites what the previous step read there, so every entry's stream
waits for every other's previous step before it starts the next (a
barrier of events, one a stream and step).

* ``ring_all_reduce`` — the reference's ring, step for step: ``n - 1``
  reduce-scatter steps, then ``n - 1`` all-gather steps, with its chunk
  indices; an entry adds the chunk it receives to its own
  (``own + received``), so the sum of each chunk is taken in the ring's
  order and every entry ends with the same bits.
* ``reduce_scatter`` — the ring's reduce-scatter half with the chunk
  indices shifted by one, so that entry ``i`` ends with chunk ``i`` of the
  sum (the reference's ``psum`` then this entry's slice; the sum is taken
  in the ring's order here).
* ``compressed_psum`` — each entry's int8 payload (values and per-row
  scales, :mod:`repro_torch.parallel.compression`) copied to every entry,
  which adds the dequantized payloads in entry order: Σᵢ
  dequant(quant(xᵢ)), within one quantization step an entry of Σᵢ xᵢ.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.parallel.compression import dequantize_int8, quantize_int8


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
        with _on(stream):
            host.append(part.cpu().numpy())
    return np.concatenate(host, axis=0)


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _read_on(t: torch.Tensor, stream) -> torch.Tensor:
    """``t``, read by work issued on ``stream``: the caching allocator is
    told, so that ``t``'s block is not handed out again before that work
    is done."""
    if stream is not None and t.is_cuda:
        t.record_stream(stream)
    return t


def _streams(shards, streams):
    if streams is None:
        return [None] * len(shards)
    if len(streams) != len(shards):
        raise ValueError(f"{len(streams)} streams for {len(shards)} shards")
    return list(streams)


def _barrier(streams) -> None:
    """Every entry's stream waits for all work issued so far on every
    other entry's stream."""
    live = [s for s in streams if s is not None]
    if len(live) < 2:
        return
    events = [s.record_event() for s in live]
    for s in live:
        for e in events:
            s.wait_event(e)


def _chunks(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    if x.shape[0] % n:
        raise ValueError(f"a leading axis of {x.shape[0]} does not split "
                         f"into {n} chunks")
    return list(x.split(x.shape[0] // n, dim=0))


def _ring_pass(chunks, streams, shift: int, add: bool) -> None:
    """``n - 1`` ring steps in place: at step ``k`` entry ``j`` takes chunk
    ``(j - k - 1 + shift) % n`` from entry ``j - 1`` and adds it to its
    own (``add``) or keeps it (else).  Entry ``j - 1`` sends at step ``k``
    the chunk it changed at step ``k - 1``, and never the one it changes
    at step ``k``, so the steps of one round may be issued in any order."""
    n = len(chunks)
    for k in range(n - 1):
        _barrier(streams)
        for j in range(n):
            c = (j - k - 1 + shift) % n
            with _on(streams[j]):
                got = _read_on(chunks[(j - 1) % n][c], streams[j]).to(
                    chunks[j][c].device, copy=True)
                if add:
                    chunks[j][c].add_(got)
                else:
                    chunks[j][c].copy_(got)
    _barrier(streams)


def _own_copies(shards, streams) -> List[torch.Tensor]:
    out = []
    for x, s in zip(shards, streams):
        with _on(s):
            out.append(x.clone())
    return out


def ring_all_reduce(shards: Sequence[torch.Tensor],
                    streams: Optional[Sequence] = None
                    ) -> List[torch.Tensor]:
    """Reduce-scatter + all-gather ring over the entries: each shard is
    ``[N, ...]`` with N divisible by the number of entries; every entry
    ends with the sum (``lax.psum``), added in the reference's ring order.
    The shards are not changed."""
    streams = _streams(shards, streams)
    n = len(shards)
    if n == 1:
        return list(shards)
    out = _own_copies(shards, streams)
    chunks = [_chunks(x, n) for x in out]
    # reduce-scatter: at step k entry i sends chunk (i - k) % n, so that
    # after n - 1 steps it holds the whole sum of chunk (i + 1) % n
    _ring_pass(chunks, streams, shift=0, add=True)
    # all-gather: entry i sends chunk (i + 1 - k) % n, the completed ones
    _ring_pass(chunks, streams, shift=1, add=False)
    return out


def reduce_scatter(shards: Sequence[torch.Tensor],
                   streams: Optional[Sequence] = None
                   ) -> List[torch.Tensor]:
    """Entry ``i`` ends with slice ``i`` of the sum along axis 0 (the
    ZeRO gradient shard), by the ring's reduce-scatter with its chunk
    indices shifted by one."""
    streams = _streams(shards, streams)
    n = len(shards)
    if n == 1:
        return list(shards)
    out = _own_copies(shards, streams)
    chunks = [_chunks(x, n) for x in out]
    _ring_pass(chunks, streams, shift=-1, add=True)
    return [chunks[i][i] for i in range(n)]


def compressed_psum(shards: Sequence[torch.Tensor],
                    streams: Optional[Sequence] = None
                    ) -> List[torch.Tensor]:
    """The int8-payload all-reduce: each entry quantizes its shard, every
    entry receives the others' int8 values and fp32 row scales (about
    8× fewer bytes than fp32) and adds the dequantized payloads in entry
    order.  Every entry ends with the same bits."""
    streams = _streams(shards, streams)
    payloads = []
    for x, s in zip(shards, streams):
        with _on(s):
            payloads.append(quantize_int8(x))
    _barrier(streams)
    out = []
    for x, s in zip(shards, streams):
        with _on(s):
            acc = None
            for q, scale in payloads:
                term = dequantize_int8(_read_on(q, s).to(x.device),
                                       _read_on(scale, s).to(x.device),
                                       x.shape)
                acc = term if acc is None else acc + term
            out.append(acc)
    _barrier(streams)
    return out
