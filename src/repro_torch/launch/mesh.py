"""The wave mesh: the devices a sharded wave runs over.

The reference builds a 1-D jax mesh with one ``"wave"`` axis
(``make_wave_mesh``).  The port's counterpart is a list of torch devices,
one CUDA stream an entry: each entry launches the unsharded wave's kernel
over its own lanes on its own stream, and the partials are gathered on
the host in mesh order (:func:`repro_torch.parallel.collectives.gather_shards`).
A list may repeat a device: four entries of ``cuda:0`` are four streams
on one card, and entries of ``cpu`` emulate a mesh on the CPU (the
reference's ``--xla_force_host_platform_device_count``).

Only the wave mesh is here; the training meshes (the reference's
``make_production_mesh``, ``make_mesh``, ``make_test_mesh``) come with the
port's training loop.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import check_device


@dataclasses.dataclass(frozen=True)
class WaveMesh:
    """A tuple of devices, hashed and compared by that tuple (as a jax
    mesh is by its devices).  :meth:`stream` makes one CUDA stream an
    entry the first time it is asked for, and hands the same one out
    after: every thread that dispatches on entry ``d`` shares it."""

    devices: Tuple[torch.device, ...]
    _streams: Dict[int, "torch.cuda.Stream"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, repr=False,
        compare=False)

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a wave mesh needs >=1 device")
        object.__setattr__(self, "devices", devices)

    @property
    def n_dev(self) -> int:
        return len(self.devices)

    def stream(self, d: int) -> Optional["torch.cuda.Stream"]:
        """Entry ``d``'s CUDA stream, or None for a CPU entry."""
        device = self.devices[d]
        if device.type != "cuda":
            return None
        with self._lock:
            if d not in self._streams:
                self._streams[d] = torch.cuda.Stream(device=device)
            return self._streams[d]


def make_wave_mesh(n_devices: int, device="cuda") -> WaveMesh:
    """The mesh for sharded wave execution over ``n_devices`` entries.

    On ``cuda``, the first ``n_devices`` cards from ``device``'s index
    (asking for more cards than exist raises, as the reference refuses to
    oversubscribe its devices; with no card at all it raises as
    :func:`~repro_torch.device.check_device` does).  On ``cpu``,
    ``n_devices`` entries of the CPU: the emulated mesh."""
    if n_devices < 1:
        raise ValueError(f"mesh needs >=1 device, got {n_devices}")
    dev = check_device(device)
    if dev.type == "cpu":
        return WaveMesh((dev,) * n_devices)
    if dev.type != "cuda":
        raise ValueError(f"a wave mesh runs on 'cuda' or 'cpu', got {dev}")
    first = dev.index or 0
    avail = torch.cuda.device_count()
    if first + n_devices > avail:
        raise ValueError(
            f"wave mesh wants {n_devices} devices from cuda:{first} but "
            f"only {avail} CUDA device(s) exist — pass device='cpu' to "
            "emulate a mesh")
    return WaveMesh(tuple(torch.device("cuda", first + i)
                          for i in range(n_devices)))
