"""Meshes: the production and test meshes of the model zoo, and the wave
mesh a sharded wave runs over.

:class:`Mesh` describes the reference's ``jax.make_mesh`` result: axis
names, one size an axis, and the devices laid over them in row-major
order.  The production meshes (``make_production_mesh``: ``(16, 16)``
``("data", "model")``, or ``(2, 16, 16)`` ``("pod", "data", "model")``
with ``multi_pod``) hold no devices: the reference's are 512 forced
host placeholders that only its dry run lowers onto, and the port's dry
run (``repro_torch.launch.dryrun``) reads only their axes and sizes.
``make_test_mesh`` lays a small shape over the devices there are.

The reference builds the wave mesh as a 1-D jax mesh with one ``"wave"``
axis (``make_wave_mesh``).  The port's counterpart is a list of torch
devices, one CUDA stream an entry: each entry launches the unsharded
wave's kernel over its own lanes on its own stream, and the partials are
gathered on the host in mesh order
(:func:`repro_torch.parallel.collectives.gather_shards`).  A list may
repeat a device: four entries of ``cuda:0`` are four streams on one
card, and entries of ``cpu`` emulate a mesh on the CPU (the reference's
``--xla_force_host_platform_device_count``).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import MeshConfig
from repro_torch.device import check_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names, a size an axis, and ``devices`` laid over them in
    row-major order (``None`` for a mesh that only describes a layout,
    as the production meshes do)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in rank")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name → size, as a jax mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_mesh(cfg: MeshConfig) -> Mesh:
    """The layout ``cfg`` names, without devices (a production layout)."""
    return Mesh(tuple(cfg.axis_names), tuple(cfg.shape))


def make_test_mesh(shape: Optional[Tuple[int, ...]] = None,
                   axes: Tuple[str, ...] = ("data", "model"),
                   device="cuda") -> Mesh:
    """A small mesh over the devices there are: the first cards on
    ``cuda`` (by default ``(n // min(n, 2), min(n, 2))`` over all ``n``
    of them, as the reference's default), repeated ``cpu`` entries on
    ``cpu`` (by default ``(1, 1)``).  Asking for more cards than exist
    raises."""
    dev = check_device(device)
    if dev.type == "cpu":
        shape = shape or (1,) * len(axes)
        return Mesh(tuple(axes), tuple(shape), (dev,) * math.prod(shape))
    if dev.type != "cuda":
        raise ValueError(f"a test mesh runs on 'cuda' or 'cpu', got {dev}")
    n = torch.cuda.device_count()
    if shape is None:
        shape = (n // min(n, 2), min(n, 2)) if n > 1 else (1, 1)
    if math.prod(shape) > n:
        raise ValueError(f"a mesh of shape {shape} wants "
                         f"{math.prod(shape)} cards but only {n} exist")
    return Mesh(tuple(axes), tuple(shape),
                tuple(torch.device("cuda", i)
                      for i in range(math.prod(shape))))


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
