"""Device meshes of the port (the reference's ``launch/mesh.py``).

A :class:`Mesh` is a value: named axes with their sizes, in order, and, for
a concrete mesh, its devices in row-major order.  The pipeline runtime
places its pods along one axis of a concrete mesh; the sharding rules
(:mod:`repro_torch.models.sharding`) read only the axes and their sizes, so
an abstract mesh (no devices) serves them, as the production meshes of 256
and 512 cards do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import resolve_device

__all__ = ["Mesh", "data_axis_size", "make_mesh", "make_production_mesh", "model_axis_size"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axes ``axis_names`` of sizes ``axis_sizes``; ``devices`` is ``None``
    for an abstract mesh, else one ``torch.device`` per mesh slot in
    row-major order (a device may fill several slots)."""

    axis_names: tuple
    axis_sizes: tuple
    devices: Optional[tuple] = None

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(int(n) for n in self.axis_sizes)
        if len(names) != len(sizes) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not match sizes {sizes} one to one")
        if any(n < 1 for n in sizes):
            raise ValueError(f"mesh axis sizes must be positive, got {sizes}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "axis_sizes", sizes)
        if self.devices is not None:
            devs = tuple(torch.device(d) for d in self.devices)
            if len(devs) != self.size:
                raise ValueError(f"a {sizes} mesh needs {self.size} devices, got {len(devs)}")
            object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (the reference's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def axis_devices(self, axis: str, index: int) -> tuple:
        """The devices of the slice ``index`` along ``axis``, row-major."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        a = self.axis_names.index(axis)
        if not 0 <= index < self.axis_sizes[a]:
            raise IndexError(f"{axis} index {index} outside 0..{self.axis_sizes[a] - 1}")
        stride = math.prod(self.axis_sizes[a + 1:])
        return tuple(d for k, d in enumerate(self.devices)
                     if (k // stride) % self.axis_sizes[a] == index)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 cards per pod; multi_pod adds a leading 2-pod axis (512).
    Abstract: the sharding rules read its shape only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A concrete mesh of ``shape`` over ``axes``.  ``devices`` lists one
    device per slot, row-major (it may name one card several times, as
    ``devices=["cuda"] * 4``); ``None`` takes ``cuda:0 .. cuda:n-1`` and
    raises without a card or with fewer cards than slots: a card is never
    repeated unless the caller names it so."""
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    if devices is None:
        resolve_device(None)
        visible = torch.cuda.device_count()
        if visible < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} cards and {visible} are visible; pass devices= to "
                f"place several slots on one card (e.g. devices=['cuda'] * {n})")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [resolve_device(d) for d in devices]
    return Mesh(axes, shape, tuple(devices))


def data_axis_size(mesh) -> int:
    out = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            out *= mesh.shape[a]
    return out


def model_axis_size(mesh) -> int:
    return mesh.shape["model"] if "model" in mesh.axis_names else 1
