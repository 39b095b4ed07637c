"""Device meshes of the port (the reference's ``launch/mesh.py``).

A :class:`Mesh` is a value: named axes with their sizes, in order, and, for
a concrete mesh, its devices in row-major order.  The pipeline runtime
places its pods along one axis of a concrete mesh; the sharding rules
(:mod:`repro_torch.models.sharding`) read only the axes and their sizes, so
an abstract mesh (no devices) serves them, as the production meshes of 256
and 512 cards do.

:func:`use_mesh` makes a concrete mesh ambient (the reference's
``jax.set_mesh``): inside the block the model code splits its rows over the
mesh's data slots (the ``pod`` and ``data`` axes, row-major), computes each
data slot tensor-parallel over its ``model`` slots from their blocks of the
weights (sequence-parallel attention where the heads do not divide that
axis), dispatches the MoE per data slot, and the train step takes placed
state (:func:`repro_torch.models.sharding.place`).  One process drives every slot,
and a slot may name a device that other slots name too (``devices=["cuda"] *
32`` is a (2, 16) mesh on one card); the traffic between slots goes through
:mod:`repro_torch.launch.collectives`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch

from .. import resolve_device

__all__ = ["Mesh", "data_axis_size", "data_slot_scope", "make_mesh", "make_production_mesh",
           "model_axis_size", "symmetric_data_slots", "use_mesh"]

DATA_AXES = ("pod", "data")


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

    def coords(self, slot: int) -> dict:
        """Axis name -> index of the row-major mesh slot ``slot``."""
        out = {}
        for name, size in zip(reversed(self.axis_names), reversed(self.axis_sizes)):
            slot, out[name] = divmod(slot, size)
        return {a: out[a] for a in self.axis_names}

    def slot(self, **index) -> int:
        """The row-major slot at ``index`` (axis name -> index; an axis not
        named is at 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            i = index.get(name, 0)
            if not 0 <= i < size:
                raise IndexError(f"{name} index {i} outside 0..{size - 1}")
            flat = flat * size + i
        return flat

    def data_coords(self, j: int) -> dict:
        """Data slot ``j`` (row-major over the ``pod`` and ``data`` axes) as
        axis indices."""
        out = {}
        for a in reversed([a for a in DATA_AXES if a in self.axis_names]):
            j, out[a] = divmod(j, self.shape[a])
        return out

    def data_index(self, slot: int) -> int:
        """The data slot (row-major over ``pod`` and ``data``) of the mesh
        slot ``slot``."""
        c, j = self.coords(slot), 0
        for a in DATA_AXES:
            if a in self.axis_names:
                j = j * self.shape[a] + c[a]
        return j

    def data_devices(self) -> tuple:
        """The device of each data slot: its slot at ``model`` index 0 (and
        every other axis at 0)."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        return tuple(self.devices[self.slot(**self.data_coords(j))]
                     for j in range(data_axis_size(self)))

    def row_devices(self, rows: int) -> tuple:
        """The devices ``rows`` rows of a batch split over: every data
        slot's where their count divides the rows, else data slot 0's alone
        (the reference replicates such a batch)."""
        devices = self.data_devices()
        return devices if rows % len(devices) == 0 else devices[:1]

    def model_devices(self, data_slot: int = 0) -> tuple:
        """The devices of data slot ``data_slot``'s ``model`` slots, in order."""
        if self.devices is None:
            raise ValueError("an abstract mesh has no devices")
        base = self.data_coords(data_slot)
        return tuple(self.devices[self.slot(**base, model=m)]
                     for m in range(model_axis_size(self)))


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


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Within the block ``mesh`` is the ambient mesh
    (:func:`repro_torch.models.common.abstract_mesh`), the reference's
    ``jax.set_mesh``; ``None`` clears it.  The mesh must be concrete."""
    from ..models import common

    if mesh is not None and mesh.devices is None:
        raise ValueError("use_mesh needs a concrete mesh (make_mesh), not an abstract one")
    prev = dict(common._AMBIENT)
    common._AMBIENT.update(mesh=mesh, data_slot=0, symmetric=False)
    try:
        yield mesh
    finally:
        common._AMBIENT.update(prev)


@contextlib.contextmanager
def data_slot_scope(j: int):
    """Within the block the model code computes data slot ``j``'s rows."""
    from ..models import common

    prev = common._AMBIENT["data_slot"]
    common._AMBIENT["data_slot"] = j
    try:
        yield j
    finally:
        common._AMBIENT["data_slot"] = prev


@contextlib.contextmanager
def symmetric_data_slots(on: bool = True):
    """Within the block (inside :func:`use_mesh`) a step whose data slots
    compute independently and alike may compute data slot 0 alone and
    stand its results in for the others', every op and collective of that
    slot counted once per data slot (:func:`repro_torch.launch.collectives.counted_as`):
    the dry run's shortcut.  The data slots' rows must be equal in number;
    the numbers of the other slots are not computed."""
    from ..models import common

    prev = common._AMBIENT["symmetric"]
    common._AMBIENT["symmetric"] = bool(on)
    try:
        yield on
    finally:
        common._AMBIENT["symmetric"] = prev
