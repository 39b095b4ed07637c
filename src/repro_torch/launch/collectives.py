"""Collectives over the slots of one mesh axis, in one process (the port's
counterpart of ``jax.lax.all_gather``, ``psum``, ``psum_scatter`` and
``axis_index`` inside a ``shard_map``).

A slot's value is a tensor on the slot's device; a collective takes the
slots' tensors as a list in slot order and returns the result on the device
(or devices) it names.  Moving a tensor is ``.to(device)``, a no-op where
two slots share a device (several slots may name one card), as in the
pipeline runtime's hand-offs.  Every operation is differentiable through
autograd: a gather's gradient is the slice, a sum's is a broadcast, a
scatter's is the gather.  Sums run in slot order, so a result does not
depend on which slot finishes first.

All traffic between the slots of a mesh goes through this module (the model
code, :func:`repro_torch.models.sharding.place` / ``gather`` and the mesh
train step call nothing else to move a tensor between slots), so a process
group can stand behind these functions later.  :data:`TRAFFIC` counts the
calls and the bytes each kind of operation reads.
"""

from __future__ import annotations

import torch

from .. import resolve_device

__all__ = ["TRAFFIC", "all_gather", "axis_index", "broadcast", "broadcast_tree", "gather_to",
           "psum", "reduce_scatter", "scatter"]

# operation -> [calls, bytes read]
TRAFFIC: dict = {}


def _count(op: str, xs) -> None:
    calls = TRAFFIC.setdefault(op, [0, 0])
    calls[0] += 1
    calls[1] += sum(x.numel() * x.element_size() for x in xs)


def _unique(devices) -> dict:
    """Each distinct device of ``devices`` once, resolved (a CUDA device
    without a card raises)."""
    return {d: resolve_device(d) for d in dict.fromkeys(torch.device(d) for d in devices)}


def gather_to(xs: list, dim: int, device) -> torch.Tensor:
    """The slots' tensors joined along ``dim`` in slot order, on ``device``
    (a tiled all-gather read by one slot)."""
    dev = resolve_device(device)
    _count("gather", xs)
    return torch.cat([x.to(dev) for x in xs], dim=dim)


def all_gather(xs: list, dim: int, devices=None) -> list:
    """Tiled all-gather: every slot gets the slots' tensors joined along
    ``dim`` on its device (``devices``, one per slot; the slots' own
    devices by default).  Slots that share a device share one tensor."""
    devices = [x.device for x in xs] if devices is None else list(devices)
    _count("all_gather", xs)
    joined = {d: torch.cat([x.to(dev) for x in xs], dim=dim)
              for d, dev in _unique(devices).items()}
    return [joined[torch.device(d)] for d in devices]


def scatter(x: torch.Tensor, dim: int, devices) -> list:
    """``x`` cut into ``len(devices)`` equal parts along ``dim``, part ``i``
    on ``devices[i]``."""
    devices = list(devices)
    if x.shape[dim] % len(devices):
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over "
                         f"{len(devices)} slots")
    resolved = _unique(devices)
    _count("scatter", [x])
    return [part.to(resolved[torch.device(d)])
            for part, d in zip(torch.chunk(x, len(devices), dim=dim), devices)]


def broadcast(x: torch.Tensor, devices) -> list:
    """``x`` on every slot's device; slots that share a device share one
    tensor."""
    devices = list(devices)
    _count("broadcast", [x])
    copies = {d: x.to(dev) for d, dev in _unique(devices).items()}
    return [copies[torch.device(d)] for d in devices]


def broadcast_tree(tree, devices) -> list:
    """A tree of nested dicts of tensors on every slot's device: one tree
    per slot, each leaf by :func:`broadcast`."""
    devices = list(devices)
    if isinstance(tree, dict):
        per_key = {k: broadcast_tree(v, devices) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(len(devices))]
    return broadcast(tree, devices)


def psum(xs: list, device) -> torch.Tensor:
    """The slots' tensors summed in slot order on ``device``."""
    dev = resolve_device(device)
    _count("psum", xs)
    out = xs[0].to(dev)
    for x in xs[1:]:
        out = out + x.to(dev)
    return out


def reduce_scatter(xs: list, dim: int, devices) -> list:
    """The slots' tensors summed, the sum cut into ``len(devices)`` equal
    parts along ``dim``, part ``i`` on ``devices[i]``; each part summed in
    slot order."""
    devices = list(devices)
    n = len(devices)
    if xs[0].shape[dim] % n:
        raise ValueError(f"dim {dim} of size {xs[0].shape[dim]} does not split over {n} slots")
    resolved = _unique(devices)
    _count("reduce_scatter", xs)
    parts = [torch.chunk(x, n, dim=dim) for x in xs]
    out = []
    for i, d in enumerate(devices):
        dev = resolved[torch.device(d)]
        acc = parts[0][i].to(dev)
        for p in parts[1:]:
            acc = acc + p[i].to(dev)
        out.append(acc)
    return out


def axis_index(mesh, axis: str, slot: int) -> int:
    """The index along ``axis`` of the row-major mesh slot ``slot``."""
    return mesh.coords(slot)[axis]
