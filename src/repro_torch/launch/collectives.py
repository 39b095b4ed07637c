"""Collectives over the slots of one mesh axis, in one process (the port's
counterpart of ``jax.lax.all_gather``, ``psum``, ``psum_scatter``,
``ppermute`` and ``axis_index`` inside a ``shard_map``).

A slot's value is a tensor on the slot's device; a collective takes the
slots' tensors as a list in slot order and returns the result on the device
(or devices) it names.  Moving a tensor is ``.to(device)``, a no-op where
two slots share a device (several slots may name one card).  Every
operation is differentiable through autograd: a gather's gradient is the
slice, a sum's is a broadcast, a scatter's is the gather, a send's goes
back to its source.  Sums run in slot order, so a result does not
depend on which slot finishes first.

All traffic between the slots of a mesh goes through this module (the model
code, :func:`repro_torch.models.sharding.place` / ``gather``, the mesh
train step and the pipeline's hand-offs call nothing else to move a tensor
between slots), so a process group can stand behind these functions later.
:data:`TRAFFIC` counts the calls and the bytes each kind of operation reads.

A block under :func:`counted_as` stands for ``n`` slots that do the same
work (the dry run computes one data slot of a mesh whose data slots are
symmetric): every call inside it counts ``n`` times, and an op analysis
(:mod:`repro_torch.launch.hlo_analysis`) reads :func:`count_scale` to count
its ops and launches the same way.
"""

from __future__ import annotations

import contextlib

import torch

from .. import resolve_device

__all__ = ["TRAFFIC", "all_gather", "axis_index", "broadcast", "broadcast_tree", "count_scale",
           "counted_as", "gather_to", "ppermute", "psum", "reduce_scatter", "scatter"]

# operation -> [calls, bytes read]
TRAFFIC: dict = {}
# how many slots' identical work the code being run stands for
_SCALE = [1]


def _count(op: str, xs) -> None:
    n = _SCALE[-1]
    calls = TRAFFIC.setdefault(op, [0, 0])
    calls[0] += n
    calls[1] += n * sum(x.numel() * x.element_size() for x in xs)


def count_scale() -> int:
    """How many times a call made now counts (1 outside :func:`counted_as`)."""
    return _SCALE[-1]


@contextlib.contextmanager
def counted_as(n: int):
    """Within the block every call counts ``n`` times: the block computes
    one of ``n`` slots whose work is the same, in shapes and in calls."""
    _SCALE.append(_SCALE[-1] * int(n))
    try:
        yield n
    finally:
        _SCALE.pop()


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


class _AllGather32(torch.autograd.Function):
    """Every receiver its own copy of the inputs joined along ``dim``; the
    gradient of each input is its part of the receivers' gradients summed
    in float32 in slot order and rounded once (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, dim, devices, *xs):
        ctx.dim, ctx.sources = dim, [(x.device, x.dtype) for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        joined, first = {}, {}
        out = []
        for i, d in enumerate(devices):
            if d not in joined:
                joined[d] = torch.cat([x.to(d) for x in xs], dim=dim)
            out.append(joined[d] if first.setdefault(d, i) == i else joined[d].clone())
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        out = []
        lo = 0
        for (dev, dt), n in zip(ctx.sources, ctx.sizes):
            out.append(_sum32([g.narrow(ctx.dim, lo, n) for g in live], dev).to(dt))
            lo += n
        return (None, None, *out)


def all_gather(xs: list, dim: int, devices=None, grad32: bool = False) -> list:
    """Tiled all-gather: every slot gets the slots' tensors joined along
    ``dim`` on its device (``devices``, one per slot; the slots' own
    devices by default).  Slots that share a device share one tensor, and
    autograd sums the receivers' gradients as it meets them.  With
    ``grad32`` every receiver gets its own copy, and the gradient of each
    input is its part of the receivers' gradients summed in float32 in slot
    order and rounded once (a reduce-scatter that rounds as :func:`psum`
    and :func:`reduce_scatter` do): the all-gather at a sequence-parallel
    block edge, whose backward must equal that of the all-reduce it
    replaces."""
    devices = [x.device for x in xs] if devices is None else list(devices)
    _count("all_gather", xs)
    if grad32:
        resolved = _unique(devices)
        return list(_AllGather32.apply(dim, [resolved[torch.device(d)] for d in devices], *xs))
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


def ppermute(xs: list, devices) -> list:
    """Slot ``i``'s tensor ``xs[i]`` sent to its paired destination slot,
    on that slot's device ``devices[i]`` (the pairs of ``jax.lax.ppermute``'s
    ``perm``, one send each): a pipeline's hand-off from each slot of one
    stage to the slot at the same place in the next.  One call, every
    send's bytes counted; the gradient of each send goes back to its
    source."""
    devices = list(devices)
    if len(devices) != len(xs):
        raise ValueError(f"{len(xs)} sources for {len(devices)} destinations")
    resolved = _unique(devices)
    _count("ppermute", xs)
    return [x.to(resolved[torch.device(d)]) for x, d in zip(xs, devices)]


def _sum(xs: list, dev: torch.device) -> torch.Tensor:
    out = xs[0].to(dev)
    for x in xs[1:]:
        out = out + x.to(dev)
    return out


def _sum32(xs: list, dev: torch.device) -> torch.Tensor:
    out = xs[0].to(dev, torch.float32)
    for x in xs[1:]:
        out = out + x.to(dev, torch.float32)
    return out


class _AllReduce(torch.autograd.Function):
    """Each receiver's own copy of the inputs' sum, accumulated in float32
    in slot order and rounded once to the inputs' dtype; the gradient of
    each input is the receivers' gradients summed the same way."""

    @staticmethod
    def forward(ctx, devices, *xs):
        ctx.sources = [(x.device, x.dtype) for x in xs]
        sums = {}
        for d in devices:
            if d not in sums:
                sums[d] = _sum32(xs, d).to(xs[0].dtype)
        first = {}
        return tuple(sums[d] if first.setdefault(d, i) == i else sums[d].clone()
                     for i, d in enumerate(devices))

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        out = {}
        for dev, dt in ctx.sources:
            if dev not in out:
                out[dev] = _sum32(live, dev).to(dt)
        return (None, *(out[dev] for dev, _ in ctx.sources))


def psum(xs: list, device):
    """The slots' tensors summed in slot order on ``device``.  Given a list
    of devices (one per receiving slot), every receiver gets its own copy
    of the sum on its device (an all-reduce), accumulated in float32 and
    rounded once, as one product over the whole contraction would be; its
    gradient sums the receivers' the same way."""
    if isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
        _count("psum", xs)
        return list(_AllReduce.apply(devices, *xs))
    dev = resolve_device(device)
    _count("psum", xs)
    return _sum(xs, dev)


class _ReduceScatter(torch.autograd.Function):
    """Part ``i`` of the inputs' sum along ``dim`` on ``devices[i]``,
    accumulated in float32 in slot order and rounded once to the inputs'
    dtype (each part equals those rows of :func:`psum`'s all-reduce); the
    gradient of each input is the parts' gradients joined (an all-gather)."""

    @staticmethod
    def forward(ctx, dim, devices, *xs):
        ctx.dim, ctx.sources = dim, [(x.device, x.dtype) for x in xs]
        n = len(devices)
        parts = [torch.chunk(x, n, dim=dim) for x in xs]
        return tuple(_sum32([p[i] for p in parts], d).to(xs[0].dtype)
                     for i, d in enumerate(devices))

    @staticmethod
    def backward(ctx, *grads):
        out = {}
        for dev, dt in ctx.sources:
            if (dev, dt) not in out:
                out[(dev, dt)] = torch.cat([g.to(dev, dt) for g in grads], dim=ctx.dim)
        return (None, None, *(out[s] for s in ctx.sources))


def reduce_scatter(xs: list, dim: int, devices) -> list:
    """The slots' tensors summed, the sum cut into ``len(devices)`` equal
    parts along ``dim``, part ``i`` on ``devices[i]``: each part accumulated
    in float32 in slot order and rounded once, as :func:`psum` rounds (so
    part ``i`` equals those rows of the all-reduce bit for bit); its
    gradient joins the parts' gradients."""
    devices = list(devices)
    n = len(devices)
    if xs[0].shape[dim] % n:
        raise ValueError(f"dim {dim} of size {xs[0].shape[dim]} does not split over {n} slots")
    resolved = _unique(devices)
    _count("reduce_scatter", xs)
    return list(_ReduceScatter.apply(dim, [resolved[torch.device(d)] for d in devices], *xs))


def axis_index(mesh, axis: str, slot: int) -> int:
    """The index along ``axis`` of the row-major mesh slot ``slot``."""
    return mesh.coords(slot)[axis]
