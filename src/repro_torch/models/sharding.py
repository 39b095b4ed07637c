"""Parameter / state / batch sharding-spec derivation (the port of the
reference's ``models/sharding.py``).

``param_specs`` walks a parameter tree and assigns a partition spec per leaf
from its name, dimensionality and the mesh: the tensor-parallel layout
(megatron-style: attention heads, the FFN inner dim, the vocabulary and the
experts over 'model'; everything replicated over 'data'/'pod' unless ZeRO is
requested).  ``zero1_specs`` additionally shards the largest replicated dim
of each leaf over the data axes (optimizer-state sharding, ZeRO-1).

The rules are the reference's, verbatim.  A spec is a
:class:`PartitionSpec`: a tuple with one entry per tensor dim, each ``None``,
an axis name or a tuple of axis names, equal to ``tuple()`` of the
reference's ``jax.sharding.PartitionSpec``.  Trees are nested dicts,
NamedTuples, tuples and lists; a leaf is anything with a ``shape`` (a
tensor, a ``meta`` tensor).  :func:`named` turns specs into
``torch.distributed.tensor`` placements, one per mesh axis; no process group
is needed for that.

:func:`place` applies specs to tensors: each global tensor becomes a
:class:`ShardedTensor`, one block per mesh slot on the slot's device,
following :func:`named`'s placements; :func:`gather` joins the blocks back
into global tensors.  :class:`SlotViews` gives each computing (data slot,
model slot) the blocks it computes with under tensor parallelism: a leaf
split over ``model`` stays split, one under the data axes (``zero1_specs``)
is all-gathered over the data axes only.  :func:`reduce_to_placement` sums
the slots' gradients of those views into a placement's blocks.  Their
traffic goes through :mod:`repro_torch.launch.collectives`.
:class:`StateBlocks` hands each mesh slot its blocks of a decode state
placed by :func:`state_specs` (or of a whole state, as views of it) and
where each block lies in the global tensor, so that a decode step over the
mesh reads and writes each slot's own blocks in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import resolve_device
from .common import ModelConfig

__all__ = ["PartitionSpec", "ShardedTensor", "SlotViews", "StateBlocks", "StatePiece", "batch_spec",
           "gather", "make_batch_sharding", "model_dim", "model_split_dim", "named", "param_specs",
           "place", "reduce_to_placement", "slot_bytes", "state_specs", "write_piece",
           "zero1_specs"]

ATTN_PARENTS = {"attn", "self_attn", "cross_attn", "shared_attn"}


class PartitionSpec(tuple):
    """One spec entry per tensor dim; ``==`` a plain tuple of the entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") or isinstance(x, PartitionSpec)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree; ``path`` holds the names of the dict
    keys, NamedTuple fields and sequence indices above the leaf."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    raise TypeError(f"not a tree node or leaf: {type(tree).__name__}")


def _map2(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and the tree it was derived from."""
    leaves = {}
    _map_with_path(lambda p, x: leaves.__setitem__(p, x), tree)
    return _map_with_path(lambda p, s: fn(s, leaves[p]), specs)


def _shard_priority(names: list) -> tuple:
    """(base_ndim, priority list of base-dim indices to try for 'model').

    Base dims are counted from the END of the array shape (leading dims are
    layer stacks).  The first dim in priority order whose size divides the
    model-axis size gets the 'model' annotation."""
    name = names[-1]
    in_attn = any(n in ATTN_PARENTS for n in names[:-1])
    in_moe = "moe" in names[:-1]

    if name == "tok":
        return 2, [0, 1]
    if name == "unembed":
        return 2, [1, 0]
    if in_attn:
        if name in ("wq", "wk", "wv"):
            return 3, [1, 2, 0]      # heads, head_dim, d_model
        if name == "wo":
            return 3, [0, 1, 2]
        if name in ("bq", "bk", "bv"):
            return 2, [0, 1]
    if in_moe and name in ("wi", "wg"):
        return 3, [0, 2, 1]          # experts, ff, d_model
    if in_moe and name == "wo":
        return 3, [0, 1, 2]
    if name in ("wi", "wg"):
        return 2, [1, 0]
    if name in ("wo", "out", "down", "out_proj"):
        return 2, [0, 1]
    if name in ("in_proj", "up", "wx", "wq", "wk", "wv"):
        return 2, [1, 0]
    if name == "conv_w":
        return 2, [0]
    if name == "r":
        return 3, [1, 2]
    return 0, []


def model_split_dim(names, shape, msize: int):
    """The dim of a leaf named by ``names`` (its path) and of ``shape`` that
    :func:`param_specs` splits over a ``model`` axis of ``msize`` slots, or
    ``None``."""
    nd = len(shape)
    base_nd, prio = _shard_priority(list(names))
    if msize > 1 and base_nd and nd >= base_nd:
        off = nd - base_nd
        for b in prio:
            i = off + b
            if shape[i] % msize == 0 and shape[i] >= msize:
                return i
    return None


def param_specs(params, cfg: ModelConfig, mesh) -> dict:
    """Tree of :class:`PartitionSpec` matching ``params`` (tensor-parallel layout)."""
    msize = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def one(names, leaf):
        entries = [None] * len(leaf.shape)
        i = model_split_dim(names, tuple(leaf.shape), msize)
        if i is not None:
            entries[i] = "model"
        return P(*entries)

    return _map_with_path(one, params)


def _data_axes(mesh) -> tuple:
    """(data axes, their product, the spec entry of a dim sharded over them)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    return axes, size, entry


def zero1_specs(params, cfg: ModelConfig, mesh) -> dict:
    """Param specs with the largest remaining replicated dim additionally
    sharded over the data axes (for optimizer moments)."""
    base = param_specs(params, cfg, mesh)
    data_axes, dsize, entry = _data_axes(mesh)

    def one(spec, leaf):
        shape = tuple(leaf.shape)
        if dsize <= 1 or len(shape) == 0:
            return spec
        entries = list(spec) + [None] * (len(shape) - len(spec))
        # choose the largest None dim divisible by the data size
        cand = [(shape[i], i) for i, e in enumerate(entries)
                if e is None and shape[i] % dsize == 0 and shape[i] >= dsize]
        if not cand:
            return spec
        _, i = max(cand)
        entries[i] = entry
        return P(*entries)

    return _map2(one, base, params)


def named(tree_specs, mesh):
    """Each spec as ``torch.distributed.tensor`` placements, one per mesh
    axis in order: ``Shard(i)`` where tensor dim ``i`` names the axis (alone
    or in a tuple), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    def one(_, spec):
        out = []
        for axis in mesh.axis_names:
            dims = [i for i, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    return _map_with_path(one, tree_specs)


def batch_spec(mesh, *, batch_dims: int = 1) -> PartitionSpec:
    """Shard the leading batch dim over all data axes."""
    return P(_data_axes(mesh)[2])


def make_batch_sharding(mesh, batch_size: int) -> PartitionSpec:
    """The spec of a global batch of ``batch_size`` rows: the leading dim over
    the data axes where their product divides it, else replicated (the
    reference's ``data/pipeline.py::make_batch_sharding``)."""
    _, dsize, entry = _data_axes(mesh)
    return P(entry if entry is not None and batch_size % dsize == 0 else None)


# ---------------------------------------------------------------------------
# Decode-state sharding (KV caches, SSM states, ...)
# ---------------------------------------------------------------------------

_CACHE_FIELDS = {"k", "v", "cross_k", "cross_v"}
_BATCHED_FIELDS = {"conv", "ssm", "C", "n", "c", "m", "h", "pos", "positions"}


def state_specs(state, cfg: ModelConfig, mesh, batch: int) -> dict:
    """Partition specs for a decode-state tree.

    Rules: the batch dim shards over the data axes when divisible; for KV
    caches, if the batch cannot be sharded (B=1 long-context decode) the
    cache-length dim shards over 'data' instead (distributed flash-decoding);
    the kv-head dim (or failing divisibility, head_dim) shards over 'model'.
    Other state tensors shard their largest remaining divisible dim over
    'model'."""
    _, dsize, data_entry = _data_axes(mesh)
    msize = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def one(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)
        entries = [None] * nd
        # locate the batch dim: first dim whose size == batch
        bdim = next((i for i, s in enumerate(shape) if s == batch), None)
        batch_sharded = False
        if bdim is not None and dsize > 1 and batch % dsize == 0:
            entries[bdim] = data_entry
            batch_sharded = True
        if name in _CACHE_FIELDS and nd >= 4:
            # (..., B, C, K, hd)
            cdim, kdim, hdim = nd - 3, nd - 2, nd - 1
            if not batch_sharded and dsize > 1 and shape[cdim] % dsize == 0:
                entries[cdim] = data_entry
            if msize > 1 and shape[kdim] % msize == 0:
                entries[kdim] = "model"
            elif msize > 1 and shape[hdim] % msize == 0:
                entries[hdim] = "model"
        elif name == "positions" and nd >= 2:
            cdim = nd - 1
            if not batch_sharded and dsize > 1 and shape[cdim] % dsize == 0:
                entries[cdim] = data_entry
        elif name in _BATCHED_FIELDS and msize > 1:
            cand = [(shape[i], i) for i in range(nd)
                    if entries[i] is None and i != bdim
                    and shape[i] % msize == 0 and shape[i] >= msize]
            if cand:
                _, i = max(cand)
                entries[i] = "model"
        return P(*entries)

    return _map_with_path(one, state)


# ---------------------------------------------------------------------------
# Placement: specs applied to tensors on a mesh's slots
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A global tensor of ``shape`` placed on ``mesh`` by ``spec``:
    ``shards[s]`` is the block that row-major mesh slot ``s`` holds, on the
    slot's device.  Slots that hold the same block on the same device share
    one tensor, so a replicated weight on one card is held once."""

    shape: tuple
    spec: PartitionSpec
    mesh: object
    shards: tuple

    def counts(self) -> tuple:
        """Blocks per tensor dim."""
        return _counts(self.spec, self.mesh, len(self.shape))

    def block(self, slot: int) -> tuple:
        """Slot ``slot``'s block index per tensor dim."""
        return _block(self.spec, self.mesh, len(self.shape), slot)

    def region(self, slot: int) -> tuple:
        """Slot ``slot``'s block as slices of the global tensor."""
        return _region(self.shape, self.counts(), self.block(slot))

    def unique(self) -> list:
        """(first slot, tensor) of each distinct shard tensor, in slot order."""
        seen, out = set(), []
        for s, t in enumerate(self.shards):
            if id(t) not in seen:
                seen.add(id(t))
                out.append((s, t))
        return out


def _placements(spec, mesh) -> tuple:
    return named(spec, mesh)


def _counts(spec, mesh, nd: int) -> tuple:
    counts = [1] * nd
    for axis, pl in zip(mesh.axis_names, _placements(spec, mesh)):
        if hasattr(pl, "dim"):
            counts[pl.dim] *= mesh.shape[axis]
    return tuple(counts)


def _block(spec, mesh, nd: int, slot: int) -> tuple:
    """Block index per dim: over the axes that shard a dim, in mesh order,
    row-major (``Shard(d)`` on several axes splits ``d`` by the first one
    first, as ``torch.distributed.tensor`` and ``jax`` both do)."""
    coords = mesh.coords(slot)
    idx = [0] * nd
    for axis, pl in zip(mesh.axis_names, _placements(spec, mesh)):
        if hasattr(pl, "dim"):
            idx[pl.dim] = idx[pl.dim] * mesh.shape[axis] + coords[axis]
    return tuple(idx)


def _region(shape, counts, block) -> tuple:
    out = []
    for n, c, b in zip(shape, counts, block):
        if n % c:
            raise ValueError(f"a dim of {n} does not split into {c} blocks")
        step = n // c
        out.append(slice(b * step, (b + 1) * step))
    return tuple(out)


def _place_one(spec, leaf: torch.Tensor, mesh) -> ShardedTensor:
    devs = {d: resolve_device(d) for d in dict.fromkeys(mesh.devices)}
    shape, nd = tuple(leaf.shape), leaf.dim()
    spec = P(*(tuple(spec) + (None,) * (nd - len(spec))))
    counts = _counts(spec, mesh, nd)
    made, shards = {}, []
    with torch.no_grad():
        for s, dev in enumerate(mesh.devices):
            key = (_block(spec, mesh, nd, s), dev)
            if key not in made:
                made[key] = leaf.detach()[_region(shape, counts, key[0])].to(
                    devs[dev], copy=True).contiguous()
            shards.append(made[key])
    return ShardedTensor(shape, spec, mesh, tuple(shards))


def place(tree, specs, mesh):
    """Each tensor of ``tree`` placed on ``mesh``'s slots by its spec in
    ``specs`` (a spec tree of ``tree``'s structure, as :func:`param_specs`
    returns, or one spec for a single tensor): a :class:`ShardedTensor` of
    copies, one per distinct (block, device).  A CUDA slot without a card
    raises."""
    if mesh.devices is None:
        raise ValueError("place needs a concrete mesh (make_mesh)")
    if isinstance(tree, torch.Tensor):
        return _place_one(specs, tree, mesh)
    return _map2(lambda spec, leaf: _place_one(spec, leaf, mesh), specs, tree)


def _join(blocks: dict, counts: tuple, prefix: dict, dims: list, device) -> torch.Tensor:
    """The blocks at ``prefix`` joined along ``dims`` (a module function, not
    a recursive closure: a closure that calls itself is a reference cycle,
    which would keep ``blocks`` alive until the cyclic collector runs)."""
    from ..launch import collectives

    if not dims:
        return blocks[tuple(prefix.get(d, 0) for d in range(len(counts)))].to(device)
    d = dims[0]
    return collectives.gather_to([_join(blocks, counts, prefix | {d: i}, dims[1:], device)
                                  for i in range(counts[d])], d, device)


def _gather_one(st: ShardedTensor, device) -> torch.Tensor:
    from ..launch import collectives

    counts = st.counts()
    blocks = {}
    for s, t in enumerate(st.shards):
        blocks.setdefault(st.block(s), t)
    split = [d for d, c in enumerate(counts) if c > 1]
    if not split:
        return collectives.gather_to([blocks[(0,) * len(counts)]], 0, device) \
            if counts else st.shards[0].to(device, copy=True)
    return _join(blocks, counts, {}, split, device)


def gather(tree, device=None):
    """Each :class:`ShardedTensor` of ``tree`` joined into its global tensor
    (a new tensor) on ``device`` (the first slot's device by default); other
    leaves as they are."""
    def one(x):
        if not isinstance(x, ShardedTensor):
            return x
        dev = resolve_device(x.shards[0].device if device is None else device)
        return _gather_one(x, dev)
    return _map_leaves(one, tree)


def model_dim(spec):
    """The tensor dim that ``spec`` splits over the ``model`` axis, or ``None``."""
    for i, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return i
    return None


def _data_dim(spec):
    for i, e in enumerate(spec):
        if any(a in ("pod", "data") for a in (e if isinstance(e, tuple) else (e,))):
            return i
    return None


class _Grid:
    """One leaf's tensors per (computing data slot, model slot), and the dim
    its spec splits over ``model``."""

    __slots__ = ("cells", "dim")

    def __init__(self, cells, dim):
        self.cells, self.dim = cells, dim


def _model_size(mesh) -> int:
    return mesh.shape["model"] if "model" in mesh.axis_names else 1


class SlotViews:
    """What each computing slot of ``mesh`` computes with, tensor-parallel:
    for data slot ``data_slots[jj]`` and model slot ``m``, ``rows[jj][m]``
    is a tree of ``tree``'s structure whose leaves are the slot's blocks
    made whole over the data axes: a leaf split over ``model`` is the
    slot's shard, a leaf replicated over ``model`` is whole.  ``dims`` is
    the tree of the dim each leaf is split on over ``model`` (``None``:
    replicated).

    From placed state (:class:`ShardedTensor` leaves): a block that the
    data axes split (``zero1_specs``) is all-gathered over the data slots
    of its model slot, one tensor per model slot where those share a device;
    any other block is the slot's own.  From whole tensors: each leaf is
    cut over every data slot's model slots by its spec in ``specs``
    (``scatter``; ``broadcast`` where replicated), which copies nothing
    where a slot shares the tensor's device.  No slot receives a whole leaf
    that the specs split.

    With ``leaves``, every slot's leaf is a tensor object of its own (an
    alias of the block, ``detach``), so that autograd gives each slot its
    own gradient (the mesh train step; :func:`reduce_to_placement` sums
    them)."""

    def __init__(self, tree, mesh, data_slots, specs=None, leaves: bool = False):
        from ..launch import collectives

        self.mesh = mesh
        self.data_slots = list(data_slots)
        self.msize = _model_size(mesh)
        spec_of = {}
        if specs is not None:
            _map_with_path(lambda p, sp: spec_of.__setitem__(p, sp), specs)
        devs = [mesh.model_devices(j) for j in self.data_slots]

        def one(path, x):
            if isinstance(x, ShardedTensor):
                spec = x.spec
                cells = [[x.shards[mesh.slot(**mesh.data_coords(j), model=m)]
                          for m in range(self.msize)] for j in self.data_slots]
                dd = _data_dim(spec)
                if dd is not None:
                    for m in range(self.msize):
                        blocks = [x.shards[mesh.slot(**mesh.data_coords(j), model=m)]
                                  for j in range(_data_size(mesh))]
                        got = collectives.all_gather(blocks, dd, [d[m] for d in devs])
                        for jj in range(len(self.data_slots)):
                            cells[jj][m] = got[jj]
            else:
                spec = spec_of[path]
                k = model_dim(spec)
                cells = [collectives.scatter(x, k, d) if k is not None
                         else collectives.broadcast(x, d) for d in devs]
            if leaves:
                cells = [[c.detach() for c in row] for row in cells]
            return _Grid(cells, model_dim(spec))

        self._grid = _map_with_path(one, tree)
        self.dims = _map_leaves(lambda g: g.dim, self._grid)
        self.rows = [[_map_leaves(lambda g: g.cells[jj][m], self._grid)
                      for m in range(self.msize)] for jj in range(len(self.data_slots))]

    def subset(self, jjs) -> "SlotViews":
        """The views of the computing data slots at positions ``jjs``."""
        out = object.__new__(SlotViews)
        out.mesh, out.msize, out.dims, out._grid = self.mesh, self.msize, self.dims, self._grid
        out.data_slots = [self.data_slots[jj] for jj in jjs]
        out.rows = [self.rows[jj] for jj in jjs]
        return out

    def layer(self, jj: int, i: int, n_layers: int, key: str = "layers") -> list:
        """Layer ``i`` of the stacked subtree ``key``, one tree per model
        slot of computing data slot ``jj``: each leaf indexed at ``i`` on
        its layer axis; where the specs split that axis over ``model``, the
        slot that holds layer ``i`` has it whole and the others ``None``."""
        per = max(n_layers // self.msize, 1)
        return [_layer_of(self.rows[jj][m][key], self.dims[key], i, m, per)
                for m in range(self.msize)]

    def layer_dims(self, key: str = "layers"):
        """The dims of one layer's leaves split over ``model`` (as
        :attr:`dims`, the layer axis dropped): ``"owner"`` where the layer
        axis itself is split (one slot holds the layer whole)."""
        return _layer_dims(self.dims[key])

    def entry(self, jj: int, key: str, *idx) -> list:
        """Entry ``idx`` of the subtree ``key``, stacked on ``len(idx)``
        leading axes that the specs do not split (the hybrid's groups and
        their layers, the xLSTM's), one tree per model slot of computing
        data slot ``jj``."""
        return [_index_of(self.rows[jj][m][key], idx) for m in range(self.msize)]

    def entry_dims(self, key: str, n: int):
        """The dims of :meth:`entry`'s leaves split over ``model`` (the
        ``n`` stacked axes dropped)."""
        return _entry_dims(self.dims[key], n)


class _Blocks:
    """One state leaf on a mesh: ``blocks[s]`` mesh slot ``s``'s block,
    ``regions[s]`` where it lies in the global tensor (a slice per dim),
    ``spec`` the placement."""

    __slots__ = ("blocks", "regions", "spec", "shape")

    def __init__(self, blocks, regions, spec, shape):
        self.blocks, self.regions, self.spec, self.shape = blocks, regions, spec, shape

    def find(self, index: dict, slots) -> int:
        """The first of ``slots`` whose block covers ``index`` (dim -> slice
        or int of the global tensor), or ``None``."""
        for s in slots:
            reg = self.regions[s]
            if all(_covers(reg[d], i) for d, i in index.items()):
                return s
        return None

    def local(self, s: int, index: dict) -> tuple:
        """Slot ``s``'s block indexed at ``index`` given in global
        coordinates (a view)."""
        reg = self.regions[s]
        idx = [slice(None)] * len(reg)
        for d, i in index.items():
            lo = reg[d].start
            idx[d] = i - lo if isinstance(i, int) else slice(i.start - lo, i.stop - lo)
        return self.blocks[s][tuple(idx)]


def _covers(region: slice, i) -> bool:
    if isinstance(i, int):
        return region.start <= i < region.stop
    return region.start <= i.start and i.stop <= region.stop


class StatePiece(NamedTuple):
    """One model slot's part of a recurrent state leaf at a stacked index
    and the rows a data slot computes: ``old`` the part as it stands, on
    the computing slot's device (a view of the slot's own block, or a copy
    read from the data slot that holds it); ``region`` where the holding
    block lies in the global tensor (a slice per dim); ``holders`` one view
    per distinct storage that holds the part (the block's replicas over the
    data slots, each written once); ``replicas`` one view per mesh slot
    that holds it, storage shared or not; ``remote`` whether each holder
    lies on another data slot than the computing one."""
    old: torch.Tensor
    region: tuple
    holders: list
    remote: list
    replicas: list


def _leaf_key(path: tuple) -> str:
    """A state leaf's key in :class:`StateBlocks`: its whole path, so that
    two leaves of one name (the xLSTM's ``ml.n`` and ``sl.n``) stay apart."""
    return "/".join(path)


class StateBlocks:
    """Each mesh slot's blocks of a decode-state tree (nested NamedTuples of
    tensors): from a tree placed by :func:`state_specs`
    (:class:`ShardedTensor` leaves) its shards; from a tree of whole tensors
    the regions ``state_specs`` would give each slot, as views of the whole
    tensor (a slot whose device is not the tensor's raises: a write there
    would not reach the tensor).  ``leaves[key]`` is a :class:`_Blocks`
    per leaf, keyed by its path joined by ``/`` (``k``, ``pos`` for a
    ``KVCache``; ``ml/n`` and ``sl/n`` for the xLSTM's state).  Nothing is
    copied, so a write into a block updates the state in place."""

    def __init__(self, tree, cfg: ModelConfig, mesh, batch: int):
        leaves, spec_of = {}, {}
        _map_with_path(lambda p, x: leaves.__setitem__(p, x), tree)
        if not all(isinstance(x, ShardedTensor) for x in leaves.values()):
            _map_with_path(lambda p, sp: spec_of.__setitem__(p, sp),
                           state_specs(tree, cfg, mesh, batch))
        self.mesh = mesh
        self.leaves = {_leaf_key(path): _placed_blocks(x, mesh) if isinstance(x, ShardedTensor)
                       else _view_blocks(x, spec_of[path], mesh) for path, x in leaves.items()}

    def data_dims(self) -> dict:
        """Leaf key -> the dim its placement splits over the data axes."""
        return {n: _data_dim(b.spec) for n, b in self.leaves.items()}

    def piece(self, key: str, index: dict, j: int, m: int, device) -> StatePiece:
        """Model slot ``m``'s part of leaf ``key`` at ``index`` (dim -> int
        or slice of the global tensor: the stacked layer indices and the
        rows) for data slot ``j`` computing on ``device``: read from the
        data slot ``j``'s own block where it covers ``index``, else from the
        first data slot's whose block does (a placement may split a stacked
        axis over the data slots where its size equals the batch, as the
        reference's ``state_specs`` does), moved to ``device``."""
        from ..launch import collectives
        from ..launch.mesh import data_axis_size

        b, mesh = self.leaves[key], self.mesh
        order = [j] + [jj for jj in range(data_axis_size(mesh)) if jj != j]
        slots = [mesh.slot(**mesh.data_coords(jj), model=m) for jj in order]
        covering = [(jj, s) for jj, s in zip(order, slots) if b.find(index, [s]) is not None]
        if not covering:
            raise ValueError(f"no mesh slot of model slot {m} holds {key} at {index}")
        jj0, s0 = covering[0]
        old = b.local(s0, index)
        if jj0 != j:
            old = collectives.broadcast(old, [device])[0]
        seen, holders, remote = set(), [], []
        for jj, s in covering:
            if id(b.blocks[s]) not in seen:
                seen.add(id(b.blocks[s]))
                holders.append(b.local(s, index))
                remote.append(jj != j)
        return StatePiece(old, b.regions[s0], holders, remote,
                          [b.local(s, index) for _, s in covering])


def write_piece(piece: StatePiece, new: torch.Tensor) -> None:
    """``new`` (computed from ``piece.old`` before any write) copied into
    each distinct storage that holds the piece, once: into a holder on the
    computing data slot in place, into one on another data slot after a
    broadcast to its device."""
    from ..launch import collectives

    for view, far in zip(piece.holders, piece.remote):
        view.copy_(collectives.broadcast(new, [view.device])[0] if far else new)


def _placed_blocks(x: ShardedTensor, mesh) -> _Blocks:
    return _Blocks(x.shards, tuple(x.region(s) for s in range(mesh.size)), x.spec, x.shape)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` is the current card)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def _view_blocks(x: torch.Tensor, spec, mesh) -> _Blocks:
    """A whole tensor's blocks by ``spec`` as views of it; slots with the
    same region share one view, as placed shards on one device do."""
    for dev in dict.fromkeys(mesh.devices):
        if not _same_device(resolve_device(dev), x.device):
            raise ValueError(f"a whole decode state on {x.device} cannot be decoded in place by "
                             f"a mesh slot on {dev}: place it (sharding.place(state, "
                             f"state_specs(...), mesh))")
    spec = P(*(tuple(spec) + (None,) * (x.dim() - len(spec))))
    shape, nd = tuple(x.shape), x.dim()
    counts = _counts(spec, mesh, nd)
    regions = tuple(_region(shape, counts, _block(spec, mesh, nd, s)) for s in range(mesh.size))
    views = {}
    for reg in regions:
        views.setdefault(tuple((r.start, r.stop) for r in reg), x[reg])
    return _Blocks(tuple(views[tuple((r.start, r.stop) for r in reg)] for reg in regions),
                   regions, spec, shape)


def _layer_of(tree, dims, i: int, m: int, per: int):
    if isinstance(tree, dict):
        return {k: _layer_of(tree[k], dims[k], i, m, per) for k in tree}
    if dims == 0:
        owner = i // per
        return tree[i - owner * per] if m == owner else None
    return tree[i]


def _index_of(tree, idx: tuple):
    if isinstance(tree, dict):
        return {k: _index_of(v, idx) for k, v in tree.items()}
    return tree[idx]


def _entry_dims(dims, n: int):
    if isinstance(dims, dict):
        return {k: _entry_dims(v, n) for k, v in dims.items()}
    if dims is not None and dims < n:
        raise ValueError(f"a stacked axis (dim {dims}) is split over model")
    return None if dims is None else dims - n


def _layer_dims(dims):
    if isinstance(dims, dict):
        return {k: _layer_dims(v) for k, v in dims.items()}
    return None if dims is None else ("owner" if dims == 0 else dims - 1)


def _data_size(mesh) -> int:
    return _data_axes(mesh)[1]


def reduce_to_placement(slot_grads: list, like: ShardedTensor) -> ShardedTensor:
    """The gradients of a leaf's :class:`SlotViews` (``slot_grads[jj][m]``
    computing data slot ``jj``'s model slot ``m``'s, of the view's shape)
    summed in float32 into the blocks of ``like``'s placement: each slot's
    block on the slot's device.  A leaf split over ``model`` sums its model
    slot's gradients over the data slots; a leaf replicated over ``model``
    first sums each data slot's model slots (its views each met a part of
    the rows' gradient), then the data slots.  Every sum runs in slot
    order (a reduce-scatter over the data axes, after an all-reduce over
    ``model`` for a replicated leaf)."""
    from ..launch import collectives

    k = model_dim(like.spec)
    made, shards = {}, []
    for s, dev in enumerate(like.mesh.devices):
        key = (like.block(s), dev)
        if key not in made:
            region = list(like.region(s))
            m_s = like.mesh.coords(s).get("model", 0)
            if k is not None:
                region[k] = slice(None)
                parts = [row[m_s][tuple(region)].float() for row in slot_grads]
            else:
                region = tuple(region)
                parts = [collectives.psum([g[region].float() for g in row], dev)
                         if len(row) > 1 else row[0][region].float() for row in slot_grads]
            made[key] = collectives.psum(parts, dev)
        shards.append(made[key])
    return ShardedTensor(like.shape, like.spec, like.mesh, tuple(shards))


def slot_bytes(tree, specs, mesh) -> int:
    """The bytes one slot of ``mesh`` holds of ``tree`` placed by ``specs``
    (every slot holds as many), computed from the specs: no tensor is
    placed, so ``tree`` may hold ``meta`` tensors."""
    total = []

    def one(spec, leaf):
        counts = _counts(spec, mesh, leaf.dim())
        total.append(math.prod(n // c for n, c in zip(leaf.shape, counts))
                     * leaf.element_size())
    _map2(one, specs, tree)
    return sum(total)


def _map_leaves(fn, tree):
    """``fn`` over the leaves of nested dicts, NamedTuples, tuples and lists
    (a :class:`ShardedTensor` is a leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)
