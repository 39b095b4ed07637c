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
is needed for that.  The specs are not yet applied to tensors: the data and
model axes in execution wait for a later slice (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from .common import ModelConfig

__all__ = ["PartitionSpec", "batch_spec", "make_batch_sharding", "named", "param_specs",
           "state_specs", "zero1_specs"]

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


def param_specs(params, cfg: ModelConfig, mesh) -> dict:
    """Tree of :class:`PartitionSpec` matching ``params`` (tensor-parallel layout)."""
    msize = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def one(names, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        base_nd, prio = _shard_priority(list(names))
        entries = [None] * nd
        if msize > 1 and base_nd and nd >= base_nd:
            off = nd - base_nd
            for b in prio:
                i = off + b
                if shape[i] % msize == 0 and shape[i] >= msize:
                    entries[i] = "model"
                    break
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
