"""The op analysis of one step of the port (the counterpart of the
reference's ``launch/hlo_analysis.py``).

The reference parses the optimized HLO text of a compiled step.  The port
has no HLO: its program is eager PyTorch, so this module counts the aten ops
the port dispatches, as a ``TorchDispatchMode`` entered around the step
(:class:`OpAnalysis`).  It works alike on ``meta`` tensors (the dry run,
which allocates nothing) and on real ones, so a dry run's counts can be
held equal to those of a real run on the card.  A Python loop dispatches
its ops as many times as it runs, so the reference's trip-count parsing has
no counterpart.

What :meth:`OpAnalysis.result` reports, in the reference's keys:

- ``dot_flops``: 2 m n k for each contraction (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``addbmm``, ``mv``, ``addmv``, ``dot``, ``vdot``, and
  ``convolution`` / ``convolution_backward`` at 2 per multiply-add), plus the
  operations of the contraction kernels (flash attention, decode attention,
  the SSD) at each launch.
- ``bytes_accessed`` and ``bytes_by_kind`` (per aten op name, and per model
  kernel name): every op that materialises a result reads each tensor
  operand once and writes each result once.  A view (``view``,
  ``_unsafe_view``, ``transpose``, ``permute``, ``expand``, ``slice``,
  ``select``, ``as_strided``, ... : every op whose results alias an
  operand) costs nothing, nor does an op that only allocates (``empty``,
  ``empty_like``, ``empty_strided``, ``new_empty``).  An in-place or
  ``out=`` op (``copy_``, ``add_``, ``index_put_``, ...) reads its other
  operands and writes the slice it writes: the written operand's elements
  (a view's own), or for an indexed write (``index_put_``, ``index_copy_``,
  ``index_add_``, ``scatter_``, ...) its values' elements; it is not charged
  for reading what it overwrites.  A model kernel's launch adds the bytes of
  its bound (:func:`repro_torch.kernels.build.note_launch`).  The
  collectives' own copies and sums are ops like any other and are counted
  here; their traffic is not added a second time.
- ``collective_bytes``, ``collectives`` and ``collective_counts``: the
  change of :data:`repro_torch.launch.collectives.TRAFFIC` over the step
  (that module carries all traffic between the slots of a mesh), bytes and
  calls per kind of operation.
- ``detail``: the rows of most bytes, each ``[bytes, calls, op, issuer]``,
  where the issuer is the innermost ``repro_torch.models`` function on the
  stack (else the innermost ``repro_torch`` one; an op that autograd's
  backward pass dispatches outside Python is ``backward:<node>``).  This
  replaces the reference's HLO ``op_name``.  ``dot_detail`` the same for
  the contractions, by operations.
- ``launches``: hand-written kernel launches by kernel name, on the card
  and stood in for on ``meta`` alike.
- Inside :func:`repro_torch.launch.collectives.counted_as` (a block that
  computes one of ``n`` symmetric slots) every op, launch and collective
  counts ``n`` times; the live bytes (``peak_bytes``) are those the block
  really allocated.
- ``unknown_loops`` is always empty and ``n_computations`` counts the
  distinct aten ops dispatched (the reference's HLO computations).
- ``per_device``: ``dot_flops``, ``bytes_accessed`` and ``collective_bytes``
  divided by ``computing_devices``, the slots that compute (every model
  slot of each data slot that took rows for the transformer families'
  train and prefill steps, tensor-parallel; one for a step that runs on
  one device), the counterpart of the reference's per-device numbers: one
  process runs every slot's work, and the quotient is that work spread
  evenly over the slots that do it.
  :func:`repro_torch.launch.perf_probe.probe_to_workload` multiplies them
  back by ``computing_devices``.

Speed: on ``meta`` tensors an op's result depends only on its operands'
shapes, strides and dtypes and its other arguments, and many of PyTorch's
meta kernels are Python (hundreds of microseconds an op); so the mode keeps
the result's layout for each such signature and makes the result of a
repeated op with ``empty_strided`` (an op that is not a view and writes in
place nothing).  A full-width cell runs its layers and slots with the same
signatures over and over, so this changes no count and cuts the dry run's
time.

Memory: the mode tracks every storage an op allocates (a non-view result)
through a finalizer on the storage, and keeps the peak of the bytes alive
at once over the step (``peak_bytes``).
What the dry run makes of that peak for one slot is in
:mod:`repro_torch.launch.dryrun`.
"""

from __future__ import annotations

import collections
import functools
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import build as kbuild
from . import collectives

__all__ = ["CONTRACTIONS", "KERNEL_CONTRACTIONS", "OpAnalysis", "analyze"]

CONTRACTIONS = ("mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
                "convolution", "convolution_backward")
# the model kernels whose operations are contractions (they count in dot_flops)
KERNEL_CONTRACTIONS = ("flash_attention", "decode_attention", "ssd_intra_chunk")
# ops that only allocate: nothing read, nothing written
_ALLOCATE_ONLY = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# views whose schemas do not say they alias
_VIEWS = {"_unsafe_view", "_reshape_alias", "lift_fresh"}
# in-place writes of indexed positions: the written bytes are the values'
_INDEXED = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3, "index_add_": 3,
            "scatter_": 3, "scatter_add_": 3, "scatter_reduce_": 3, "masked_scatter_": 2}
_TOP = 40


def _plan(func) -> tuple:
    """How the mode treats ``func``: (kind, op name, written argument
    positions, written keyword names, position of an indexed write's
    values).  Kind is ``"composite"`` (decomposed), ``"view"``, ``"alloc"``,
    ``"write"`` (in-place or ``out=``) or ``"op"``."""
    name = func.overloadpacket.__name__
    if torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), "CompositeImplicitAutograd"):
        return "composite", name, (), (), None
    if name in _ALLOCATE_ONLY:
        return "alloc", name, (), (), None
    schema = func._schema
    written = tuple(i for i, a in enumerate(schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
    if written:
        names = tuple(schema.arguments[i].name for i in written)
        return "write", name, written, names, _INDEXED.get(name)
    if name in _VIEWS or (schema.returns and all(r.alias_info is not None
                                                  for r in schema.returns)):
        return "view", name, (), (), None
    return "op", name, (), (), None


def _bytes_of(x) -> int:
    """Bytes of the tensors in an argument or a result."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    n = 0
    if isinstance(x, (list, tuple)):
        for y in x:
            if isinstance(y, torch.Tensor):
                n += y.numel() * y.element_size()
    return n


def _contraction_flops(name: str, args: list, out) -> int:
    """2 x multiply-adds of a contraction op."""
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
        return 2 * a.numel() * b.shape[-1]
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
        return 2 * a.numel() * b.shape[-1]
    if name == "addbmm":
        a, b = args[1], args[2]
        return 2 * a.numel() * b.shape[-1]
    if name in ("mv", "dot", "vdot"):
        return 2 * args[0].numel()
    if name == "addmv":
        return 2 * args[1].numel()
    if name == "convolution":
        w = args[1]
        return 2 * out.numel() * (w.numel() // w.shape[0])
    if name == "convolution_backward":
        grad_out, w = args[0], args[2]
        mask = args[-1]
        per = 2 * grad_out.numel() * (w.numel() // w.shape[0])
        return per * (int(bool(mask[0])) + int(bool(mask[1])))
    return 0


_NO_KEY = object()


def _arg_key(a):
    """A hashable key of one op argument on ``meta`` tensors, or
    ``_NO_KEY`` for one that is not meta or not hashable."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype) if a.is_meta else _NO_KEY
    if isinstance(a, (list, tuple)):
        out = tuple(_arg_key(b) for b in a)
        return _NO_KEY if _NO_KEY in out else out
    if a is None or isinstance(a, (int, float, bool, str, torch.dtype, torch.device,
                                   torch.memory_format, torch.layout)):
        return (type(a), a)
    return _NO_KEY


def _signature(func, args, kwargs):
    """A hashable key of an op's call on ``meta`` tensors (the operands'
    shapes, strides and dtypes, the other arguments with their types), or
    ``None`` where an argument is not meta or not hashable."""
    key = [func]
    for a in args:
        k = _arg_key(a)
        if k is _NO_KEY:
            return None
        key.append(k)
    for name, a in kwargs.items():
        k = _arg_key(a)
        if k is _NO_KEY:
            return None
        key.append((name, k))
    return tuple(key)


def _layout(out):
    """The results' layouts (shape, stride, dtype), or ``None`` where a
    result is not a meta tensor."""
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) if out.device.type == "meta" else None
    if isinstance(out, (list, tuple)):
        parts = [_layout(t) for t in out]
        return None if any(p is None for p in parts) else (type(out), parts)
    return None


def _make(layout):
    if isinstance(layout[0], type):
        return layout[0](_make(p) for p in layout[1])
    shape, stride, dtype = layout
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _issuer() -> str:
    """The innermost ``repro_torch.models`` function on the stack, else the
    innermost ``repro_torch`` one outside this module, else the autograd node
    being run."""
    f = sys._getframe(2)
    first = None
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.models"):
            return f"{mod[len('repro_torch.'):]}.{f.f_code.co_name}"
        if first is None and mod.startswith("repro_torch") and mod != __name__:
            first = f"{mod[len('repro_torch.'):]}.{f.f_code.co_name}"
        f = f.f_back
    if first is not None:
        return first
    node = torch._C._current_autograd_node()
    return f"backward:{node.name()}" if node is not None else "?"


class OpAnalysis(TorchDispatchMode):
    """Counts the ops dispatched inside the ``with`` block (see the module
    docstring); :meth:`result` reads the counts."""

    def __init__(self, devices: int = 1, detail: bool = True, computing: int = None):
        super().__init__()
        self.devices = int(devices)
        self.computing = int(computing or devices)
        self.detail = detail
        self.dot_flops = 0
        self.bytes_by_kind = collections.Counter()
        self.launches = collections.Counter()
        self.rows = collections.defaultdict(lambda: [0, 0])
        self.dot_rows = collections.defaultdict(lambda: [0, 0])
        self.live = {}          # id(storage) -> (bytes, weak reference)
        self.peak_total = 0
        self._total = 0
        self._plans = {}
        self._traffic0 = {}
        self._depth = 0
        self._memo = {}

    # -- the mode ---------------------------------------------------------
    def __enter__(self):
        self._depth += 1
        if self._depth == 1:
            self._traffic0 = {op: list(v) for op, v in collectives.TRAFFIC.items()}
            kbuild.LAUNCH_LISTENERS.append(self._launch)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._end()

    def _end(self) -> None:
        kbuild.LAUNCH_LISTENERS.remove(self._launch)
        self._collectives = {
            op: [v[0] - self._traffic0.get(op, [0, 0])[0],
                 v[1] - self._traffic0.get(op, [0, 0])[1]]
            for op, v in collectives.TRAFFIC.items()}
        self.live.clear()      # the weak references go, and their callbacks with them

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if kwargs is None:
            kwargs = {}
        plan = self._plans.get(func)
        if plan is None:
            plan = self._plans[func] = _plan(func)
        what, name = plan[0], plan[1]
        if what == "composite":
            # under inference mode a composite op (matmul, einsum, softmax)
            # reaches the mode whole; count the ops it is made of, as
            # autograd's dispatch gives them outside inference mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
            what = "op"
        if what == "view":
            return func(*args, **kwargs)
        if what == "op":
            sig = _signature(func, args, kwargs)
            hit = self._memo.get(sig) if sig is not None else None
            if hit is not None:
                layout, cost, flops = hit
                out = _make(layout)
            else:
                out = func(*args, **kwargs)
                cost = _bytes_of(out)
                for a in args:
                    cost += _bytes_of(a)
                for a in kwargs.values():
                    cost += _bytes_of(a)
                flops = _contraction_flops(name, args, out) if name in CONTRACTIONS else 0
                if sig is not None:
                    layout = _layout(out)
                    if layout is not None:
                        self._memo[sig] = (layout, cost, flops)
            self._track(out)
        elif what == "alloc":
            out = func(*args, **kwargs)
            self._track(out)
            return out
        else:
            out = func(*args, **kwargs)
            written, wnames, indexed = plan[2], plan[3], plan[4]
            reads = writes = 0
            for i, a in enumerate(args):
                if i in written:
                    if indexed is None:
                        writes += _bytes_of(a)
                else:
                    reads += _bytes_of(a)
            for k, a in kwargs.items():
                if k in wnames:
                    writes += _bytes_of(a)
                else:
                    reads += _bytes_of(a)
            if indexed is not None and len(args) > indexed:
                writes += _bytes_of(args[indexed])
            cost = reads + writes
            flops = 0
        n = collectives.count_scale()
        cost, flops = cost * n, flops * n
        self.bytes_by_kind[name] += cost
        if flops:
            self.dot_flops += flops
        if self.detail:
            issuer = _issuer()
            if cost:
                row = self.rows[(name, issuer)]
                row[0] += cost
                row[1] += n
            if flops:
                row = self.dot_rows[(name, issuer)]
                row[0] += flops
                row[1] += n
        return out

    # -- kernels ----------------------------------------------------------
    def _launch(self, name: str, nbytes: int, flops: int) -> None:
        n = collectives.count_scale()
        nbytes, flops = nbytes * n, flops * n
        self.launches[name] += n
        self.bytes_by_kind[name] += nbytes
        issuer = _issuer() if self.detail else ""
        if self.detail:
            row = self.rows[(name, issuer)]
            row[0] += nbytes
            row[1] += n
        if name in KERNEL_CONTRACTIONS:
            self.dot_flops += flops
            if self.detail:
                row = self.dot_rows[(name, issuer)]
                row[0] += flops
                row[1] += n

    # -- memory -----------------------------------------------------------
    def _track(self, out) -> None:
        for t in ((out,) if isinstance(out, torch.Tensor) else out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.live:
                continue
            n = st.nbytes()
            self.live[key] = (n, weakref.ref(st, functools.partial(self._free, key)))
            self._total += n
            if self._total > self.peak_total:
                self.peak_total = self._total

    def _free(self, key, _ref=None) -> None:
        entry = self.live.pop(key, None)
        if entry is not None:
            self._total -= entry[0]

    # -- the result -------------------------------------------------------
    def result(self) -> dict:
        coll = getattr(self, "_collectives", None)
        if coll is None:
            raise RuntimeError("the analysis has not ended: read it after the with block")
        coll = {op: v for op, v in coll.items() if v[0]}
        total = sum(self.bytes_by_kind.values())
        collective_bytes = float(sum(v[1] for v in coll.values()))
        n, k = max(self.devices, 1), max(self.computing, 1)

        def top(rows):
            return [[float(v[0]), v[1], op, who] for (op, who), v in
                    sorted(rows.items(), key=lambda kv: -kv[1][0])[:_TOP]]

        return {
            "dot_flops": float(self.dot_flops),
            "bytes_accessed": float(total),
            "bytes_by_kind": {k: float(v) for k, v in sorted(self.bytes_by_kind.items()) if v},
            "collective_bytes": collective_bytes,
            "collectives": {op: float(v[1]) for op, v in sorted(coll.items())},
            "collective_counts": {op: int(v[0]) for op, v in sorted(coll.items())},
            "launches": dict(sorted(self.launches.items())),
            "unknown_loops": [],
            "n_computations": sum(1 for plan in self._plans.values() if plan[0] != "composite"),
            "devices": n,
            "computing_devices": k,
            "per_device": {"dot_flops": self.dot_flops / k, "bytes_accessed": total / k,
                           "collective_bytes": collective_bytes / k},
            "peak_bytes": int(self.peak_total),
            "detail": top(self.rows) if self.detail else None,
            "dot_detail": top(self.dot_rows) if self.detail else None,
        }


def analyze(fn, *args, devices: int = 1, detail: bool = True, computing: int = None,
            **kwargs) -> tuple:
    """``fn(*args, **kwargs)`` under an :class:`OpAnalysis` of a mesh of
    ``devices`` slots, ``computing`` of which compute (all by default):
    returns (its result, the analysis)."""
    with OpAnalysis(devices, detail, computing) as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
