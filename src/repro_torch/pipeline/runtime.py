"""Pipeline runtime executing a planner StagePlan (the port of the
reference's ``pipeline/runtime.py``).

The paper's interval mapping becomes executable here:

 1. :func:`make_stage_params` packs the stacked per-layer weights (L, ...)
    into padded per-pod stacks (num_pods, L_max, ...) + a validity mask,
    following the plan's (possibly unequal) intervals: heterogeneous-speed
    pods get intervals sized by the paper's heuristics.
 2. :func:`pipelined_loss_fn` runs a differentiable GPipe pipeline in one
    process: the tick loop of :func:`~.schedule.gpipe_ticks`, where at tick
    ``t`` the pod at chain position ``j`` runs microbatch ``t - j``; a pod's
    output goes to the next pod of the plan's chain (the paper's delta/b
    edges, the reference's ``ppermute``).  Backward is autograd through the
    ticks (the reversed pipeline), each stage step recomputed
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint(tick_fn)``).

On a mesh whose other axes (``data``, ``model``) have more than one slot,
each pod's stage runs over its pod's slots, as the reference's GSPMD runs
it inside the stage ``shard_map`` (``P("pod", *param_specs)`` stacks, the
batch over ``data``): a microbatch's rows are scattered over the pod's data
slots, each data slot computes tensor-parallel over its model slots from
their blocks of the stage's stack (:class:`repro_torch.models.sharding.SlotViews`,
``transformer._grid_block``), and the hand-off sends each slot's residual
rows to the slot at the same place in the next pod
(:func:`repro_torch.launch.collectives.ppermute`).  Each step runs under
its pod's sub-mesh (:meth:`repro_torch.launch.mesh.Mesh.submesh`), never the
whole mesh, whose stage axis the model code would read as data slots.

The executor runs only the (pod, tick) steps whose microbatch is live, and
only the unmasked slots of a pod's stack.  The reference computes every pod
at every tick over every slot and throws the rest away with ``jnp.where``,
through which no gradient passes, so the losses and the gradients are the
same; unenrolled pods and padding slots get zero gradients.  One process
drives every pod (the reference's ``shard_map`` runs one program per
device), so pods may share a card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.planner import StagePlan
from ..launch import collectives
from ..launch.mesh import use_mesh
from ..models import sharding
from ..models.common import ModelConfig, symmetric_data
from ..models.layers import (embed, embed_row, index_tree, rms_norm, seq_blocks, unembed,
                             unembed_row)
from ..models.train import _nll_sums_row, cross_entropy
from ..models.transformer import (_grid_block, _maybe_remat, block_forward, seq_parallel,
                                  train_forward)
from ..optim.tree import tree_map
from .schedule import gpipe_ticks

__all__ = ["PipelineSpec", "make_stage_mask", "make_stage_params", "on_grid",
           "pipelined_loss_fn", "pod_devices", "sequential_loss_fn"]


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    num_stages: int
    layers_per_stage: int            # padded depth L_max
    num_microbatches: int
    stage_axis: str = "stage"


def make_stage_params(layer_params, plan: StagePlan, num_pods: int, devices=None, *,
                      mesh=None, cfg: ModelConfig = None, stage_axis: str = "stage"):
    """Pack (L, ...) stacked layer weights into per-POD stacks
    (num_pods, L_max, ...) + validity mask (num_pods, L_max).

    The paper's mapping allocates interval j to processor alloc(j); weights of
    interval j therefore land in pod slot alloc(j), pods not enrolled by the
    plan stay empty (all-masked) and just idle.  Padding slots carry zeros and
    are masked to identity in the stage body.  The stacks are new tensors
    (copies) on the weights' device.

    With ``devices`` (one per pod, e.g. :func:`pod_devices` of the mesh the
    loss runs on) the stacks come as a list of per-pod trees (L_max, ...),
    pod ``p``'s placed on ``devices[p]`` once, so that the loss moves only
    activations from pod to pod.

    With ``mesh`` (and ``cfg``) the stacks come as a list of per-pod trees
    of :class:`repro_torch.models.sharding.ShardedTensor`: pod ``p``'s
    (L_max, ...) stack placed over its sub-mesh (``mesh.submesh(stage_axis,
    p)``) by ``param_specs`` of the layer stack, the reference's
    ``P(stage_axis, *param_specs)``; each model slot holds only its block.
    """
    Lmax = plan.max_stage_size
    sizes = plan.stage_sizes
    alloc = plan.mapping.alloc
    assert max(alloc) < num_pods, (alloc, num_pods)
    starts = np.cumsum([0] + list(sizes))[:-1]

    def pack(leaf, pods=range(num_pods)):
        out = torch.zeros((len(pods), Lmax) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                          device=leaf.device)
        for j, (start, size) in enumerate(zip(starts, sizes)):
            if alloc[j] in pods:
                out[pods.index(alloc[j]), :size] = leaf[int(start):int(start) + size]
        return out

    if mesh is not None:
        if mesh.shape[stage_axis] != num_pods:
            raise ValueError(f"the mesh's {stage_axis!r} axis has {mesh.shape[stage_axis]} "
                             f"slices for {num_pods} pods")
        stages = []
        for p in range(num_pods):
            sub = mesh.submesh(stage_axis, p)
            stack = tree_map(lambda leaf: pack(leaf, [p])[0], layer_params)
            specs = sharding.param_specs({"layers": stack}, cfg, sub)["layers"]
            stages.append(sharding.place(stack, specs, sub))
            del stack
        return stages, make_stage_mask(plan, num_pods)
    stages = tree_map(pack, layer_params)
    if devices is not None:
        stages = [tree_map(lambda t: t[p].to(devices[p], copy=True), stages)
                  for p in range(num_pods)]
    return stages, make_stage_mask(plan, num_pods)


def make_stage_mask(plan: StagePlan, num_pods: int) -> torch.Tensor:
    """(num_pods, L_max) bool validity mask for the plan (no weights needed),
    on the host: the executor reads it to choose the slots it runs."""
    mask = torch.zeros((num_pods, plan.max_stage_size), dtype=torch.bool)
    for j, size in enumerate(plan.stage_sizes):
        mask[plan.mapping.alloc[j], :size] = True
    return mask


def pod_devices(num_pods: int, default: torch.device, mesh=None,
                stage_axis: str = "stage") -> list:
    """The device each pod runs on: ``default`` for every pod without a
    mesh; with one, the first device of the mesh's ``stage_axis`` slice of
    that pod."""
    if mesh is None:
        return [torch.device(default)] * num_pods
    if mesh.shape[stage_axis] != num_pods:
        raise ValueError(f"the mesh's {stage_axis!r} axis has {mesh.shape[stage_axis]} "
                         f"slices for {num_pods} pods")
    return [mesh.axis_devices(stage_axis, p)[0] for p in range(num_pods)]


def _stage_fn(stage_layers, mask, x, cfg: ModelConfig, positions):
    """Run this stage's live slots (``mask``: a bool per slot); masked slots
    are identity."""
    for i, live in enumerate(mask):
        if live:
            x, _ = block_forward(index_tree(stage_layers, i), x, cfg, positions)
    return x


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def _refuse_kernels(cfg: ModelConfig) -> None:
    if cfg.use_pallas:
        raise ValueError(
            f"{cfg.arch_id}: the pipelined loss differentiates the plain versions only; "
            "the hand-written kernels' outputs carry no gradient, so use_pallas must be "
            "off under autograd")


def on_grid(mesh, stage_axis: str = "stage") -> bool:
    """Whether :func:`pipelined_loss_fn` runs each pod's stage over its
    pod's slots on ``mesh``: some axis beside ``stage_axis`` has more than
    one slot."""
    return mesh is not None and any(n > 1 for a, n in mesh.shape.items() if a != stage_axis)


def pipelined_loss_fn(cfg: ModelConfig, plan: StagePlan, num_microbatches: int,
                      mask, mesh=None, stage_axis: str = "stage") -> Callable:
    """Returns loss(params, batch) running the plan's pipeline.

    params = {"embed": ..., "stages": (num_pods, L_max, ...) packed tree or a
    list of per-pod trees, "ln_f": ...}; ``mask`` (num_pods, L_max) bool, as
    :func:`make_stage_params` returns it (it receives no gradient); batch =
    {"tokens": (B, S_seq), "labels": (B, S_seq)} with B divisible by
    ``num_microbatches``.  The loss is the mean over microbatches of the
    last pod's per-microbatch cross-entropy.

    Placement without a grid (no ``mesh``, or one whose only axis of more
    than one slot is ``stage_axis``): every pod runs on the device of the
    parameters without a mesh; with one, pod ``p`` runs on the first device
    of the mesh's ``stage_axis`` slice ``p`` (:func:`pod_devices`).  A
    tensor that sits on another device than its pod's is moved there at
    each call: a packed stack (place the stacks once with
    ``make_stage_params(..., devices=)``), the embedding (first pod) and the
    head (last pod).  The loss is on the last pod's device.

    On a grid (:func:`on_grid`: the mesh has ``data`` and/or ``model`` slots
    beside ``stage_axis``) each live (pod, tick) step runs over its pod's
    (data, model) slots under the pod's sub-mesh: the microbatch's rows
    scattered over the data slots that take them (``Mesh.row_devices``:
    data slot 0 alone where they do not divide), the embedding on the first
    pod's grid (``layers.embed_row``), every live layer through
    ``transformer._grid_block`` from each slot's block of the pod's stack
    (``param_specs``: stacks placed by ``make_stage_params(..., mesh=)`` as
    placed, whole stacks cut into views), the final norm (the plain
    formula on each slot), ``layers.unembed_row`` and the vocabulary-split
    cross-entropy (``train._nll_sums_row``) on the last pod's grid, no slot
    gathering the logits; the MoE aux loss is dropped, as in the
    reference.  Hand-offs go slot to slot through
    :func:`repro_torch.launch.collectives.ppermute`.  The embedding's
    gradient sums the first pod's and the last pod's uses; each placed
    block gets its own.  The loss is on the last pod's data slot 0's model
    slot 0's device.  Under :func:`repro_torch.launch.mesh.symmetric_data_slots`
    (the dry run; the data slots must compute independently) data slot 0
    alone is computed, each op and collective counted once per data slot,
    and its loss term stands in for the others'.

    Kernels: under autograd the loss raises when ``cfg.use_pallas`` is set
    (the kernels' outputs carry no gradient, as in ``models/train.py``);
    under ``torch.inference_mode`` the blocks take them (RMSNorm, and flash
    attention where its gate passes, on every slot).  The final norm is the
    plain formula, as in the reference.
    """
    if on_grid(mesh, stage_axis):
        return _grid_loss_fn(cfg, plan, num_microbatches, mask, mesh, stage_axis)
    m = plan.num_stages                  # enrolled intervals (may be < pods)
    M = num_microbatches
    ticks = gpipe_ticks(m, M)
    alloc = list(plan.mapping.alloc)     # chain position j -> pod alloc[j]
    live = [[bool(v) for v in row] for row in torch.as_tensor(mask).tolist()]

    def loss_fn(params, batch):
        grad = torch.is_grad_enabled()
        if grad:
            _refuse_kernels(cfg)
        tokens, labels = batch["tokens"], batch["labels"]
        B, seq = tokens.shape
        assert B % M == 0, (B, M)
        mb = B // M
        tok_q = tokens.reshape(M, mb, seq)
        lab_q = labels.reshape(M, mb, seq)
        devs = pod_devices(len(live), params["embed"]["tok"].device, mesh, stage_axis)
        chain = [devs[a] for a in alloc]
        packed = params["stages"]
        stages = [_to(packed[a] if isinstance(packed, (list, tuple)) else index_tree(packed, a),
                      devs[a]) for a in alloc]
        embed_first = {"tok": params["embed"]["tok"].to(chain[0])}
        head = (_to(params["embed"], chain[-1]), params["ln_f"].to(chain[-1]))
        positions = {d: torch.arange(seq, device=d)[None, :] for d in set(chain)}

        def step(j, x):
            dev = chain[j]
            if j == 0:
                x = embed(embed_first, x, cfg)
            y = _stage_fn(stages[j], live[alloc[j]], x, cfg, positions[dev])
            return y

        def last_step(j, x, lab):
            y = step(j, x)
            h = rms_norm(y, head[1], cfg.norm_eps)
            return cross_entropy(unembed(head[0], h, cfg), lab)

        acts, losses = [None] * M, [None] * M
        for t in range(ticks):
            for j in range(m):
                i = t - j
                if not 0 <= i < M:
                    continue
                dev = chain[j]
                # the hand-off from the previous pod (the paper's delta/b edge)
                x = tok_q[i].to(dev) if j == 0 else acts[i].to(dev)
                fn, args = (last_step, (j, x, lab_q[i].to(dev))) if j == m - 1 \
                    else (step, (j, x))
                out = checkpoint(fn, *args, use_reentrant=False) if grad else fn(*args)
                if j == m - 1:
                    losses[i], acts[i] = out, None
                else:
                    acts[i] = out
        return torch.stack(losses).mean()

    return loss_fn


def _split_rows(x: torch.Tensor, devices) -> list:
    """A microbatch's rows over the data slots that take them (``devices``),
    in order."""
    return collectives.scatter(x, 0, devices)


def _stage_views(stack, cfg: ModelConfig, sub, data_slots) -> sharding.SlotViews:
    """The :class:`~repro_torch.models.sharding.SlotViews` of one pod's
    (L_max, ...) stack on its sub-mesh ``sub``: placed blocks as placed (on
    ``sub``), a whole stack cut by ``param_specs``."""
    for x in _leaves(stack):
        if isinstance(x, sharding.ShardedTensor) and (
                x.mesh.axis_sizes != sub.axis_sizes or x.mesh.devices != sub.devices):
            raise ValueError("a placed stage stack must be placed on its pod's sub-mesh "
                             "(make_stage_params(..., mesh=))")
    tree = {"layers": stack}
    return sharding.SlotViews(tree, sub, data_slots, sharding.param_specs(tree, cfg, sub))


def _leaves(tree) -> list:
    out = []
    sharding._map_leaves(out.append, tree)
    return out


def _grid_stage(views, live, xs: list, cfg: ModelConfig, positions: list, data_slots: list,
                n_data: int, sub, scale: int, sp: bool) -> list:
    """A pod's live slots over its grid (``xs[jj][m]`` model slot ``m``'s
    copy of computing data slot ``data_slots[jj]``'s rows, with ``sp`` its
    block of their positions, as the model's own forward holds them between
    blocks); masked slots are identity.  Each layer runs under the pod's sub-mesh ``sub``, every
    call counted ``scale`` times, and is checkpointed where ``cfg.remat``
    is ``"block"`` (as the model's own ``train_forward``): the step's
    recomputation in the backward pass then holds one layer's activations
    at a time, and each layer's own recomputation, later still, enters the
    sub-mesh itself."""
    ldims, L = views.layer_dims(), len(live)

    def layer(i, xs):
        with use_mesh(sub), collectives.counted_as(scale):
            return _grid_block([views.layer(jj, i, L) for jj in range(len(data_slots))], ldims,
                               xs, cfg, positions, data_slots, n_data, sp=sp)[0]

    block = _maybe_remat(layer, cfg)
    for i, on in enumerate(live):
        if on:
            xs = block(i, xs)
    return xs


def _grid_loss_fn(cfg: ModelConfig, plan: StagePlan, num_microbatches: int, mask, mesh,
                  stage_axis: str) -> Callable:
    """:func:`pipelined_loss_fn` on a grid (its docstring)."""
    m = plan.num_stages
    M = num_microbatches
    ticks = gpipe_ticks(m, M)
    alloc = list(plan.mapping.alloc)
    live = [[bool(v) for v in row] for row in torch.as_tensor(mask).tolist()]
    if mesh.shape.get(stage_axis) != len(live):
        raise ValueError(f"the mesh's {stage_axis!r} axis has {mesh.shape.get(stage_axis)} "
                         f"slices for {len(live)} pods")
    subs = [mesh.submesh(stage_axis, a) for a in alloc]

    def loss_fn(params, batch):
        grad = torch.is_grad_enabled()
        if grad:
            _refuse_kernels(cfg)
        tokens, labels = batch["tokens"], batch["labels"]
        B, seq = tokens.shape
        assert B % M == 0, (B, M)
        mb = B // M
        tok_q = tokens.reshape(M, mb, seq)
        lab_q = labels.reshape(M, mb, seq)
        D = len(subs[0].row_devices(mb))             # the data slots that take rows
        sym = D > 1 and symmetric_data()
        data_slots = [0] if sym else list(range(D))
        scale = D if sym else 1
        packed = params["stages"]
        # every data slot's views, as the mesh train step takes them; under
        # the shortcut data slot 0's alone compute
        views = [_stage_views(packed[a] if isinstance(packed, (list, tuple))
                              else index_tree(packed, a), cfg, sub, range(D)).subset(data_slots)
                 for a, sub in zip(alloc, subs)]
        head_tree = {"embed": params["embed"], "ln_f": params["ln_f"]}
        heads = [sharding.SlotViews(head_tree, sub, range(D),
                                    sharding.param_specs(head_tree, cfg, sub)).subset(data_slots)
                 for sub in (subs[0], subs[-1])]
        slot_devs = [[sub.model_devices(d) for d in data_slots] for sub in subs]
        positions = [[[torch.arange(seq, device=dv)[None, :] for dv in devs] for devs in row]
                     for row in slot_devs]
        loss_dev = slot_devs[-1][0][0]
        sp = seq_parallel(cfg, len(slot_devs[0][0]), seq)
        first_rows, last_rows = subs[0].row_devices(mb), subs[-1].row_devices(mb)

        def step(j, x, lab=None):
            # entered here, not around the loop: the checkpoint recomputes
            # this step in the backward pass, after the loop's blocks closed
            with use_mesh(subs[j]):
                if j == 0:
                    with collectives.counted_as(scale):
                        x = [embed_row(heads[0].top(jj, "embed"), heads[0].dims, x[d], cfg, devs)
                             for jj, (d, devs) in enumerate(zip(data_slots, slot_devs[0]))]
                        if sp:
                            x = [seq_blocks(row) for row in x]
                xs = _grid_stage(views[j], live[alloc[j]], x, cfg, positions[j], data_slots, D,
                                 subs[j], scale, sp)
                if lab is None:
                    return xs
                with collectives.counted_as(scale):
                    nll = []
                    for jj, (d, devs) in enumerate(zip(data_slots, slot_devs[j])):
                        row = heads[1].top(jj, "embed", "ln_f")
                        hs = [rms_norm(x, p["ln_f"], cfg.norm_eps) for p, x in zip(row, xs[jj])]
                        if sp:
                            hs = collectives.all_gather(hs, 1, devs, grad32=True)
                        lg = unembed_row(row, heads[1].dims, hs, cfg, devs)
                        nll.append(_nll_sums_row(lg, lab[d], None, devs))
                # data slot 0's term stands in for every data slot's under the shortcut
                nll = nll * scale
                total = nll[0] if len(nll) == 1 else collectives.psum(nll, loss_dev)
                return total.to(loss_dev) / (mb * seq)

        acts, losses = [None] * M, [None] * M
        for t in range(ticks):
            for j in range(m):
                i = t - j
                if not 0 <= i < M:
                    continue
                if j == 0:
                    x = _split_rows(tok_q[i], first_rows)
                else:
                    # the hand-off: slot (d, k) of the previous pod to slot (d, k) of
                    # this one, one ppermute a data slot
                    with collectives.counted_as(scale):
                        x = [collectives.ppermute(row, devs)
                             for row, devs in zip(acts[i], slot_devs[j])]
                args = (j, x, _split_rows(lab_q[i], last_rows)) if j == m - 1 else (j, x)
                out = checkpoint(step, *args, use_reentrant=False) if grad else step(*args)
                if j == m - 1:
                    losses[i], acts[i] = out, None
                else:
                    acts[i] = out
        return torch.stack(losses).mean()

    return loss_fn


def sequential_loss_fn(cfg: ModelConfig) -> Callable:
    """Reference: same math, no pipeline (for equivalence tests).  params =
    {"embed", "layers" (L, ...) stacked, "ln_f"}; differentiable, its blocks
    recomputed under autograd where ``cfg.remat == "block"``."""

    def loss_fn(params, batch):
        logits, _ = train_forward({"embed": params["embed"], "layers": params["layers"],
                                   "ln_f": params["ln_f"]}, batch["tokens"], cfg)
        return cross_entropy(logits, batch["labels"])

    return loss_fn
