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
    output goes to the next pod of the plan's chain by a differentiable
    ``.to(device)`` (the paper's delta/b edges, the reference's
    ``ppermute``), a no-op where both pods share a device.  Backward is
    autograd through the ticks (the reversed pipeline), each stage step
    recomputed (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint(tick_fn)``).

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
from ..models.common import ModelConfig
from ..models.layers import embed, index_tree, rms_norm, unembed
from ..models.train import cross_entropy
from ..models.transformer import block_forward, train_forward
from ..optim.tree import tree_map
from .schedule import gpipe_ticks

__all__ = ["PipelineSpec", "make_stage_mask", "make_stage_params", "pipelined_loss_fn",
           "pod_devices", "sequential_loss_fn"]


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    num_stages: int
    layers_per_stage: int            # padded depth L_max
    num_microbatches: int
    stage_axis: str = "stage"


def make_stage_params(layer_params, plan: StagePlan, num_pods: int, devices=None):
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
    """
    Lmax = plan.max_stage_size
    sizes = plan.stage_sizes
    alloc = plan.mapping.alloc
    assert max(alloc) < num_pods, (alloc, num_pods)
    starts = np.cumsum([0] + list(sizes))[:-1]

    def pack(leaf):
        out = torch.zeros((num_pods, Lmax) + tuple(leaf.shape[1:]), dtype=leaf.dtype,
                          device=leaf.device)
        for j, (start, size) in enumerate(zip(starts, sizes)):
            out[alloc[j], :size] = leaf[int(start):int(start) + size]
        return out

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


def pipelined_loss_fn(cfg: ModelConfig, plan: StagePlan, num_microbatches: int,
                      mask, mesh=None, stage_axis: str = "stage") -> Callable:
    """Returns loss(params, batch) running the plan's pipeline.

    params = {"embed": ..., "stages": (num_pods, L_max, ...) packed tree or a
    list of per-pod trees, "ln_f": ...}; ``mask`` (num_pods, L_max) bool, as
    :func:`make_stage_params` returns it (it receives no gradient); batch =
    {"tokens": (B, S_seq), "labels": (B, S_seq)} with B divisible by
    ``num_microbatches``.  The loss is the mean over microbatches of the
    last pod's per-microbatch cross-entropy, on that pod's device.

    Placement: without ``mesh`` every pod runs on the device of the
    parameters; with one, pod ``p`` runs on the first device of the mesh's
    ``stage_axis`` slice ``p`` (:func:`pod_devices`).  A tensor that sits on
    another device than its pod's is moved there at each call: a packed
    stack (place the stacks once with ``make_stage_params(..., devices=)``),
    the embedding (first pod) and the head (last pod).  The mesh's other
    axes change no value here: the pipeline does not split rows over them
    (the data and model axes execute under ``launch.mesh.use_mesh``, in the
    models' own forward).

    Kernels: under autograd the loss raises when ``cfg.use_pallas`` is set
    (the kernels' outputs carry no gradient, as in ``models/train.py``);
    under ``torch.inference_mode`` the blocks take them (RMSNorm, and flash
    attention where its gate passes).  The final norm is the plain formula,
    as in the reference.
    """
    m = plan.num_stages                  # enrolled intervals (may be < pods)
    M = num_microbatches
    ticks = gpipe_ticks(m, M)
    alloc = list(plan.mapping.alloc)     # chain position j -> pod alloc[j]
    live = [[bool(v) for v in row] for row in torch.as_tensor(mask).tolist()]

    def loss_fn(params, batch):
        grad = torch.is_grad_enabled()
        if grad and cfg.use_pallas:
            raise ValueError(
                f"{cfg.arch_id}: the pipelined loss differentiates the plain versions only; "
                "the hand-written kernels' outputs carry no gradient, so use_pallas must be "
                "off under autograd")
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


def sequential_loss_fn(cfg: ModelConfig) -> Callable:
    """Reference: same math, no pipeline (for equivalence tests).  params =
    {"embed", "layers" (L, ...) stacked, "ln_f"}; differentiable, its blocks
    recomputed under autograd where ``cfg.remat == "block"``."""

    def loss_fn(params, batch):
        logits, _ = train_forward({"embed": params["embed"], "layers": params["layers"],
                                   "ln_f": params["ln_f"]}, batch["tokens"], cfg)
        return cross_entropy(logits, batch["labels"])

    return loss_fn
