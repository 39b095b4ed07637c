"""Loss and train-step factory shared by the architectures (the port of the
reference's ``models/train.py``).

Training is plain autograd through the plain PyTorch versions of every
kernel, as in the reference, which never differentiates a Pallas kernel:
``cfg.use_pallas`` must be off (the loss refuses it under autograd, and
``make_train_step`` refuses it outright), and ``forward`` is a model's
``train_forward``.  Parameters are float32 master weights (``master=True``
at load), each cast to the compute dtype at its use; gradients come back
float32, and AdamW updates the weights in place.

Under an ambient mesh (:func:`repro_torch.launch.mesh.use_mesh`) the step
takes placed state (:func:`place_train_state`: parameters and both moments
by ``zero1_specs`` under ``cfg.fsdp_params``, else by ``param_specs``), the
reference's jitted step with those in-shardings: each data slot runs the
forward and backward on its rows of every microbatch with the weights
gathered at use (its own copy; the ``model`` shards are gathered for
compute too), the loss is the global mean over the slots' tokens, the
gradients are summed in float32 in slot order into the placement's blocks
(:func:`repro_torch.models.sharding.reduce_to_placement`), the clip norm is
the global one, and AdamW updates each block in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..launch import collectives
from ..optim import adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from ..optim.adamw import AdamWState
from ..optim.tree import tree_leaves, tree_map
from . import sharding
from .common import ModelConfig, abstract_mesh

__all__ = ["cross_entropy", "init_optimizer", "make_loss_fn", "make_train_step",
           "place_train_state", "value_and_grad"]


AUX_WEIGHT = 0.01   # the MoE load-balance loss's weight in the loss


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's cross-entropy in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits (B,S,V), labels (B,S)."""
    nll = _nll(logits, labels)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def _refuse_kernels(cfg: ModelConfig) -> None:
    if cfg.use_pallas:
        raise ValueError(
            f"{cfg.arch_id}: training differentiates the plain versions only; the "
            "hand-written kernels' outputs carry no gradient, so use_pallas must be off")


def make_loss_fn(forward: Callable, cfg: ModelConfig, aux_weight: float = AUX_WEIGHT):
    """forward(params, batch, cfg) -> (logits, aux).  Returns loss_fn, which
    raises under autograd when ``cfg.use_pallas`` is set."""

    def loss_fn(params, batch):
        if torch.is_grad_enabled():
            _refuse_kernels(cfg)
        logits, aux = forward(params, batch, cfg)
        loss = cross_entropy(logits, batch["labels"], batch.get("weights"))
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch) -> tuple:
    """((loss, parts), grads) of ``loss_fn(params, batch)``: the gradient
    with respect to every leaf of ``params`` (zeros where a leaf does not
    reach the loss), in a tree of ``params``' structure."""
    leaves = tree_leaves(params)
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, parts = loss_fn(params, batch)
            grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                             materialize_grads=True))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return ((loss.detach(), {k: v.detach() for k, v in parts.items()}),
            tree_map(lambda p: next(grads), params))


def make_train_step(forward: Callable, cfg: ModelConfig, *,
                    base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, clip: float = 1.0):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    With cfg.accum_steps > 1 the global batch is split into that many
    microbatches processed one after the other (gradient accumulation, the
    gradients summed in float32 and divided by their count): peak activation
    memory scales with the microbatch.  Raises when ``cfg.use_pallas`` is
    set."""
    _refuse_kernels(cfg)
    loss_fn = make_loss_fn(forward, cfg)
    A = max(int(cfg.accum_steps), 1)

    def _grads(params, batch):
        if A == 1:
            return value_and_grad(loss_fn, params, batch)
        micro = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:]) for k, v in batch.items()}
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        dev = tree_leaves(params)[0].device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        ces = []
        for a in range(A):
            (loss, parts), g = value_and_grad(loss_fn, params,
                                              {k: v[a] for k, v in micro.items()})
            for acc, gi in zip(tree_leaves(g_sum), tree_leaves(g)):
                acc.add_(gi.float())
            loss_sum = loss_sum + loss
            aux_sum = aux_sum + parts["aux"]
            ces.append(parts["ce"])
        grads = tree_map(lambda g: g / A, g_sum)
        return (loss_sum / A, {"ce": torch.stack(ces).mean(), "aux": aux_sum / A}), grads

    def train_step(params, opt_state, batch):
        if abstract_mesh() is not None:
            return _mesh_step(forward, cfg, A, params, opt_state, batch,
                              dict(base_lr=base_lr, warmup_steps=warmup,
                                   total_steps=total_steps), clip)
        (loss, parts), grads = _grads(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        lr = linear_warmup_cosine(opt_state.step, base_lr=base_lr,
                                  warmup_steps=warmup, total_steps=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   "grad_norm": gnorm, "lr": lr}
        return params, opt_state, metrics

    return train_step


def init_optimizer(params):
    return adamw_init(params)


# ---------------------------------------------------------------------------
# The step under a mesh
# ---------------------------------------------------------------------------

def place_train_state(params, opt_state: AdamWState, cfg: ModelConfig, mesh) -> tuple:
    """(params, opt_state) placed on ``mesh``'s slots for the mesh step: the
    parameters and both moments by ``zero1_specs`` when ``cfg.fsdp_params``
    (2-D sharded), else by ``param_specs``; the step count on the first
    slot's device.  Copies: the given state stays as it was."""
    specs = (sharding.zero1_specs if cfg.fsdp_params else sharding.param_specs)(
        params, cfg, mesh)
    return (sharding.place(params, specs, mesh),
            AdamWState(step=opt_state.step.to(mesh.devices[0], copy=True),
                       m=sharding.place(opt_state.m, specs, mesh),
                       v=sharding.place(opt_state.v, specs, mesh)))


def _global_rows(x):
    return sharding.gather(x) if isinstance(x, sharding.ShardedTensor) else x


def _nll_sums(logits: torch.Tensor, labels: torch.Tensor, weights=None) -> tuple:
    """(sum of the tokens' weighted cross-entropy, sum of their weights), float32."""
    nll = _nll(logits, labels)
    if weights is None:
        return nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)
    w = weights.float()
    return (nll * w).sum(), w.sum()


def _global_norm(grads: list, mesh, devices) -> torch.Tensor:
    """The global norm of placed gradients: each block's squares counted
    once, by the data slot of the first slot that holds it, and the slots'
    sums added in order."""
    sq = [torch.zeros((), dtype=torch.float32, device=d) for d in devices]
    for g in grads:
        seen = set()
        for s, t in enumerate(g.shards):
            b = g.block(s)
            if b in seen:
                continue
            seen.add(b)
            j = mesh.data_index(s) if len(devices) > 1 else 0
            sq[j] = sq[j] + torch.sum(torch.square(t.float())).to(devices[j])
    return torch.sqrt(collectives.psum(sq, devices[0]))


def _mesh_step(forward, cfg: ModelConfig, A: int, params, opt_state: AdamWState, batch,
               schedule: dict, clip: float) -> tuple:
    mesh = abstract_mesh()
    slots_fn = getattr(forward, "slots", None)
    if slots_fn is None:
        raise ValueError(f"{cfg.arch_id}: this forward has no per-slot form, so it does not "
                         "train under a mesh")
    placed = tree_leaves(params)
    if not all(isinstance(p, sharding.ShardedTensor) for p in placed):
        raise ValueError("under a mesh the train step takes placed state (place_train_state)")
    batch = {k: _global_rows(v) for k, v in batch.items()}
    mb = batch["tokens"].shape[0] // A
    devices = mesh.row_devices(mb)
    dev0 = devices[0]
    # the weights gathered at use: one copy per data slot, each its own leaves
    slot_params = [sharding.gather(params, d) for d in devices]
    g_acc = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev0)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev0)
    ces = []
    for a in range(A):
        micro = {k: collectives.scatter(v[a * mb:(a + 1) * mb], 0, devices)
                 for k, v in batch.items()}
        batch_slots = [{k: v[j] for k, v in micro.items()} for j in range(len(devices))]
        leaves = [tree_leaves(p) for p in slot_params]
        with torch.enable_grad():
            for p in (x for ls in leaves for x in ls):
                p.requires_grad_(True)
            try:
                logits, aux = slots_fn(slot_params, batch_slots, cfg)
                sums = [_nll_sums(lg, b["labels"], b.get("weights"))
                        for lg, b in zip(logits, batch_slots)]
                del logits
                ce = collectives.psum([n for n, _ in sums], dev0) / torch.clamp(
                    collectives.psum([w for _, w in sums], dev0), min=1.0)
                loss = ce + AUX_WEIGHT * aux
                flat = [x for ls in leaves for x in ls]
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
            finally:
                for p in (x for ls in leaves for x in ls):
                    p.requires_grad_(False)
        n = len(leaves[0])
        reduced = [sharding.reduce_to_placement([grads[j * n + i] for j in range(len(devices))],
                                                like) for i, like in enumerate(placed)]
        del grads
        if g_acc is None:
            g_acc = reduced
        else:
            for acc, g in zip(g_acc, reduced):
                for s, t in acc.unique():
                    t.add_(g.shards[s])
        loss_sum = loss_sum + loss.detach()
        aux_sum = aux_sum + aux.detach()
        ces.append(ce.detach())
    del slot_params
    for g in g_acc:
        for _, t in g.unique():
            t.div_(A)
    gnorm = _global_norm(g_acc, mesh, devices)
    scale = torch.clamp(clip / (gnorm + 1e-12), max=1.0)
    for g in g_acc:
        for _, t in g.unique():
            t.mul_(scale.to(t.device))
    lr = linear_warmup_cosine(opt_state.step, **schedule)
    groups: dict = {}
    for p, g, m, v in zip(placed, g_acc, tree_leaves(opt_state.m), tree_leaves(opt_state.v)):
        for s, t in p.unique():
            group = groups.setdefault(t.device, ([], [], [], []))
            for lst, x in zip(group, (t, g.shards[s], m.shards[s], v.shards[s])):
                lst.append(x)
    for dev, (ps, gs, ms, vs) in groups.items():
        adamw_update(ps, gs, AdamWState(opt_state.step.to(dev), ms, vs), lr.to(dev))
    metrics = {"loss": loss_sum / A, "ce": torch.stack(ces).mean(), "aux": aux_sum / A,
               "grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=opt_state.step + 1, m=opt_state.m, v=opt_state.v), metrics
