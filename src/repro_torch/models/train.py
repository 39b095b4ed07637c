"""Loss and train-step factory shared by the architectures (the port of the
reference's ``models/train.py``).

Training is plain autograd through the plain PyTorch versions of every
kernel, as in the reference, which never differentiates a Pallas kernel:
``cfg.use_pallas`` must be off (the loss refuses it under autograd, and
``make_train_step`` refuses it outright), and ``forward`` is a model's
``train_forward``.  Parameters are float32 master weights (``master=True``
at load), each cast to the compute dtype at its use; gradients come back
float32, and AdamW updates the weights in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..optim import adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from ..optim.tree import tree_leaves, tree_map
from .common import ModelConfig

__all__ = ["cross_entropy", "init_optimizer", "make_loss_fn", "make_train_step",
           "value_and_grad"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32.  logits (B,S,V), labels (B,S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def _refuse_kernels(cfg: ModelConfig) -> None:
    if cfg.use_pallas:
        raise ValueError(
            f"{cfg.arch_id}: training differentiates the plain versions only; the "
            "hand-written kernels' outputs carry no gradient, so use_pallas must be off")


def make_loss_fn(forward: Callable, cfg: ModelConfig, aux_weight: float = 0.01):
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
