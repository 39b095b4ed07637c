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
of every family (each model's ``train_forward.slots``) takes placed state
(:func:`place_train_state`: parameters and both moments by
``zero1_specs`` under ``cfg.fsdp_params``, else by ``param_specs``), the
reference's jitted step with those in-shardings: every model slot of each
data slot computes tensor-parallel from its own block of the weights
(:class:`repro_torch.models.sharding.SlotViews`: the ``model`` shards as
placed, a ``zero1_specs`` block all-gathered over the data axes only, one
layer at a time inside the layer's checkpoint, so that the backward's
recomputation gathers it again and each block's gradient is its part of
the gathered weight's), on its data slot's rows of every microbatch.  The
loss is the global mean over the slots' tokens, its cross-entropy computed
on the vocabulary-split logits without gathering them
(:func:`_nll_sums_row`); where the data slots compute independently each
one's forward and backward runs on its own.  The gradients of the slots'
views are summed in float32 in slot order into the placement's blocks
(:func:`repro_torch.models.sharding.reduce_to_placement`, each zero1 block
from its own block's gradients, so a ``zero1_specs`` step equals the
``param_specs`` step bit for bit where the data slots compute
independently; a later microbatch's sums added into the first's block by
block), the clip norm is the global one, and AdamW updates each block in
place.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..launch import collectives
from ..optim import adamw_init, adamw_update, clip_by_global_norm, linear_warmup_cosine
from ..optim.adamw import AdamWState
from ..optim.tree import tree_leaves, tree_map
from . import layers, sharding
from .common import ModelConfig, abstract_mesh, symmetric_data

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


def _weight_sum(labels: torch.Tensor, weights=None) -> torch.Tensor:
    """The tokens' weight in the loss's mean, float32, on the labels' device."""
    if weights is None:
        return torch.full((), float(labels.numel()), dtype=torch.float32, device=labels.device)
    return weights.float().sum()


def _nll_sums_row(lg, labels: torch.Tensor, weights, devs) -> torch.Tensor:
    """The sum of one data slot's tokens' weighted cross-entropy, float32,
    on its first model slot's device, from its :class:`.layers.SlotLogits`
    (``labels``/``weights`` the data slot's, on that device).  Over a
    vocabulary split across the model slots no logits are gathered: each
    slot's maximum is all-gathered for the shared shift, the sums of
    exponentials and the label's logit (taken by the slot whose block holds
    it, zero elsewhere) are summed over the model slots in order.  Over
    positions split across them each slot sums its own tokens."""
    if lg.kind == "one":
        return _nll_sums(lg.parts[0], labels, weights)[0]
    M = len(devs)
    labs = collectives.broadcast(labels, devs)
    ws = collectives.broadcast(weights, devs) if weights is not None else [None] * M
    if lg.kind == "seq":
        return collectives.psum([_nll_sums(p, torch.chunk(l, M, dim=1)[m],
                                           None if w is None else torch.chunk(w, M, dim=1)[m])[0]
                                 for m, (p, l, w) in enumerate(zip(lg.parts, labs, ws))], devs[0])
    lf = [p.float() for p in lg.parts]
    rows = lf[0].shape[-1]
    tops = collectives.all_gather([x.detach().amax(dim=-1, keepdim=True) for x in lf], -1, devs)
    shift = [t.amax(dim=-1) for t in tops]
    sumexp = [torch.exp(x - c[..., None]).sum(dim=-1) for x, c in zip(lf, shift)]
    gold = []
    for m, (x, l) in enumerate(zip(lf, labs)):
        local = l.long() - layers.vocab_offset(m, rows)
        inside = (local >= 0) & (local < rows)
        g = torch.gather(x, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
        gold.append(torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device)))
    nll = torch.log(collectives.psum(sumexp, devs[0])) + shift[0] \
        - collectives.psum(gold, devs[0])
    return nll.sum() if weights is None else (nll * weights.float()).sum()


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


def _listed(leaf) -> list:
    """A slot view's tensors: a :class:`.sharding.DataBlocks`' blocks, or the one tensor."""
    return leaf if isinstance(leaf, list) else [leaf]


def _regrouped(leaf, got) -> object:
    """``leaf``'s gradients taken from the iterator ``got``, grouped as
    ``leaf`` is (a :class:`.sharding.DataBlocks`' list of blocks, or one)."""
    return [next(got) for _ in leaf] if isinstance(leaf, list) else next(got)


def _mesh_step(forward, cfg: ModelConfig, A: int, params, opt_state: AdamWState, batch,
               schedule: dict, clip: float) -> tuple:
    """The step under the ambient mesh (module docstring).  Each data slot's
    loss term is its tokens' summed cross-entropy over the global weight,
    plus its share of the aux loss; where the data slots compute
    independently (``forward.independent``), each term is differentiated on
    its own, else one backward runs over all of them.  Under
    :func:`repro_torch.launch.mesh.symmetric_data_slots` (the dry run) an
    independent step computes data slot 0 alone, every op and collective of
    it counted once per data slot, and stands its loss terms and gradients
    in for the other data slots'."""
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
    D = len(devices)
    dev0 = devices[0]
    views = forward.slot_views(params, cfg, range(D), leaves=True)
    leaves = [[views.tensors(jj, m) for m in range(views.msize)] for jj in range(D)]
    independent = forward.independent(cfg, mb, batch["tokens"].shape[1])
    symmetric = independent and D > 1 and symmetric_data()
    sections = [[0]] if symmetric else \
        [[jj] for jj in range(D)] if independent else [list(range(D))]
    g_acc = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev0)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev0)
    ces = []
    for a in range(A):
        micro = {k: collectives.scatter(v[a * mb:(a + 1) * mb], 0, devices)
                 for k, v in batch.items()}
        batch_slots = [{k: v[j] for k, v in micro.items()} for j in range(D)]
        total = collectives.psum([_weight_sum(b["labels"], b.get("weights"))
                                  for b in batch_slots], list(devices))
        ce_j, aux_j, grads = [None] * D, [None] * D, [None] * D
        for sec in sections:
            flat = [x for jj in sec for ls in leaves[jj] for leaf in ls for x in _listed(leaf)]
            with collectives.counted_as(D if symmetric else 1), torch.enable_grad():
                for p in flat:
                    p.requires_grad_(True)
                try:
                    logits, auxes = slots_fn(views.subset(sec), [batch_slots[jj] for jj in sec],
                                             cfg, D)
                    terms = []
                    for lg, aux, jj in zip(logits, auxes, sec):
                        b = batch_slots[jj]
                        nll = _nll_sums_row(lg, b["labels"], b.get("weights"),
                                            mesh.model_devices(jj))
                        ce_j[jj] = nll / torch.clamp(total[jj], min=1.0)
                        aux_j[jj] = aux
                        terms.append(ce_j[jj] + AUX_WEIGHT * aux)
                    del logits
                    loss = terms[0] if len(terms) == 1 else collectives.psum(terms, dev0)
                    got = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                                   materialize_grads=True))
                finally:
                    for p in flat:
                        p.requires_grad_(False)
            for jj in sec:
                grads[jj] = [[_regrouped(leaf, got) for leaf in ls] for ls in leaves[jj]]
            del got                    # else it holds every gradient past its reduction
            ce_j = [x.detach() if x is not None else None for x in ce_j]
            aux_j = [x.detach() if x is not None else None for x in aux_j]
        if symmetric:
            ce_j, aux_j, grads = [ce_j[0]] * D, [aux_j[0]] * D, [grads[0]] * D
        reduced = []
        for i, like in enumerate(placed):
            # a later microbatch's sums added into the first's block by block
            reduced.append(sharding.reduce_to_placement([[g[i] for g in row] for row in grads],
                                                        like, None if g_acc is None else g_acc[i]))
            for row in grads:          # each leaf's slot gradients freed once reduced
                for g in row:
                    g[i] = None
        del grads
        g_acc = reduced
        ce = collectives.psum(ce_j, dev0)
        aux = collectives.psum(aux_j, dev0)
        loss_sum = loss_sum + ce + AUX_WEIGHT * aux
        aux_sum = aux_sum + aux
        ces.append(ce)
    del views, leaves
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
