"""AdamW (the port of the reference's ``optim/adamw.py``): the reference's own
formula, not ``torch.optim.AdamW``.  Bias-corrected ``m_hat / (sqrt(v_hat) +
eps)``, weight decay added to the step of every leaf (norm scales
included), float32 moments, the step count a 0-dim int32 tensor.

:func:`adamw_update` writes the new parameters and moments into the given
tensors (one float32 parameter, gradient and two moments per leaf live at a
time, not two copies); the returned state holds the same moment tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .tree import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_state_from_numpy", "adamw_update"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32
    m: dict             # first moment, tree like params
    v: dict             # second moment


def adamw_init(params) -> AdamWState:
    dev = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def adamw_state_from_numpy(state, device) -> AdamWState:
    """The reference's ``AdamWState`` (its fields as numpy arrays, or as
    anything ``np.asarray`` reads) as the port's, on ``device``."""
    import numpy as np

    def leaf(a):
        a = np.array(a)   # a copy: the caller's arrays may be read-only views
        return torch.from_numpy(a).to(device)
    return AdamWState(step=leaf(state.step).to(torch.int32), m=tree_map(leaf, state.m),
                      v=tree_map(leaf, state.v))


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """Returns (params, new_state), both updated in place.  lr may be a
    float or a 0-dim tensor (a schedule value)."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

    def upd(p, g, m, v):
        g32 = g.float()
        m.copy_(b1 * m + (1.0 - b1) * g32)
        v.copy_(b2 * v + (1.0 - b2) * (g32 * g32))
        mhat = m / c1
        vhat = v / c2
        p32 = p.float()
        step_val = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
        p.copy_((p32 - lr * step_val).to(p.dtype))

    for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, state.m, state.v))):
        upd(p, g, m, v)
    return params, AdamWState(step=step, m=state.m, v=state.v)
