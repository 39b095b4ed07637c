"""Gradient clipping by global norm (the port of the reference's
``optim/clip.py``).  Trees are nested dicts (or tuples) of tensors; leaves
are visited in the reference's flatten order (dict keys sorted)."""

from __future__ import annotations

import torch

from .tree import tree_leaves, tree_map

__all__ = ["clip_by_global_norm", "global_norm"]


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm
