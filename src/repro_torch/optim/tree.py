"""The trees the optimizer walks: nested dicts, tuples and NamedTuples of
tensors, flattened in the reference's (``jax.tree``) order: dict keys
sorted, sequence fields in order, ``None`` holding no leaf."""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map"]


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (in :func:`tree_leaves` order) and
    the matching leaves of ``rest``; the result has ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)
