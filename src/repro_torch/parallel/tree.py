"""Leaves of the nested containers that hold a step's tensors.

A tree is a tensor (a leaf), ``None`` (no leaf), or a dict, list, tuple
or NamedTuple of trees.  Dict keys are walked in sorted order and the
others in order, as ``jax.tree_util`` does, so a port tree and a JAX
pytree of the same structure list their leaves alike.
"""

from __future__ import annotations

import torch


def leaves(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree``, in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def unflatten(tree, new_leaves) -> object:
    """``tree``'s structure with its leaves replaced, in ``leaves`` order,
    by those of ``new_leaves``."""
    it = iter(new_leaves)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def _rebuild(tree, it):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}  # the caller's key order
    if isinstance(tree, (list, tuple)):
        subs = [_rebuild(sub, it) for sub in tree]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*subs)
        return type(tree)(subs)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in the structure of ``tree``."""
    cols = [leaves(t) for t in (tree, *rest)]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("tree_map: trees with different leaf counts")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
