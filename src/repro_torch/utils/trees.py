"""Dict-of-tensor trees, as the JAX package's ``utils/trees.py`` handles
pytrees.

A tree is a (nested) dict whose leaves are tensors; a bare tensor is a
one-leaf tree. Leaves are visited in SORTED key order, the order
``jax.tree.flatten`` gives a dict, so the port's leaf order equals the
reference's.
"""
from __future__ import annotations

import torch


def tree_paths(tree, prefix=()) -> list[tuple]:
    """Key paths of a nested dict's leaves, keys sorted at every level."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k],
                                                            prefix + (k,))]
    return [prefix]


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(f, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return f(tree, *rest)


def tree_unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_sq_norm(tree) -> torch.Tensor:
    """Σ of squared entries over the whole tree, fp32, the leaves added in
    the reference's leaf order (a Python ``sum`` from 0, as there)."""
    return sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
