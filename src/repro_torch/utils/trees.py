"""Dict-of-tensor trees, as the JAX package's ``utils/trees.py`` handles
pytrees.

A tree is a (nested) dict whose leaves are tensors; a bare tensor is a
one-leaf tree. Leaves are visited in SORTED key order, the order
``jax.tree.flatten`` gives a dict, so the port's leaf order equals the
reference's.

The arithmetic helpers are the reference's set. The pytree plane uses
``tree_add``, ``tree_sub``, ``tree_cast``, ``tree_zeros_like`` and
``tree_size``; ``tree_scale``, ``tree_axpy``, ``tree_dot``,
``tree_where_mask`` and ``tree_bytes`` have no caller in the port and are
kept for users of the reference's API, held against it by the tests.
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


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_axpy(s, a, b):
    """b + s * a, elementwise over matching trees."""
    return tree_map(lambda x, y: y + s * x, a, b)


def tree_zeros_like(a, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), a)


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_dot(a, b):
    """Σ of a·b over matching trees, fp32, in the reference's leaf order."""
    return sum(torch.sum(x.float() * y.float())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_size(a) -> int:
    """Total number of scalar parameters in the tree."""
    return sum(x.numel() for x in tree_leaves(a))


def tree_where_mask(mask, a, b):
    """a where the (scalar or broadcastable) bool ``mask``, else b, per
    leaf."""
    return tree_map(lambda x, y: torch.where(mask, x, y), a, b)


def tree_bytes(a) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))
