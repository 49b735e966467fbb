"""SGD and momentum SGD (the paper runs its LAG baseline on SGD), as in the
JAX package's ``optim/sgd.py``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.base import Optimizer
from repro_torch.utils.trees import tree_map


class MomentumState(NamedTuple):
    count: int
    momentum: dict


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def sgd(lr=1e-2) -> Optimizer:
    """θ -= α g. The state is the step count."""
    lr_fn = _lr_fn(lr)

    def init(params):
        del params
        return 0

    def update(grads, state, params=None):
        del params
        step = lr_fn(state)
        return tree_map(lambda g: -step * g, grads), state + 1

    return Optimizer(init, update)


def momentum(lr=1e-2, beta: float = 0.9, nesterov: bool = False
             ) -> Optimizer:
    """Heavy-ball momentum: u^{k+1} = β u^k + g;  θ -= α u^{k+1}."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return MomentumState(count=0, momentum=tree_map(torch.zeros_like,
                                                        params))

    def update(grads, state, params=None):
        del params
        buf = tree_map(lambda m, g: beta * m + g, state.momentum, grads)
        d = (tree_map(lambda m, g: beta * m + g, buf, grads) if nesterov
             else buf)
        step = lr_fn(state.count)
        return (tree_map(lambda u: -step * u, d),
                MomentumState(state.count + 1, buf))

    return Optimizer(init, update)
