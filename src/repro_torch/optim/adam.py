"""Adam and AMSGrad in the paper's (2a)-(2c) convention, as in the JAX
package's ``optim/adam.py``:

    h^{k+1} = β1 h^k + (1-β1) ∇^k
    v^{k+1} = β2 v̂^k + (1-β2) (∇^k)²
    v̂^{k+1} = max(v^{k+1}, v̂^k)
    θ^{k+1} = θ^k − α (εI + V̂^{k+1})^{-1/2} h^{k+1}

ε sits inside the root (``eps_inside_sqrt=True``, the paper's form) or
outside; no bias correction unless ``bias_correction`` (off in the paper).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.base import Optimizer
from repro_torch.utils.trees import tree_map


class AdamState(NamedTuple):
    count: int
    h: dict     # first moment (paper's h)
    v: dict     # second moment (paper's v)
    vhat: dict  # running max of v (AMSGrad); the same as v without it


def _scaled_update(h, vhat, lr, eps, eps_inside_sqrt):
    denom = torch.sqrt(eps + vhat) if eps_inside_sqrt else (
        torch.sqrt(vhat) + eps)
    return -lr * h / denom


def adam(lr=1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         amsgrad: bool = True, eps_inside_sqrt: bool = True,
         bias_correction: bool = False,
         state_dtype=torch.float32) -> Optimizer:
    """Adam/AMSGrad; ``lr`` is a float or a step -> float schedule."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                               device=p.device), params)
        return AdamState(count=0, h=zeros, v=zeros, vhat=zeros)

    def update(grads, state, params=None):
        del params
        count = state.count + 1
        h = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g.to(m.dtype),
                     state.h, grads)
        # paper (2b): v^{k+1} = β2 v̂^k + (1-β2)(∇^k)², from v̂, not v
        base = state.vhat if amsgrad else state.v
        v = tree_map(lambda s, g: b2 * s + (1.0 - b2)
                     * torch.square(g.to(s.dtype)), base, grads)
        vhat = tree_map(torch.maximum, v, state.vhat) if amsgrad else v
        step = lr_fn(state.count)
        if bias_correction:
            # in fp32, as the reference computes it from its int32 count
            c = torch.tensor(count, dtype=torch.float32)
            c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** c
            c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** c
            # a 0-d CPU tensor, which combines with the moments anywhere
            step = step * torch.sqrt(c2) / c1
        updates = tree_map(
            lambda m, s: _scaled_update(m, s, step, eps, eps_inside_sqrt),
            h, vhat)
        return updates, AdamState(count=count, h=h, v=v, vhat=vhat)

    return Optimizer(init, update)


def amsgrad(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, **kw) -> Optimizer:
    return adam(lr=lr, b1=b1, b2=b2, eps=eps, amsgrad=True, **kw)
