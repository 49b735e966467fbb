"""Minimal optimizer protocol, as in the JAX package's ``optim/base.py``.

An optimizer is a pair of pure functions over dicts of tensors:
  init(params) -> state
  update(grads, state, params) -> (updates, new_state)
and ``apply_updates(params, updates)`` adds the updates in. The engine
takes any such optimizer (``optim/sgd.py``, ``optim/adam.py``) beside the
kernel-backed :class:`repro_torch.optim.fused.FusedAMSGrad`. A state's step
count is a Python int, so a schedule never reads the device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.utils.trees import tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params: dict, updates: dict) -> dict:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def chain_weight_decay(opt: Optimizer, weight_decay: float) -> Optimizer:
    """Decoupled (AdamW-style) weight decay wrapped around any optimizer."""
    if weight_decay == 0.0:
        return opt

    def update(grads, state, params):
        updates, new_state = opt.update(grads, state, params)
        return tree_map(lambda u, p: u - weight_decay * p, updates,
                        params), new_state

    return Optimizer(opt.init, update)
