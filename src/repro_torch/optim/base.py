"""Minimal optimizer protocol, as in the JAX package's ``optim/base.py``.

An optimizer is a pair of pure functions over dicts of tensors:
  init(params) -> state
  update(grads, state, params) -> (updates, new_state)
and ``apply_updates(params, updates)`` adds the updates in. The flat-plane
engine of this slice takes :class:`repro_torch.optim.fused.FusedAMSGrad`;
protocol optimizers (SGD, Adam) arrive with a later slice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
