"""Kernel-backed fused AMSGrad/CADA server optimizer.

One call applies the whole step (paper eqs. 2a-2c) in one pass and returns
||Δθ||² (the CADA rule's RHS entry) for free. On the card the step is the
CUDA kernel of ``kernels/csrc/cada_update.cu``; on the CPU its plain
version. ``init``/``apply`` take dicts of tensors (the pytree plane: the
trees are packed into one padded buffer for the one launch,
``kernels/ops.py::fused_cada_update``); ``init_flat``/``apply_flat`` take
the flat plane's packed buffers. ``as_optimizer`` adapts it to the
``Optimizer`` protocol (one extra pass), so the same step can run through
the protocol route.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.optim.base import Optimizer
from repro_torch.utils.trees import tree_map, tree_zeros_like


class FusedState(NamedTuple):
    """Persistent AMSGrad state: {h, v̂} only (the raw v is a temporary),
    plus the step count that drives a schedule. ``h`` and ``vhat`` are
    dicts of fp32 tensors (``init``) or (n_flat,) buffers
    (``init_flat``)."""
    count: int
    h: Any
    vhat: Any


class FusedAMSGrad(NamedTuple):
    lr: Any                 # float, or step -> float schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params) -> FusedState:
        """State over a dict of parameters: fp32 zeros shaped like each
        leaf, on the leaf's device (h and v̂ distinct tensors)."""
        return FusedState(count=0,
                          h=tree_zeros_like(params, torch.float32),
                          vhat=tree_zeros_like(params, torch.float32))

    def apply(self, params, state: FusedState, grads, *, impl=None):
        """One fused step over dicts of tensors: (params', state',
        ||Δθ||²), one launch over the packed trees on the card."""
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        p, h, vhat, sq = kops.fused_cada_update(
            params, state.h, state.vhat, grads, lr, b1=self.b1, b2=self.b2,
            eps=self.eps, impl=impl)
        return p, FusedState(count=state.count + 1, h=h, vhat=vhat), sq

    def init_flat(self, n_flat: int, dtype=torch.float32,
                  device=None) -> FusedState:
        """State over (n_flat,) buffers. ``dtype`` is the moment STORAGE
        dtype (fp32 or bf16; the math stays fp32); ``device`` None means
        ``cuda``."""
        device = resolve_device(device)
        return FusedState(
            count=0,
            h=torch.zeros((n_flat,), dtype=dtype, device=device),
            vhat=torch.zeros((n_flat,), dtype=dtype, device=device))

    def apply_flat(self, theta, state: FusedState, grad, *, impl=None):
        """One fused step over flat buffers: (θ', state', ||Δθ||²).
        ``impl`` is the dispatch override of ``kernels/ops.py``."""
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        t, h, vhat, sq = kops.fused_amsgrad_flat(
            theta, state.h, state.vhat, grad, lr, b1=self.b1, b2=self.b2,
            eps=self.eps, impl=impl)
        return t, FusedState(count=state.count + 1, h=h, vhat=vhat), sq


def as_optimizer(fused: FusedAMSGrad, impl=None) -> Optimizer:
    """Protocol adapter: updates = θ' − θ in fp32 (one extra pass; tests
    and the pytree engine's server step). ``impl`` is the dispatch override
    of ``kernels/ops.py``."""

    def update(grads, state, params):
        p_new, new_state, _ = fused.apply(params, state, grads, impl=impl)
        updates = tree_map(lambda a, b: a.float() - b.float(), p_new, params)
        return updates, new_state

    return Optimizer(fused.init, update)
