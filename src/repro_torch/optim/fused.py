"""Kernel-backed fused AMSGrad/CADA server optimizer on flat buffers.

One call applies the whole step (paper eqs. 2a-2c) in one pass and returns
||Δθ||² (the CADA rule's RHS entry) for free. On the card the step is the
CUDA kernel of ``kernels/csrc/cada_update.cu``; on the CPU its plain
version. ``as_optimizer`` adapts it to the ``Optimizer`` protocol (one
extra pass), so the same step can run through the protocol route.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.optim.base import Optimizer
from repro_torch.utils.trees import tree_leaves, tree_map


class FusedState(NamedTuple):
    """Persistent AMSGrad state: {h, v̂} only (the raw v is a temporary),
    plus the step count that drives a schedule."""
    count: int
    h: torch.Tensor
    vhat: torch.Tensor


class FusedAMSGrad(NamedTuple):
    lr: Any                 # float, or step -> float schedule
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

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


def as_optimizer(fused: FusedAMSGrad) -> Optimizer:
    """Protocol adapter: the state covers the packed parameters and
    updates = θ' − θ in fp32 (one extra pass; tests and drop-in use)."""
    # imported here: core imports the engine, which imports this module
    from repro_torch.core.flat import layout_of

    def init(params):
        return fused.init_flat(layout_of(params).n_flat,
                               device=tree_leaves(params)[0].device)

    def update(grads, state, params):
        layout = layout_of(params)
        theta, new_state, _ = fused.apply_flat(layout.pack(params), state,
                                               layout.pack(grads))
        updates = tree_map(lambda a, b: a.float() - b.float(),
                           layout.unpack(theta), params)
        return updates, new_state

    return Optimizer(init, update)
