"""Server/worker engine for CADA (the paper's Algorithm 1) on the dense
flat plane.

A (virtual) server and M workers: worker gradients are a ``torch.func.vmap``
over the worker axis of ``grad_and_value(loss_fn)``, the communication
round is :func:`repro_torch.core.flat.flat_comm_round`, and the server step
is the fused AMSGrad kernel, whose free ||Δθ||² feeds the RHS ring, or any
protocol optimizer (``optim/sgd.py``, ``optim/adam.py``: the paper runs
its LAG baseline on SGD), for which ∇ is unpacked to fp32 leaves and
||Δθ||² is the sum of the updates' squares in the reference's leaf order.
The delta-payload rules (``local_momentum``, ``fedadam``) prescribe their
own server optimizer (sgd(1.0), server Adam), which the engine takes when
it is given none, and their batches lead with the local-steps axis H.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); with no CUDA device and no ``device`` it raises.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import flat as F
from repro_torch.core.comm import strategy_for
from repro_torch.core.rules import CommRule
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import IMPLS
from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.optim.fused import FusedAMSGrad
from repro_torch.utils.trees import tree_map, tree_sq_norm


class EngineState(NamedTuple):
    step: int                    # k
    params: dict                 # θ^k (server copy, dict form)
    opt_state: Any               # server-optimizer state
    comm: F.FlatCommState
    params_flat: torch.Tensor    # θ^k packed fp32


class CADAEngine:
    """Server + M workers running Algorithm 1 (or distributed Adam).

    Args:
      loss_fn: scalar loss ``loss_fn(params, (x, y))`` for ONE worker batch.
      optimizer: the server optimizer: :class:`FusedAMSGrad` (the paper's
        AMSGrad form, one kernel) or a protocol :class:`Optimizer` such as
        ``sgd(0.05)`` or ``adam()``. Default: the rule's prescribed one
        (``strategy.server_optimizer()``, the delta-payload rules'), else
        ``FusedAMSGrad(lr=1e-3)``.
      rule: the communication rule (a kind ported in core/comm.py).
      n_workers: M.
      fuse_evals: stack the rule's per-worker second gradient evaluation
        onto the fresh one in one vmapped call (default on, as in the
        reference).
      impl: dispatch override of kernels/ops.py (None on the main path).
      device: where the state lives; None means ``cuda``.

    A rule with ``adapt_local_steps`` is refused: the bare engine has no
    clock to adapt H against (the reference's message names its sim
    runtime, which the port does not have yet).
    """

    def __init__(self, loss_fn: Callable,
                 optimizer: FusedAMSGrad | Optimizer | None = None,
                 rule: CommRule | None = None, n_workers: int = 1, *,
                 fuse_evals: bool | None = None, impl=None, device=None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.rule = CommRule() if rule is None else rule
        self.strategy = strategy_for(self.rule)
        if self.rule.adapt_local_steps:
            raise ValueError(
                "adapt_local_steps adapts H against MEASURED communication "
                "time — the bare engine has no clock. Run it through the "
                "sim runtime (repro.sim, --runtime sim), which prices every "
                "round and passes the adapted schedule back in.")
        if optimizer is None:
            optimizer = (self.strategy.server_optimizer()
                         or FusedAMSGrad(lr=1e-3))
        self._fused_opt = isinstance(optimizer, FusedAMSGrad)
        if not (self._fused_opt or isinstance(optimizer, Optimizer)):
            raise TypeError(f"optimizer must be a FusedAMSGrad or an "
                            f"Optimizer, got {type(optimizer).__name__}")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.optimizer = optimizer
        self.m = n_workers
        self._fuse_evals = True if fuse_evals is None else fuse_evals
        self._impl = impl
        self._layout: F.FlatLayout | None = None
        grad_and_value = torch.func.grad_and_value(loss_fn)

        def value_and_grad(params, batch):
            g, v = grad_and_value(params, batch)
            return v, g

        self._vgrad = torch.func.vmap(value_and_grad, in_dims=(None, 0))
        self._vgrad_per = torch.func.vmap(value_and_grad, in_dims=(0, 0))

    # ------------------------------------------------------------- state
    def init(self, params: dict) -> EngineState:
        params = tree_map(lambda p: p.to(self.device), params)
        layout = F.layout_of(params)
        self._layout = layout
        params_flat = layout.pack(params)
        # comm storage follows the param dtype when it is uniform
        grad_dtype = (layout.dtypes[0] if len(set(layout.dtypes)) == 1
                      else torch.float32)
        return EngineState(
            step=0,
            params=params,
            opt_state=(self.optimizer.init_flat(layout.n_flat,
                                                device=self.device)
                       if self._fused_opt else self.optimizer.init(params)),
            comm=F.init_flat_comm_state(self.strategy, layout, params,
                                        self.m, grad_dtype=grad_dtype,
                                        params_flat=params_flat),
            params_flat=params_flat,
        )

    # -------------------------------------------------------------- step
    def step(self, state: EngineState, batch, participation=None,
             local_steps=None) -> tuple[EngineState, dict]:
        """One iteration of Algorithm 1. ``batch`` is an (x, y) pair with
        leading axis M, or (H, M, ...) for a delta-payload rule that runs
        H local steps (``flat.batch_has_local_axis``); ``participation`` an
        optional (M,) bool mask; ``local_steps`` (None, a scalar or (M,))
        the per-worker step counts of a delta-payload round."""
        if state.params_flat.device != self.device:
            raise ValueError(f"the state lies on {state.params_flat.device}, "
                             f"the engine on {self.device}")
        if batch[0].device != self.device:
            raise ValueError(f"the batch lies on {batch[0].device}, the "
                             f"engine on {self.device}")
        k = state.step
        if self._layout is None:
            self._layout = F.layout_of(state.params)
        layout = self._layout
        out = F.flat_comm_round(
            self.strategy, layout, state.comm, state.params,
            state.params_flat, batch, k, vgrad=self._vgrad,
            vgrad_per=self._vgrad_per, fuse_evals=self._fuse_evals,
            impl=self._impl, participation=participation,
            local_steps=local_steps)

        # Lines 16-17: server step driven by ∇^k (eqs. 2a-2c).
        nabla = F.nabla_f32(out.comm)
        if self._fused_opt:
            theta, opt_state, dsq = self.optimizer.apply_flat(
                state.params_flat, state.opt_state, nabla, impl=self._impl)
            theta = layout.cast_roundtrip(theta)
            params = layout.unpack(theta)
        else:
            grads = layout.unpack(nabla,
                                  dtypes=(torch.float32,) * len(layout.dtypes))
            updates, opt_state = self.optimizer.update(
                grads, state.opt_state, state.params)
            params = apply_updates(state.params, updates)
            dsq = tree_sq_norm(updates)
            theta = layout.pack(params)
        comm = F.record_progress(out.comm, dsq, k)
        new_state = EngineState(step=k + 1, params=params,
                                opt_state=opt_state, comm=comm,
                                params_flat=theta)
        return new_state, {"loss": out.losses.mean(), **out.metrics}

    # --------------------------------------------------------------- run
    def run(self, state: EngineState, batches, participation=None,
            local_steps=None) -> tuple[EngineState, dict]:
        """Step over pre-sampled batches: an (x, y) pair with leading axes
        (steps, M, ...), or (steps, H, M, ...) for a delta-payload rule
        running H local steps. ``participation`` is an optional (steps, M)
        bool tensor, ``local_steps`` an optional (steps, M) int tensor.
        Returns the last state and each metric stacked over steps."""
        steps = batches[0].shape[0]
        rows: list[dict] = []
        for i in range(steps):
            state, metrics = self.step(
                state, tuple(b[i] for b in batches),
                None if participation is None else participation[i],
                None if local_steps is None else local_steps[i])
            rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def make_sampler(x, y, shard_index, batch_size: int, device=None):
    """Per-worker minibatch sampler over a (M, n_pad) shard-index matrix.

    Returns ``sample(generator) -> (xb, yb)`` with shapes (M, b, ...) and
    (M, b), drawn on ``device`` (None means ``cuda``) from a
    ``torch.Generator`` on that device.
    """
    dev = resolve_device(device)
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev)
    idx = torch.as_tensor(shard_index, device=dev)
    m, n_pad = idx.shape

    def sample(generator: torch.Generator):
        pos = torch.randint(0, n_pad, (m, batch_size), generator=generator,
                            device=dev)
        rows = torch.gather(idx, 1, pos)          # (M, b) global ids
        return xd[rows], yd[rows]

    return sample
