"""Server/worker engine for CADA (the paper's Algorithm 1) on the dense
flat plane, on the per-leaf pytree plane and on the cohort plane.

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

Two state planes implement the round, step for step the same:
``fused=True`` (the default), the flat plane above, and ``fused=False``,
the per-leaf pytree plane (:func:`repro_torch.core.comm.comm_round`), kept
as the readable oracle the flat plane is held against. Its server step is
the protocol optimizer, or ``FusedAMSGrad`` through its protocol adapter:
one AMSGrad step over the packed trees (``ops.fused_cada_update``, the
kernel on the card), then updates = θ' − θ and ||Δθ||² their sum of
squares.

The cohort plane (:meth:`CADAEngine.init_cohort`, :meth:`~CADAEngine.
step_cohort`, :meth:`~CADAEngine.run_cohort`) keeps the O(M·n) per-worker
planes in a host :class:`repro_torch.core.flat.WorkerPool` and moves only
the C sampled workers' rows to the device each round; the pipelined
driver overlaps those copies with the rounds (``flat.run_cohort_rounds``).

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); with no CUDA device and no ``device`` it raises.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.core.comm import (comm_round, init_comm_state, nabla_f32,
                                   record_progress, strategy_for)
from repro_torch.core.rules import CommRule
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import IMPLS
from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.optim.fused import FusedAMSGrad, as_optimizer
from repro_torch.utils.trees import tree_leaves, tree_map, tree_sq_norm


class EngineState(NamedTuple):
    step: int                    # k
    params: dict                 # θ^k (server copy, dict form)
    opt_state: Any               # server-optimizer state
    comm: Any                    # comm.CommState | flat.FlatCommState
    params_flat: Any = None      # θ^k packed fp32 (flat plane only)


class CohortEngineState(NamedTuple):
    """Device-resident engine state of the cohort plane (the O(M·n)
    per-worker planes live in the host WorkerPool)."""
    step: int
    params: dict
    opt_state: Any
    server: F.CohortServerState
    params_flat: torch.Tensor


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
      fused: run the flat plane (True, the default) or the per-leaf pytree
        plane (False).
      fuse_evals: stack the rule's per-worker second gradient evaluation
        onto the fresh one in one vmapped call (default on, as in the
        reference).
      group_evals: evaluate cada2's second gradient once per occupied
        stale-iterate ring row instead of gathering M per-worker points
        (``flat.grouped_second_plane``; dense plane only, as in the
        reference). Opt-in: the broadcast-point evaluation may differ from
        the per-row one in the last bits.
      impl: dispatch override of kernels/ops.py (None on the main path).
      device: where the state lives; None means ``cuda``.
      resum_every: the cohort plane's drift guard: every K cohort rounds,
        ∇ is recomputed from the host pool (fp64 sums) in place of the
        incremental aggregate. 0 (the default) turns it off; the
        incremental form is exact in real arithmetic and bit-pinned to
        the dense plane.

      allow_adaptive_local_steps: accept a rule with
        ``adapt_local_steps``. The bare engine refuses one, as it has no
        clock to adapt H against; the sim runtime (``repro_torch.sim``),
        which prices every round and passes the adapted (steps, M)
        schedule to :meth:`run`, sets it.
    """

    def __init__(self, loss_fn: Callable,
                 optimizer: FusedAMSGrad | Optimizer | None = None,
                 rule: CommRule | None = None, n_workers: int = 1, *,
                 fused: bool = True,
                 fuse_evals: bool | None = None, group_evals: bool = False,
                 impl=None, device=None, resum_every: int = 0,
                 allow_adaptive_local_steps: bool = False):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.rule = CommRule() if rule is None else rule
        self.strategy = strategy_for(self.rule)
        if self.rule.adapt_local_steps and not allow_adaptive_local_steps:
            raise ValueError(
                "adapt_local_steps adapts H against MEASURED communication "
                "time — the bare engine has no clock. Run it through the "
                "sim runtime (repro_torch.sim, python -m "
                "repro_torch.launch.train --runtime sim), which prices "
                "every round and passes the adapted schedule back in.")
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
        self.fused = fused
        self._fuse_evals = True if fuse_evals is None else fuse_evals
        self._group_evals = group_evals
        self._impl = impl
        self.resum_every = resum_every
        self._layout: F.FlatLayout | None = None
        self._plane_order = self._plane_dtype = None
        grad_and_value = torch.func.grad_and_value(loss_fn)

        def value_and_grad(params, batch):
            g, v = grad_and_value(params, batch)
            return v, g

        self._vgrad = torch.func.vmap(value_and_grad, in_dims=(None, 0))
        self._vgrad_per = torch.func.vmap(value_and_grad, in_dims=(0, 0))

    # ------------------------------------------------------------- state
    def init(self, params: dict) -> EngineState:
        params = tree_map(lambda p: p.to(self.device), params)
        if not self.fused:
            return EngineState(
                step=0, params=params,
                opt_state=self.optimizer.init(params),
                comm=init_comm_state(self.strategy, params, self.m))
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
        state_dev = (state.params_flat if self.fused
                     else tree_leaves(state.params)[0]).device
        if state_dev != self.device:
            raise ValueError(f"the state lies on {state_dev}, the engine on "
                             f"{self.device}")
        if batch[0].device != self.device:
            raise ValueError(f"the batch lies on {batch[0].device}, the "
                             f"engine on {self.device}")
        if not self.fused:
            return self._step_pytree(state, batch, participation,
                                     local_steps)
        k = state.step
        if self._layout is None:
            self._layout = F.layout_of(state.params)
        layout = self._layout
        out = F.flat_comm_round(
            self.strategy, layout, state.comm, state.params,
            state.params_flat, batch, k, vgrad=self._vgrad,
            vgrad_per=self._vgrad_per, fuse_evals=self._fuse_evals,
            group_evals=self._group_evals, impl=self._impl,
            participation=participation,
            local_steps=local_steps)

        params, theta, opt_state, dsq = self._server_step(
            state.params, state.params_flat, state.opt_state,
            F.nabla_f32(out.comm))
        comm = F.record_progress(out.comm, dsq, k)
        new_state = EngineState(step=k + 1, params=params,
                                opt_state=opt_state, comm=comm,
                                params_flat=theta)
        return new_state, {"loss": out.losses.mean(), **out.metrics}

    def _step_pytree(self, state: EngineState, batch, participation=None,
                     local_steps=None) -> tuple[EngineState, dict]:
        """The per-leaf pytree plane: the shared round on dicts, then the
        server step through the protocol (the fused step's adapter for
        ``FusedAMSGrad``)."""
        k = state.step
        # Lines 4-15: the shared communication round.
        out = comm_round(self.strategy, state.comm, state.params, batch, k,
                         vgrad=self._vgrad, vgrad_per=self._vgrad_per,
                         participation=participation,
                         local_steps=local_steps)
        # Lines 16-17: the server update driven by ∇^k (eqs. 2a-2c).
        opt = (as_optimizer(self.optimizer, impl=self._impl)
               if self._fused_opt else self.optimizer)
        updates, opt_state = opt.update(nabla_f32(out.comm), state.opt_state,
                                        state.params)
        params = apply_updates(state.params, updates)
        comm = record_progress(out.comm, tree_sq_norm(updates), k)
        new_state = EngineState(step=k + 1, params=params,
                                opt_state=opt_state, comm=comm)
        return new_state, {"loss": out.losses.mean(), **out.metrics}

    def _server_step(self, params, params_flat, opt_state, nabla):
        """Lines 16-17: the server step driven by ∇^k (eqs. 2a-2c):
        (θ' dict, θ' packed, optimizer state, ||Δθ||²)."""
        layout = self._layout
        if self._fused_opt:
            theta, opt_state, dsq = self.optimizer.apply_flat(
                params_flat, opt_state, nabla, impl=self._impl)
            theta = layout.cast_roundtrip(theta)
            return layout.unpack(theta), theta, opt_state, dsq
        grads = layout.unpack(nabla,
                              dtypes=(torch.float32,) * len(layout.dtypes))
        updates, opt_state = self.optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, layout.pack(params), opt_state, tree_sq_norm(updates)

    # ------------------------------------------------------ cohort plane
    def init_cohort(self, params: dict, *, pool_storage: str = "ram",
                    pool_path: str | None = None):
        """Cohort-plane state: (CohortEngineState, flat.WorkerPool).

        Device state is the O(n) server buffers, the O(M) vectors and,
        in a round, O(C·n) rows; the O(M·n) per-worker planes live in the
        returned host pool (``pool_storage="memmap"`` and ``pool_path``
        put them in files). The server step is the fused AMSGrad kernel
        or any protocol optimizer (the delta-payload rules prescribe
        theirs)."""
        if not self.fused:
            raise ValueError("the cohort plane requires fused=True")
        params = tree_map(lambda p: p.to(self.device), params)
        layout = F.layout_of(params)
        self._layout = layout
        params_flat = layout.pack(params)
        grad_dtype = (layout.dtypes[0] if len(set(layout.dtypes)) == 1
                      else torch.float32)
        server, pool = F.init_cohort_state(
            self.strategy, layout, params, self.m, grad_dtype=grad_dtype,
            params_flat=params_flat, pool_storage=pool_storage,
            pool_path=pool_path)
        opt_state = (self.optimizer.init_flat(layout.n_flat,
                                              device=self.device)
                     if self._fused_opt else self.optimizer.init(params))
        state = CohortEngineState(step=0, params=params, opt_state=opt_state,
                                  server=server, params_flat=params_flat)
        self._adopt_pool(pool)
        return state, pool

    def _adopt_pool(self, pool) -> None:
        """Bind the cohort step to a pool's block layout (the planes'
        stacking order and storage dtype) and check its device."""
        if pool.device != self.device:
            raise ValueError(f"the pool stages for {pool.device}, the "
                             f"engine runs on {self.device}")
        self._plane_order = pool.plane_order
        self._plane_dtype = pool.plane_dtype

    def _cohort_step(self, state: CohortEngineState, fused, batch, cohort):
        """The fused-block cohort step: ``fused`` is the (P, C, n_flat)
        gathered block, ``cohort`` the (C,) int64 ids on the device.
        Returns (state, the updated block in the pool's dtype, metrics).
        The serial and the pipelined driver run this one step; the block
        and the old state are dead after it (the drivers drop them)."""
        k = state.step
        if self._layout is None:
            self._layout = F.layout_of(state.params)
        rows = F.split_fused_rows(fused, self._plane_order)
        out = F.flat_cohort_round(
            self.strategy, self._layout, state.server, rows, state.params,
            state.params_flat, batch, k, cohort, m_total=self.m,
            vgrad=self._vgrad, vgrad_per=self._vgrad_per,
            fuse_evals=self._fuse_evals, impl=self._impl)
        params, theta, opt_state, dsq = self._server_step(
            state.params, state.params_flat, state.opt_state,
            out.server.nabla.float())
        server = F.record_progress(out.server, dsq, k)
        new_state = CohortEngineState(step=k + 1, params=params,
                                      opt_state=opt_state, server=server,
                                      params_flat=theta)
        block = F.stack_fused_rows(out.rows, self._plane_order,
                                   self._plane_dtype)
        return new_state, block, {"loss": out.losses.mean(), **out.metrics}

    def step_cohort(self, state: CohortEngineState, pool, batch, cohort):
        """One cohort round, unpipelined: gather the C sampled rows (one
        H2D copy), the round and the server step, scatter the block back
        (one D2H copy). ``batch`` holds only the cohort's rows ((C, b, ...)
        leaves); ``cohort`` is sorted here. Several rounds are better run
        by :meth:`run_cohort`, which overlaps the copies."""
        cohort = np.sort(np.asarray(cohort).astype(np.int32))
        self._adopt_pool(pool)
        fused = pool.gather_fused(cohort)
        state, out, metrics = self._cohort_step(
            state, fused, batch,
            torch.as_tensor(cohort, dtype=torch.long, device=self.device))
        pool.scatter_fused(cohort, out)
        return state, metrics

    def run_cohort(self, state: CohortEngineState, pool, batches, cohorts,
                   *, pipeline: bool = True, metrics_every: int = 8,
                   trace=None, metrics_out: list | None = None):
        """Cohort rounds over a (T, C) schedule (``flat.run_cohort_rounds``
        has the contract). ``batches`` is a list or tuple of per-round
        cohort batches, or a callable ``batches(i, cohort) -> batch``.
        ``pipeline=True`` (the default) overlaps the copies with the
        rounds, bit-exact to ``pipeline=False``, the serial oracle. The
        ``resum_every`` drift guard runs on a drained pool. Returns
        (state, list of host metric dicts)."""
        cohorts = np.asarray(cohorts, np.int32)
        self._adopt_pool(pool)
        batch_fn = (batches if callable(batches)
                    else lambda i, _c: batches[i])
        on_round = None
        if self.resum_every:
            def on_round(_i, st):
                nabla = pool.resum_nabla().to(
                    device=self.device, dtype=st.server.nabla.dtype)
                return st._replace(server=st.server._replace(nabla=nabla))
        return F.run_cohort_rounds(
            self._cohort_step, state, pool, batch_fn, cohorts,
            pipeline=pipeline, metrics_every=metrics_every,
            on_round=on_round, on_round_every=self.resum_every,
            trace=trace, metrics_out=metrics_out)

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


def sample_cohorts(m: int, c: int, steps: int, seed: int = 0) -> np.ndarray:
    """(steps, C) int32 SORTED cohort ids, one independent draw per round,
    seeded per (seed, round) as the JAX package's ``sample_cohorts`` (and
    its sim's participation model) seeds them: the same ids."""
    out = np.empty((steps, c), np.int32)
    for k in range(steps):
        rng = np.random.default_rng((seed, k))
        out[k] = np.sort(rng.choice(m, c, replace=False))
    return out


def cohorts_to_participation(cohorts: np.ndarray, m: int) -> np.ndarray:
    """(steps, M) bool participation masks equal to a (steps, C) cohort
    schedule: the dense plane's input for the cohort parity."""
    steps = cohorts.shape[0]
    masks = np.zeros((steps, m), bool)
    masks[np.arange(steps)[:, None], cohorts] = True
    return masks


def make_cohort_sampler(x, y, shard_index, batch_size: int, device=None):
    """The cohort's form of :func:`make_sampler`: batches for the C sampled
    workers only, ``sample(generator, cohort) -> (xb, yb)`` with
    (C, b, ...) leaves, so batch memory is O(C·b), not O(M·b). ``cohort``
    is a (C,) tensor on ``device`` (a numpy array is copied there). The
    draws are not row-matched to :func:`make_sampler`'s."""
    dev = resolve_device(device)
    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev)
    idx = torch.as_tensor(shard_index, device=dev)
    n_pad = idx.shape[1]

    def sample(generator: torch.Generator, cohort):
        cohort = torch.as_tensor(cohort, dtype=torch.long, device=dev)
        pos = torch.randint(0, n_pad, (cohort.shape[0], batch_size),
                            generator=generator, device=dev)
        rows = torch.gather(idx[cohort], 1, pos)
        return xd[rows], yd[rows]

    return sample
