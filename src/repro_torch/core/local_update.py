"""Local-update baselines: local momentum SGD [Yu et al., 2019] and FedAdam
[Reddi et al., 2020], the paper's strongest baselines (§4).

Both run H local iterations per communication round:
  * local momentum — every worker does heavy-ball SGD; every H steps the
    parameters AND the momentum buffers are averaged across workers;
  * FedAdam — workers run H plain SGD steps from the server iterate; the
    server treats the mean model delta as a pseudo-gradient and takes an
    Adam step with server step size α_s.

One upload per worker per round (M uploads per H iterations) and one
gradient evaluation per worker per local iteration, as in the paper.

Two forms, as in the JAX package's ``core/local_update.py``:

  * :class:`LocalMomentumStrategy` and :class:`FedAdamStrategy`, the
    registered DELTA-PAYLOAD rules (``kind="local_momentum"`` and
    ``"fedadam"``): :func:`repro_torch.core.flat.flat_comm_round` carries
    them, the payload is the model delta θ^k − θ_m^(h) shipped through the
    ordinary wire (so ``quantize_bits`` applies), and the rule's server
    optimizer (``server_optimizer()``) closes the round. With every worker
    uploading every round the worker copies telescope to the last payload,
    so ∇ is the payloads' mean and the server's sgd(1.0) or Adam step is
    the standalone engine's round tail.
  * :class:`LocalUpdateEngine`, the standalone engine, kept as the parity
    oracle of the two rules.

The local run is a Python loop over the batch's H axis (the reference's
``lax.scan``) with per-worker masking at j < h_w: a worker past its own
step count keeps its parameters and momenta, and its losses stop counting.
Each rule has the flat plane's hooks (``flat_local_payload``,
``flat_post_upload``) and the pytree plane's (``local_payload``,
``post_upload``, for ``core.comm.comm_round`` under ``fused=False``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.comm import (CommStrategy, broadcast_to_workers,
                                   register, select_rows)
from repro_torch.core.flat import batch_lead, batch_map, spec_dim
from repro_torch.kernels import ops as kops
from repro_torch.optim.adam import adam
from repro_torch.optim.base import apply_updates
from repro_torch.optim.sgd import sgd
from repro_torch.utils.trees import tree_leaves, tree_map, tree_sub


class LocalState(NamedTuple):
    step: int         # global iteration counter (local steps count)
    params: dict      # server θ (every worker's start of round)
    momenta: dict     # per-worker momentum buffers (M-leading)
    server_opt: Any   # FedAdam's server Adam state (None for local momentum)


def _fedadam_server(server_lr: float, betas=(0.9, 0.999), eps: float = 1e-3):
    """The FedAdam server: Adam without AMSGrad, ε outside the root.
    ε = 1e-3 is Reddi et al.'s adaptivity τ: as τ → 0 the normalized server
    step never decays and FedAdam orbits the optimum."""
    return adam(lr=server_lr, b1=betas[0], b2=betas[1], eps=eps,
                amsgrad=False, eps_inside_sqrt=False)


class LocalUpdateEngine:
    """The standalone engine of both baselines; ``algo`` is
    "local_momentum" or "fedadam". Worker gradients are a
    ``torch.func.vmap`` over per-worker parameters."""

    def __init__(self, loss_fn: Callable, n_workers: int, h_period: int,
                 algo: str = "local_momentum", lr: float = 0.1,
                 beta: float = 0.9, server_lr: float = 0.01,
                 server_betas=(0.9, 0.999), server_eps: float = 1e-3):
        if algo not in ("local_momentum", "fedadam"):
            raise ValueError(algo)
        self.m = n_workers
        self.h = h_period
        self.algo = algo
        self.lr = lr
        self.beta = beta
        grad_and_value = torch.func.grad_and_value(loss_fn)

        def value_and_grad(params, batch):
            g, v = grad_and_value(params, batch)
            return v, g

        self._vgrad = torch.func.vmap(value_and_grad, in_dims=(0, 0))
        self._server_opt = (_fedadam_server(server_lr, server_betas,
                                            server_eps)
                            if algo == "fedadam" else None)

    def init(self, params) -> LocalState:
        zeros = tree_map(
            lambda x: torch.zeros((self.m,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device), params)
        return LocalState(step=0, params=params, momenta=zeros,
                          server_opt=(self._server_opt.init(params)
                                      if self._server_opt else None))

    def round(self, state: LocalState, batches) -> tuple[LocalState, dict]:
        """One communication round, H local steps and one averaging.
        ``batches`` leads with (H, M, b, ...)."""
        wparams = tree_map(
            lambda x: x[None].expand((self.m,) + tuple(x.shape)),
            state.params)
        momenta = state.momenta
        if self.algo == "fedadam":
            momenta = tree_map(torch.zeros_like, momenta)  # plain local SGD
        losses = []
        for j in range(batch_lead(batches)):
            step_losses, grads = self._vgrad(
                wparams, batch_map(lambda x: x[j], batches))
            if self.algo == "local_momentum":
                momenta = tree_map(lambda m_, g: self.beta * m_ + g,
                                   momenta, grads)
                wparams = tree_map(lambda p, m_: p - self.lr * m_, wparams,
                                   momenta)
            else:
                wparams = tree_map(lambda p, g: p - self.lr * g, wparams,
                                   grads)
            losses.append(step_losses.mean())

        mean_params = tree_map(lambda x: x.mean(dim=0), wparams)
        if self.algo == "local_momentum":
            params = mean_params
            momenta = tree_map(
                lambda x: x.mean(dim=0, keepdim=True).expand(x.shape).clone(),
                momenta)
            server_opt = state.server_opt
        else:   # FedAdam: pseudo-gradient −(mean Δ) = θ_server − mean θ_m
            pseudo = tree_sub(state.params, mean_params)
            updates, server_opt = self._server_opt.update(
                pseudo, state.server_opt, state.params)
            params = apply_updates(state.params, updates)

        p = sum(x.numel() for x in tree_leaves(state.params))
        dev = tree_leaves(params)[0].device
        metrics = {
            "loss": torch.stack(losses),                    # (H,)
            "uploads": torch.tensor(self.m, dtype=torch.int32, device=dev),
            "grad_evals": torch.tensor(self.m * self.h, dtype=torch.int32,
                                       device=dev),
            "bytes_up": torch.tensor(float(self.m) * 4.0 * p,
                                     dtype=torch.float32, device=dev),
        }
        return LocalState(step=state.step + self.h, params=params,
                          momenta=momenta, server_opt=server_opt), metrics

    def run(self, state: LocalState, batches):
        """Round over pre-sampled batches with leading axes
        (rounds, H, M, b, ...); each metric stacked over rounds."""
        rows = []
        for i in range(batch_lead(batches)):
            state, metrics = self.round(state, batch_map(lambda x: x[i],
                                                         batches))
            rows.append(metrics)
        return state, {k: torch.stack([r[k] for r in rows])
                       for k in rows[0]}


# --------------------------------------------------- strategy-layer rules

def _masked_mean_losses(step_losses, h_steps):
    """(H, M) per-step losses (inactive rows already zero) -> (M,) mean
    over each worker's active steps."""
    return step_losses.sum(dim=0) / h_steps.to(step_losses.dtype)


class LocalUpdateStrategy(CommStrategy):
    """Shared base of the delta-payload rules: the local run, the payload
    θ^k − θ_m^(h). Subclasses supply the local optimizer step and,
    optionally, per-worker momenta."""

    delta_payload = True

    # ---- the pytree plane
    def _local_step(self, wp, grads, mom):
        """(new_wp, new_mom) of one local step on (M,)-leading dicts;
        ``mom`` may be None."""
        raise NotImplementedError

    def _initial_momenta(self, extras, params, m):
        """(M,)-leading momentum dict carried into the round, or None."""
        del extras, params, m
        return None

    def local_payload(self, extras, params, batch, m, vgrad_per, h_steps,
                      shard=None):
        """The local run on dicts: ``batch`` leads with (H, M, ...),
        ``h_steps`` is the (M,) int32 count of steps each worker takes.
        Returns the (M,) mean losses over each worker's steps, the
        (M,)-leading fp32 payload θ^k − θ_m^(h) and the momenta after the
        run (or None).

        On the mesh (``shard``, a ``TreeSharding``) M is the rank's one
        row: the local steps run at whole per-worker parameters (the
        rank's shards gathered, and momenta held as ``gwsp`` blocks
        gathered over the axes that cut them), ``vgrad_per`` takes whole
        parameters and gives whole gradients, and the payload and the
        momenta are cut back to the rank's blocks at the end."""
        if shard is not None:
            params = shard.whole_params(params)
        wp = broadcast_to_workers(params, m)
        mom = self._initial_momenta(extras, params, m)
        if mom is not None and shard is not None:
            mom = shard.whole_worker(mom)
        step_losses = []
        for j in range(batch_lead(batch)):
            losses, grads = vgrad_per(wp, batch_map(lambda x: x[j], batch))
            new_wp, new_mom = self._local_step(wp, grads, mom)
            active = j < h_steps
            wp = select_rows(active, new_wp, wp)
            if mom is not None:
                mom = select_rows(active, new_mom, mom)
            step_losses.append(torch.where(active, losses, 0.0))
        payload = tree_map(lambda p, w: p.float() - w.float(), params, wp)
        if shard is not None:
            payload = shard.cut_worker(payload)
            if mom is not None:
                mom = shard.cut_worker(mom)
        return (_masked_mean_losses(torch.stack(step_losses), h_steps),
                payload, mom)

    # ---- the flat plane
    def _local_step_flat(self, wp, g, mom):
        """(new_wp, new_mom) of one local step on (M, n_flat) fp32 planes;
        ``mom`` may be None."""
        raise NotImplementedError

    def _initial_momenta_flat(self, extras):
        """(M, n_flat) fp32 momenta carried into the round, or None."""
        del extras
        return None

    def flat_local_payload(self, layout, extras, params_flat, batch, m,
                           vgrad_per, h_steps, shard=None):
        """The local run: ``batch`` leads with (H, M, ...); ``h_steps`` is
        the (M,) int32 count of steps each worker takes. Returns the (M,)
        mean losses over each worker's steps, the (M, n_flat) fp32 payload
        θ^k − θ_m^(h) and the momenta after the run (or None). Each step
        evaluates the M workers at their own parameters (``vgrad_per``,
        which gets them cast to the layout's dtypes).

        On the mesh (``shard``) M is the rank's rows: the local steps need
        whole rows, so momenta held as a column slice are gathered over the
        column group first, and the payload and momenta are cut back to
        the slice at the end."""
        theta = params_flat.float()
        wp = theta[None].expand((m, layout.n_flat))
        mom = self._initial_momenta_flat(extras)
        if mom is not None and shard is not None and shard.col_axes:
            mom = shard.gather_cols(mom)
        step_losses = []
        for j in range(batch_lead(batch)):
            # each step's temporaries are freed before the next one is
            # made: at an LM's width every one is a plane of gigabytes
            losses, grads = vgrad_per(layout.unpack_worker(wp),
                                      batch_map(lambda x: x[j], batch))
            g = layout.pack_worker(grads)
            del grads
            new_wp, new_mom = self._local_step_flat(wp, g, mom)
            del g
            active = j < h_steps
            wp = torch.where(active[:, None], new_wp, wp)
            del new_wp
            if mom is not None:
                mom = torch.where(active[:, None], new_mom, mom)
            del new_mom
            step_losses.append(torch.where(active, losses, 0.0))
        payload = theta[None] - wp
        if shard is not None:
            payload = shard.cut_cols(payload, layout)
            if mom is not None:
                mom = shard.cut_cols(mom, layout)
        return (_masked_mean_losses(torch.stack(step_losses), h_steps),
                payload, mom)


@register
class LocalMomentumStrategy(LocalUpdateStrategy):
    """Local heavy-ball SGD with periodic model averaging, as a rule.

    Local step: mom ← β·mom + g; θ_m ← θ_m − lr·mom. The payload is the
    model delta, and the server optimizer sgd(1.0) makes the server step
    θ ← θ − mean_m(Δ_m) = mean_m(θ_m), the standalone engine's averaging.
    The momenta are an (M, n_flat) plane that persists across rounds; after
    each round the uploaders' momenta are replaced by their mean (offline
    workers took no local steps and keep theirs). The cohort plane pools
    them with the worker copies; its C-row average takes the dense masked
    plane's bits, as eq. (3)'s aggregate does."""

    kind = "local_momentum"

    def server_optimizer(self):
        return sgd(1.0)

    def _local_step(self, wp, grads, mom):
        r = self.rule
        new_mom = tree_map(
            lambda mo, g: (r.local_beta * mo.float() + g.float()
                           ).to(mo.dtype), mom, grads)
        new_wp = tree_map(
            lambda p, mo: (p.float() - r.local_lr * mo.float()).to(p.dtype),
            wp, new_mom)
        return new_wp, new_mom

    def _initial_momenta(self, extras, params, m):
        del params, m
        return extras["momenta"]

    def init_extras(self, params, m, make_grad_zeros, bcast):
        return {"momenta": bcast(make_grad_zeros(), m)}

    def extras_specs(self, param_spec, worker_param_spec, worker_grad_spec):
        return {"momenta": worker_grad_spec}

    def post_upload(self, extras, cache, upload, ctx):
        mom_run = cache   # the momenta after the local run
        cnt = upload.sum(dtype=torch.int32).clamp_min(1).float()
        rows = ctx.plane_rows(upload)

        def mask_of(x):
            return rows.reshape((-1,) + (1,) * (x.dim() - 1))

        masked = tree_map(lambda mn: torch.where(mask_of(mn), mn.float(),
                                                 0.0), mom_run)
        if ctx.shard is not None:
            # the uploaders' rows of the rank's blocks, over the workers
            masked = ctx.shard.worker_rows(masked)

        def leaf(ms, mo):
            avg = ms.sum(dim=0) / cnt
            return torch.where(mask_of(mo), avg[None].to(mo.dtype), mo)

        return {**extras,
                "momenta": tree_map(leaf, masked, extras["momenta"])}

    def _local_step_flat(self, wp, g, mom):
        r = self.rule
        new_mom = r.local_beta * mom + g
        return wp - r.local_lr * new_mom, new_mom

    def _initial_momenta_flat(self, extras):
        return extras["momenta"].float()

    def init_flat_extras(self, layout, params, params_flat, m, grad_dtype):
        return {"momenta": torch.zeros((m, layout.n_flat), dtype=grad_dtype,
                                       device=params_flat.device)}

    def flat_extras_specs(self, param_spec, worker_param_spec, waxis, P,
                          col_axes=()):
        return {"momenta": P(waxis, spec_dim(col_axes))}

    def pooled_extras(self):
        return ("momenta",)

    def flat_post_upload(self, extras, cache, upload, ctx):
        mom_run = cache   # the momenta after the local run
        cnt = upload.sum(dtype=torch.int32).clamp_min(1).float()
        rows = ctx.plane_rows(upload)
        masked = torch.where(rows[:, None], mom_run, 0.0)
        # the order-fixed row sum (denominator 1), then a true division by
        # the count: a masked plane and its uploaders' rows alone give the
        # same bits, as eq. (3)'s aggregate does (on the mesh: the sum over
        # the worker group of the rank's columns)
        avg = kops.eq3_row_mean(masked, 1, impl=ctx.impl,
                                shard=ctx.shard) / cnt
        mom = extras["momenta"]
        new = torch.where(rows[:, None], avg[None].to(mom.dtype), mom)
        return {**extras, "momenta": new}


@register
class FedAdamStrategy(LocalUpdateStrategy):
    """FedAdam (Reddi et al., arXiv 2003.00295) as a rule: plain local SGD
    steps, the delta payload, and the server Adam of the standalone engine
    (lr ``server_lr``, β (0.9, 0.999), ε 1e-3 outside the root, no
    AMSGrad); mean_m(Δ_m) is its pseudo-gradient. No per-worker state
    beyond the worker copy."""

    kind = "fedadam"

    def server_optimizer(self):
        return _fedadam_server(self.rule.server_lr)

    def _local_step(self, wp, grads, mom):
        lr = self.rule.local_lr
        return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                        wp, grads), mom

    def _local_step_flat(self, wp, g, mom):
        return wp - self.rule.local_lr * g, mom
