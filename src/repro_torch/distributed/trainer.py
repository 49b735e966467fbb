"""The LM trainer on one device: the mesh-free part of the JAX package's
``distributed/trainer.py``.

The paper's server/worker protocol on a language model. The communication
round is :func:`repro_torch.core.flat.flat_comm_round`, the SAME core the
engine (``core/engine.py``) runs, so the two implementations of Algorithm 1
cannot drift; this module keeps what is the trainer's own: the
hyper-parameters, the state, the per-worker gradients with microbatch
accumulation, and the server step on the packed plane (the AMSGrad kernel
on the card).

Per-worker gradients are a Python loop over the M workers with
``torch.autograd.grad`` (the reference vmaps): only one worker's
activations are alive at a time, and ``torch.utils.checkpoint`` (the
model's ``remat``) does not compose with ``torch.func`` transforms. The
loop returns the M-stacked gradient trees ``flat_comm_round`` expects; the
rule's second evaluation runs per worker (``fuse_evals=False``), as on the
reference's per-worker route.

The delta-payload rules (``local_momentum``, ``fedadam``) ride the same
flat step: the round returns the workers' mean model delta as ∇ and the
trainer's AMSGrad server step consumes it (the reference's "FedAMSGrad":
server momentum over deltas; the engine runs the rules' own sgd(1.0) and
Adam servers). Their batches lead with the local-steps axis H
(``worker_split(..., local_steps=H)``), and each local step is one more
loop over the workers, one worker's activations live at a time.

The forward takes the model's training route (``lm_loss(train=True)``):
the reference's jnp attention and chunked scan, here in PyTorch under
autograd. The kernels on the step's path are the server step and the rule
LHS norms (``kernels/ops.py``): on a CUDA tensor they launch or raise.

The federated form (:func:`init_cohort_train_state`,
:func:`make_cohort_train_step`, :func:`run_cohort_train`) keeps the M
workers' (M, n_flat) planes in a host ``flat.WorkerPool`` and moves only
the C sampled workers' rows to the device each round, through the cohort
round (``flat.flat_cohort_round``) and its pipelined driver; its
per-worker gradients come from the same loop, its server step is the
same AMSGrad kernel.

Not here, and refused by name where a field asks for them: the mesh, FSDP
and ZeRO-sharded state (``fsdp``, ``fsdp_axes``, ``state_fsdp_axes``,
``shard_cada_state``), the grouped second evaluation (``group_evals``),
the per-leaf debug plane (``fused=False``) and the pod shard_map.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.core.comm import strategy_for
from repro_torch.core.rules import CommRule
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_params, lm_loss
from repro_torch.utils.trees import (tree_leaves, tree_map, tree_paths,
                                     tree_unflatten)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# field: (its default, what would run it)
_REFUSED = {"fsdp": (None, "the mesh runtime"),
            "fsdp_axes": (("data",), "the mesh runtime"),
            "state_fsdp_axes": ((), "the mesh runtime (ZeRO-sharded state)"),
            "shard_cada_state": (False,
                                 "the mesh runtime (ZeRO-sharded state)"),
            "group_evals": (False, "the grouped second evaluation")}


@dataclass(frozen=True)
class TrainHParams:
    rule: CommRule = field(default_factory=lambda: CommRule(kind="cada2"))
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    microbatches: int = 1
    cada_dtype: str = "float32"     # ∇ / stale-plane storage
    moments_dtype: str = "float32"  # {h, v̂} storage (math stays fp32)
    fused: bool = True              # the flat plane, the only one ported
    fsdp: bool | None = None
    fsdp_axes: tuple = ("data",)
    state_fsdp_axes: tuple = ()
    shard_cada_state: bool = False
    group_evals: bool = False

    def __post_init__(self):
        for name, (default, what) in _REFUSED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"TrainHParams.{name}={getattr(self, name)!r}: "
                    f"{what} is not ported to repro_torch yet")
        if not self.fused:
            raise NotImplementedError(
                "TrainHParams.fused=False: the per-leaf debug plane is not "
                "ported; repro_torch runs the flat plane only")
        for name in ("cada_dtype", "moments_dtype"):
            if getattr(self, name) not in _DTYPES:
                raise ValueError(f"{name} must be one of {sorted(_DTYPES)}")
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")

    @property
    def cada_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.cada_dtype]

    @property
    def moments_torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.moments_dtype]


class DistTrainState(NamedTuple):
    step: int                # k
    params: Any              # θ^k (dict of tensors)
    h: torch.Tensor          # (n_flat,) first moment
    vhat: torch.Tensor       # (n_flat,) running max second moment
    comm: Any                # FlatCommState (None for stateless rules)


def worker_split(batch: dict, m: int, local_steps: int = 1) -> dict:
    """Global batch -> (M, b_m, ...) per-worker leading axis (positions:
    (3, B, S) -> (M, 3, b_m, S)). ``local_steps`` H > 1 (delta-payload
    rules) carves the batch into H per-local-step slices first:
    (H, M, b_m, ...) with b_m = B / (H · M), so a round consumes the same
    global sample count whatever the cadence. Leaves may be tensors or
    numpy arrays."""
    hm = local_steps * m
    out = {}
    for key, leaf in batch.items():
        if key == "positions":
            three, b = leaf.shape[0], leaf.shape[1]
            split = leaf.reshape((three, hm, b // hm)
                                 + tuple(leaf.shape[2:])).swapaxes(0, 1)
        else:
            b = leaf.shape[0]
            split = leaf.reshape((hm, b // hm) + tuple(leaf.shape[1:]))
        out[key] = (split.reshape((local_steps, m) + tuple(split.shape[1:]))
                    if local_steps > 1 else split)
    return out


def init_train_state(cfg: ModelConfig, hp: TrainHParams, m: int,
                     seed: int = 0, device=None) -> DistTrainState:
    """Parameters drawn on ``device`` (None: the card) from ``seed``, zero
    moments on the flat plane, and the rule's flat CommState (none for a
    stateless rule)."""
    device = resolve_device(device)
    params = init_params(cfg, seed, device)
    strategy = strategy_for(hp.rule)
    layout = F.layout_of(params)
    return DistTrainState(
        step=0,
        params=params,
        h=torch.zeros((layout.n_flat,), dtype=hp.moments_torch_dtype,
                      device=device),
        vhat=torch.zeros((layout.n_flat,), dtype=hp.moments_torch_dtype,
                         device=device),
        comm=(None if strategy.stateless else
              F.init_flat_comm_state(strategy, layout, params, m,
                                     grad_dtype=hp.cada_torch_dtype)))


def _value_and_grad(loss_fn, params, wbatch):
    """(loss, gradient tree) of ``loss_fn(params, wbatch)``; gradients in
    each leaf's dtype, as ``jax.grad`` gives them."""
    paths, leaves = tree_paths(params), tree_leaves(params)
    req = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(paths, req), wbatch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(paths, grads)


def make_worker_grad(cfg: ModelConfig, hp: TrainHParams):
    """One worker's mean LM gradient, with the reference's microbatch
    accumulation: the largest count <= ``hp.microbatches`` that divides the
    worker's batch; with more than one, the losses and gradients are summed
    in fp32 and divided by the count."""
    def loss_fn(params, wbatch):
        return lm_loss(cfg, params, wbatch, train=True)[0]

    def worker_grad(params, wbatch):
        bm = wbatch["tokens"].shape[0]
        nm = min(hp.microbatches, bm)
        while bm % nm:
            nm -= 1
        if nm == 1:
            return _value_and_grad(loss_fn, params, wbatch)
        size = bm // nm
        loss_s = g_s = None
        for j in range(nm):
            micro = {k: (v[:, j * size:(j + 1) * size] if k == "positions"
                         else v[j * size:(j + 1) * size])
                     for k, v in wbatch.items()}
            loss, g = _value_and_grad(loss_fn, params, micro)
            if g_s is None:   # the reference adds onto fp32 zeros: exact
                loss_s, g_s = loss, tree_map(lambda x: x.float(), g)
            else:
                loss_s, g_s = loss_s + loss, tree_map(torch.add, g_s, g)
        return loss_s / nm, tree_map(lambda x: x / nm, g_s)

    return worker_grad


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def make_vgrads(cfg: ModelConfig, hp: TrainHParams):
    """``(vgrad, vgrad_per)``: the workers' (losses (M,), M-stacked
    gradient trees), each worker on its own slice of the batch, at one
    shared parameter tree (``vgrad``) or at its own row of an M-leading one
    (``vgrad_per``). A loop over the batch's leading (worker) axis, one
    worker at a time: M workers on the dense plane, C on the cohort
    plane."""
    worker_grad = make_worker_grad(cfg, hp)

    def run(point, batch):
        losses, grads = [], []
        for i in range(next(iter(batch.values())).shape[0]):
            loss, g = worker_grad(point(i), {k: v[i]
                                             for k, v in batch.items()})
            losses.append(loss)
            grads.append(g)
        return torch.stack(losses), _stack(grads)

    def vgrad(params, batch):
        return run(lambda i: params, batch)

    def vgrad_per(wparams, batch):
        return run(lambda i: tree_map(lambda x: x[i], wparams), batch)

    return vgrad, vgrad_per


def make_train_step(cfg: ModelConfig, hp: TrainHParams, m: int, *,
                    impl=None):
    """``step(state, batch) -> (state, metrics)``: one round of Algorithm 1
    on the LM. ``batch`` leaves carry an (M,)-leading worker axis, or
    (H, M) for a delta-payload rule with H local steps
    (:func:`worker_split`). ``impl`` is the dispatch override of
    ``kernels/ops.py`` (None on the main path). The state is not updated in
    place."""
    strategy = strategy_for(hp.rule)
    vgrad, vgrad_per = make_vgrads(cfg, hp)

    def fused_update(layout, pflat, h, vhat, grad_flat):
        """The server step on the packed fp32 plane (the AMSGrad kernel on
        the card), then θ' rounded through each leaf's storage dtype."""
        theta, h2, vh2, dsq = kops.fused_amsgrad_flat(
            pflat, h, vhat, grad_flat, hp.lr, b1=hp.b1, b2=hp.b2,
            eps=hp.eps, impl=impl)
        return layout.unpack(layout.cast_roundtrip(theta)), h2, vh2, dsq

    # stateless rules (always ⇒ distributed AMSGrad): no innovation state
    if strategy.stateless:
        def step_always(state: DistTrainState, batch):
            layout = F.layout_of(state.params)
            losses, fresh = vgrad(state.params, batch)
            grad_flat = torch.mean(layout.pack_worker(fresh), dim=0)
            params, h, vhat, dsq = fused_update(
                layout, layout.pack(state.params), state.h, state.vhat,
                grad_flat)
            new_state = state._replace(step=state.step + 1, params=params,
                                       h=h, vhat=vhat)
            dev = grad_flat.device
            return new_state, {
                "loss": losses.mean(),
                "uploads": torch.tensor(m, dtype=torch.int32, device=dev),
                "skip_rate": torch.zeros((), dtype=torch.float32,
                                         device=dev),
                "upload_mask": torch.ones((m,), dtype=torch.bool,
                                          device=dev),
                "staleness": torch.ones((m,), dtype=torch.int32,
                                        device=dev),
                "dtheta_sq": dsq,
            }
        return step_always

    # rules with innovation state: the shared Algorithm-1 core drives the
    # round; this function only applies the server update
    def step_flat(state: DistTrainState, batch):
        k = state.step
        layout = F.layout_of(state.params)
        pflat = layout.pack(state.params)
        out = F.flat_comm_round(
            strategy, layout, state.comm, state.params, pflat, batch, k,
            vgrad=vgrad, vgrad_per=vgrad_per, fuse_evals=False, impl=impl)
        params, h, vhat, dsq = fused_update(layout, pflat, state.h,
                                            state.vhat, F.nabla_f32(out.comm))
        comm = F.record_progress(out.comm, dsq, k)
        new_state = DistTrainState(step=k + 1, params=params, h=h,
                                   vhat=vhat, comm=comm)
        return new_state, {"loss": out.losses.mean(), "dtheta_sq": dsq,
                           **out.metrics}

    return step_flat


# ------------------------------------------------------- federated cohort

class CohortTrainState(NamedTuple):
    """Trainer state on the cohort plane: the (M, n_flat) per-worker
    planes live in a host ``flat.WorkerPool``; this holds the O(n) server
    buffers and the O(M) vectors."""
    step: int
    params: Any
    h: torch.Tensor          # (n_flat,) first moment
    vhat: torch.Tensor       # (n_flat,) running max second moment
    server: Any              # flat.CohortServerState
    params_flat: torch.Tensor


def init_cohort_train_state(cfg: ModelConfig, hp: TrainHParams, m: int,
                            seed: int = 0, *, pool_storage: str = "ram",
                            pool_path: str | None = None, device=None):
    """(CohortTrainState, WorkerPool) for M federated workers, parameters
    drawn on ``device`` (None: the card) from ``seed``: device memory
    O(n), the host pool O(M·n) (``pool_storage="memmap"`` and
    ``pool_path`` put it in files)."""
    device = resolve_device(device)
    params = init_params(cfg, seed, device)
    layout = F.layout_of(params)
    params_flat = layout.pack(params)
    server, pool = F.init_cohort_state(
        strategy_for(hp.rule), layout, params, m,
        grad_dtype=hp.cada_torch_dtype, params_flat=params_flat,
        pool_storage=pool_storage, pool_path=pool_path)
    state = CohortTrainState(
        step=0, params=params,
        h=torch.zeros((layout.n_flat,), dtype=hp.moments_torch_dtype,
                      device=device),
        vhat=torch.zeros((layout.n_flat,), dtype=hp.moments_torch_dtype,
                         device=device),
        server=server, params_flat=params_flat)
    return state, pool


def make_cohort_train_step(cfg: ModelConfig, hp: TrainHParams, m: int, *,
                           impl=None):
    """The federated LM step: ``train_step(state, pool, batch, cohort) ->
    (state, metrics)``.

    A round moves only the C sampled workers' rows: the gather from the
    host pool, one cohort round (``flat.flat_cohort_round``, bit-exact to
    the dense plane with the cohort as its participation mask), the
    AMSGrad server step, the scatter back. ``batch`` holds ONLY the
    cohort's rows ((C, b, ...) leaves from :func:`worker_split`; at
    federated M an (M, b, ...) batch is itself the memory wall); the
    per-worker gradients are :func:`make_vgrads`' loop over them.
    ``train_step.fused_step_for(pool)`` is the block step the pipelined
    driver (:func:`run_cohort_train`) runs."""
    strategy = strategy_for(hp.rule)
    vgrad, vgrad_per = make_vgrads(cfg, hp)

    def fused_step_for(pool):
        """The fused-block step bound to ``pool``'s block layout (the
        planes' stacking order and storage dtype)."""
        order, dtype = pool.plane_order, pool.plane_dtype

        def step(state: CohortTrainState, fused, batch, cohort):
            k = state.step
            layout = F.layout_of(state.params)
            out = F.flat_cohort_round(
                strategy, layout, state.server,
                F.split_fused_rows(fused, order), state.params,
                state.params_flat, batch, k, cohort, m_total=m,
                vgrad=vgrad, vgrad_per=vgrad_per, fuse_evals=False,
                impl=impl)
            theta, h, vhat, dsq = kops.fused_amsgrad_flat(
                state.params_flat, state.h, state.vhat,
                out.server.nabla.float(), hp.lr, b1=hp.b1, b2=hp.b2,
                eps=hp.eps, impl=impl)
            theta = layout.cast_roundtrip(theta)
            new_state = CohortTrainState(
                step=k + 1, params=layout.unpack(theta), h=h, vhat=vhat,
                server=F.record_progress(out.server, dsq, k),
                params_flat=theta)
            metrics = {"loss": out.losses.mean(), "dtheta_sq": dsq,
                       **out.metrics}
            return new_state, F.stack_fused_rows(out.rows, order,
                                                 dtype), metrics

        return step

    def train_step(state: CohortTrainState, pool, batch, cohort):
        cohort = np.sort(np.asarray(cohort).astype(np.int32))
        fused = pool.gather_fused(cohort)
        state, out, metrics = fused_step_for(pool)(
            state, fused, batch,
            torch.as_tensor(cohort, dtype=torch.long, device=pool.device))
        del fused
        pool.scatter_fused(cohort, out)
        return state, metrics

    train_step.fused_step_for = fused_step_for
    return train_step


def run_cohort_train(train_step, state: CohortTrainState, pool, batches,
                     cohorts, *, pipeline: bool = True,
                     metrics_every: int = 8, trace=None,
                     metrics_out: list | None = None):
    """Cohort rounds of the trainer over a (T, C) schedule, the federated
    form of ``CADAEngine.run_cohort``. ``train_step`` comes from
    :func:`make_cohort_train_step`; ``batches`` is a list or tuple of
    per-round cohort batches or a callable ``batches(i, cohort)``.
    ``pipeline=True`` overlaps the copies with the rounds, bit-exact to
    the serial ``pipeline=False``; ``flat.run_cohort_rounds`` has the
    contract. Returns (state, list of host metric dicts)."""
    batch_fn = batches if callable(batches) else lambda i, _c: batches[i]
    return F.run_cohort_rounds(
        train_step.fused_step_for(pool), state, pool, batch_fn, cohorts,
        pipeline=pipeline, metrics_every=metrics_every, trace=trace,
        metrics_out=metrics_out)
