"""The LM trainer: the JAX package's ``distributed/trainer.py``, on one
device and on a mesh of ranks.

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
autograd. Every model of the registry trains: a MoE model's loss carries
its routers' auxiliary loss, and an embedding-input model takes
{"embeds", "labels"} batches, with optional M-RoPE "positions" (3, B, S),
which :func:`worker_split` cuts to (M, 3, b_m, S). The kernels on the
step's path are the server step and the rule LHS norms
(``kernels/ops.py``): on a CUDA tensor they launch or raise.

The federated form (:func:`init_cohort_train_state`,
:func:`make_cohort_train_step`, :func:`run_cohort_train`) keeps the M
workers' (M, n_flat) planes in a host ``flat.WorkerPool`` and moves only
the C sampled workers' rows to the device each round, through the cohort
round (``flat.flat_cohort_round``) and its pipelined driver; its
per-worker gradients come from the same loop, its server step is the
same AMSGrad kernel.

``fused=False`` selects the per-leaf pytree plane, the reference's debug
oracle: the state's moments are dicts, the round is
:func:`repro_torch.core.comm.comm_round`, and the server step is
:func:`_amsgrad_apply`, eager per-leaf PyTorch with no kernel, as in the
reference. It runs the dense step only; the cohort plane refuses it.

``group_evals`` (cada2's second evaluation once per occupied ring row,
``flat.grouped_second_plane``) reaches the dense flat step, as in the
reference; the cohort step gathers.

The mesh runtime (:func:`jit_train_step`, the reference's step of the
same name) runs the mesh's axes as processes of a ``torch.distributed``
process group (``launch.mesh.Mesh``). Worker m is the ranks at coordinate
m of the worker axis ("data" on the single-pod mesh, "pod" on the
multi-pod one), and each rank computes only its own worker's gradient
(the structural locality of the reference's ``make_pod_vgrads``), the
mean over its pod's "data" ranks on the pod mesh.

Parameters are cut by ``param_pspecs(cfg, mesh, fsdp, fsdp_axes)``: over
the model axis (tensor parallelism) and, with FSDP on (by value or by
``sharding.wants_fsdp``), over the FSDP axes. A rank's forward and
backward run on its shards through ``sharding.TPContext``: each
collective of the model axis has its backward, and each FSDP leaf is
gathered per layer inside the remat region, its gradient handed back
whole (every data rank is another worker, whose own gradient Algorithm 1
needs whole). An evaluation at a point that is the worker's own (cada2's
stale iterate, a delta rule's local parameters) runs under
``train_context(worker=True)``: its FSDP gathers leave out the worker
axis, over which the rank holds its worker's point whole (the flat
plane's ring rows gathered by ``FlatSharding.worker_points``), since
another worker's ranks hold another point. The rank's gradients are then
gathered over the model axis into whole leaves.

The flat plane stays the reference's: ``flat_layout`` over whole leaves,
ZeRO-sharded as ``flat_state_axes`` resolves it (``state_fsdp_axes``,
``shard_cada_state``, the FSDP axes). A rank holds its server slice of θ,
h, v̂ and ∇, and its worker's row of the (M, n_flat) planes, cut to its
column slice; the AMSGrad kernel and the LHS norms run on those slices
and one all-reduce completes their scalars (``kernels/ops.py``). Every
model rank of a data group runs the same round on the same slice. θ' is
gathered whole and cut back to the rank's parameter shards.

The pytree plane (``fused=False``) runs on the mesh too, with the
reference's per-leaf specs (:func:`train_state_specs`,
``sharding.TreeSharding``): the moments over ``state_fsdp_axes``, ∇ and
the worker trees over "data" under ``shard_cada_state``, everything else
by the parameters' specs. A rank holds its blocks of each leaf; the round
(``comm.comm_round(shard=)``) runs on them, its per-leaf norms, the wire's
scales and top-k's selection completed over the axes that cut each leaf,
eq. (3) the mean of the workers' rows gathered over the worker axis; the
server step is :func:`_amsgrad_apply` on the moments' blocks, Σupd²
completed over their axes, and θ' moved back to the parameters' blocks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.core.comm import (comm_round, comm_state_specs,
                                   init_comm_state, nabla_f32,
                                   record_progress, strategy_for)
from repro_torch.core.rules import CommRule
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (FlatSharding, P, TPContext,
                                              TreeSharding, cut, cut_tree,
                                              model_specs, one_dim_per_axis,
                                              param_pspecs, strip_axis,
                                              uncut, uncut_tree, wants_fsdp)
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import DATA, POD
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import abstract_params, init_params, lm_loss
from repro_torch.obs.trace import as_tracer
from repro_torch.utils.trees import (tree_add, tree_leaves, tree_map,
                                     tree_paths, tree_sq_norm,
                                     tree_unflatten, tree_zeros_like)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    fused: bool = True              # the flat plane; False: the per-leaf
    #                                 pytree plane (the debug oracle)
    fsdp: bool | None = None
    fsdp_axes: tuple = ("data",)
    state_fsdp_axes: tuple = ()
    shard_cada_state: bool = False
    group_evals: bool = False       # cada2's second evaluation once per
    #                                 occupied ring row (flat step only)

    def __post_init__(self):
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
    h: Any                   # first moment: (n_flat,), or a dict (pytree)
    vhat: Any                # running max second moment, likewise
    comm: Any                # FlatCommState, or CommState on the pytree
    #                          plane (None for stateless rules)


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
                     seed: int = 0, device=None,
                     shards: int = 1) -> DistTrainState:
    """Parameters drawn on ``device`` (None: the card) from ``seed``, zero
    moments and the rule's CommState (none for a stateless rule): on the
    flat plane, or per leaf when ``hp.fused`` is False. ``shards`` is the
    flat plane's state-shard count (the pad divisor of ``n_flat``): 1
    off the mesh; ``flat_state_shards(cfg, mesh, hp)`` for a state that
    :func:`shard_train_state` cuts for :func:`jit_train_step`."""
    device = resolve_device(device)
    return _state(hp, m, init_params(cfg, seed, device), device, shards)


def abstract_train_state(cfg: ModelConfig, hp: TrainHParams, m: int,
                         shards: int = 1) -> DistTrainState:
    """:func:`init_train_state`'s structure on the ``meta`` device: every
    tensor's shape and dtype, no storage."""
    return _state(hp, m, abstract_params(cfg), torch.device("meta"), shards)


def _state(hp: TrainHParams, m: int, params, device,
           shards: int) -> DistTrainState:
    strategy = strategy_for(hp.rule)
    if not hp.fused:
        return DistTrainState(
            step=0, params=params,
            h=tree_zeros_like(params, hp.moments_torch_dtype),
            vhat=tree_zeros_like(params, hp.moments_torch_dtype),
            comm=(None if strategy.stateless else
                  init_comm_state(strategy, params, m,
                                  grad_dtype=hp.cada_torch_dtype)))
    layout = F.layout_of(params, shards=shards)
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


def _amsgrad_apply(params, h, vhat, grad, hp: TrainHParams, complete=None):
    """The paper's (2a)-(2c) per leaf, in eager PyTorch (the pytree
    plane's server step; no kernel, as in the reference): (params', h',
    v̂', ||Δθ||²). Math in fp32; the moments keep their storage dtype.
    ``complete`` (the mesh runtime's, or None): the leaves are the rank's
    blocks, and ``complete(sums)`` takes the list of the leaves' partial
    Σupd² to the whole leaves' before they are added in leaf order."""
    h_new = tree_map(
        lambda m, g: (hp.b1 * m.float() + (1 - hp.b1) * g.float()
                      ).to(m.dtype), h, grad)
    vhat_new = tree_map(
        lambda s, g: torch.maximum(
            hp.b2 * s.float() + (1 - hp.b2) * torch.square(g.float()),
            s.float()).to(s.dtype), vhat, grad)
    upd = tree_map(lambda m, s: (-hp.lr * m.float()
                                 / torch.sqrt(hp.eps + s.float())),
                   h_new, vhat_new)
    new_params = tree_map(lambda p, u: (p.float() + u).to(p.dtype),
                          params, upd)
    if complete is None:
        return new_params, h_new, vhat_new, tree_sq_norm(upd)
    sums = complete([torch.sum(torch.square(u)) for u in tree_leaves(upd)])
    return new_params, h_new, vhat_new, sum(sums)


def _value_and_grad(loss_fn, params, wbatch, tp=None):
    """(loss, gradient tree) of ``loss_fn(params, wbatch)``; gradients in
    each leaf's dtype, as ``jax.grad`` gives them. Under ``tp`` the params
    are the rank's shards; an FSDP leaf's gradient comes back whole on its
    FSDP dim (``TPContext.grad_leaves``)."""
    paths, leaves = tree_paths(params), tree_leaves(params)
    if tp is None:
        req = model = [p.detach().requires_grad_() for p in leaves]
    else:
        req, model = tp.grad_leaves(paths, leaves)
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(paths, model), wbatch)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(req, grads)]
    return loss.detach(), tree_unflatten(paths, grads)


def make_worker_grad(cfg: ModelConfig, hp: TrainHParams, tp=None):
    """One worker's mean LM gradient, with the reference's microbatch
    accumulation: the largest count <= ``hp.microbatches`` that divides the
    worker's batch; with more than one, the losses and gradients are summed
    in fp32 and divided by the count. ``tp`` (a ``sharding.TPContext``):
    the params are the rank's shards (:func:`jit_train_step`)."""
    def loss_fn(params, wbatch):
        return lm_loss(cfg, params, wbatch, train=True, tp=tp)[0]

    def worker_grad(params, wbatch):
        bm = wbatch["tokens" if "tokens" in wbatch else "labels"].shape[0]
        nm = min(hp.microbatches, bm)
        while bm % nm:
            nm -= 1
        if nm == 1:
            return _value_and_grad(loss_fn, params, wbatch, tp)
        size = bm // nm
        loss_s = g_s = None
        for j in range(nm):
            micro = {k: (v[:, j * size:(j + 1) * size] if k == "positions"
                         else v[j * size:(j + 1) * size])
                     for k, v in wbatch.items()}
            loss, g = _value_and_grad(loss_fn, params, micro, tp)
            if g_s is None:   # the reference adds onto fp32 zeros: exact
                loss_s, g_s = loss, tree_map(lambda x: x.float(), g)
            else:
                loss_s, g_s = loss_s + loss, tree_add(g_s, g)
        return loss_s / nm, tree_map(lambda x: x / nm, g_s)

    return worker_grad


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def make_vgrads(cfg: ModelConfig, hp: TrainHParams, tp=None):
    """``(vgrad, vgrad_per)``: the workers' (losses (M,), M-stacked
    gradient trees), each worker on its own slice of the batch, at one
    shared parameter tree (``vgrad``) or at its own row of an M-leading one
    (``vgrad_per``). A loop over the batch's leading (worker) axis, one
    worker at a time: M workers on the dense plane, C on the cohort
    plane, the rank's own on the mesh (``tp``: its shards)."""
    worker_grad = make_worker_grad(cfg, hp, tp)

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


def _always_metrics(losses, m: int, dsq) -> dict:
    """A stateless rule's step metrics: every worker uploads, none waits."""
    dev = losses.device
    return {"loss": losses.mean(),
            "uploads": torch.tensor(m, dtype=torch.int32, device=dev),
            "skip_rate": torch.zeros((), dtype=torch.float32, device=dev),
            "upload_mask": torch.ones((m,), dtype=torch.bool, device=dev),
            "staleness": torch.ones((m,), dtype=torch.int32, device=dev),
            "dtheta_sq": dsq}


def make_train_step(cfg: ModelConfig, hp: TrainHParams, m: int, *,
                    impl=None, shards: int = 1):
    """``step(state, batch, trace=None) -> (state, metrics)``: one round of
    Algorithm 1 on the LM. ``batch`` leaves carry an (M,)-leading worker
    axis, or (H, M) for a delta-payload rule with H local steps
    (:func:`worker_split`). ``impl`` is the dispatch override of
    ``kernels/ops.py`` (None on the main path). The state is not updated in
    place. With ``hp.fused`` False the step runs the pytree plane.
    ``trace`` (an ``obs.Tracer``) records the step's ``train.step`` span
    and, on the flat plane, its phases (``obs`` names them); the work is
    the same with it or without.
    ``shards`` is the state's pad divisor (:func:`init_train_state`).
    One process holds whole parameters: the FSDP knobs shape only the
    mesh runtime."""
    strategy = strategy_for(hp.rule)
    vgrad, vgrad_per = make_vgrads(cfg, hp)
    if not hp.fused:
        return _make_pytree_step(strategy, hp, m, vgrad, vgrad_per)

    def fused_update(layout, pflat, h, vhat, grad_flat):
        """The server step on the packed fp32 plane (the AMSGrad kernel on
        the card), then θ' rounded through each leaf's storage dtype."""
        theta, h2, vh2, dsq = kops.fused_amsgrad_flat(
            pflat, h, vhat, grad_flat, hp.lr, b1=hp.b1, b2=hp.b2,
            eps=hp.eps, impl=impl)
        return layout.unpack(layout.cast_roundtrip(theta)), h2, vh2, dsq

    # stateless rules (always ⇒ distributed AMSGrad): no innovation state
    if strategy.stateless:
        def step_always(state: DistTrainState, batch, trace=None):
            trace = as_tracer(trace)
            with trace.span("train.step", "train",
                            args=_step_args(state, trace)):
                layout = F.layout_of(state.params, shards=shards)
                with trace.span("train.grads", "train"):
                    losses, fresh = vgrad(state.params, batch)
                with trace.span("cada.pack", "cada"):
                    plane = layout.pack_worker(fresh)
                with trace.span("cada.eq3", "cada"):
                    grad_flat = torch.mean(plane, dim=0)
                    del plane
                with trace.span("cada.pack", "cada"):
                    pflat = layout.pack(state.params)
                with trace.span("cada.server", "cada"):
                    params, h, vhat, dsq = fused_update(
                        layout, pflat, state.h, state.vhat, grad_flat)
                new_state = state._replace(step=state.step + 1,
                                           params=params, h=h, vhat=vhat)
                return new_state, _always_metrics(losses, m, dsq)
        return step_always

    # rules with innovation state: the shared Algorithm-1 core drives the
    # round; this function only applies the server update
    def step_flat(state: DistTrainState, batch, trace=None):
        trace = as_tracer(trace)
        k = state.step
        with trace.span("train.step", "train", args=_step_args(state, trace)):
            layout = F.layout_of(state.params, shards=shards)
            with trace.span("cada.pack", "cada"):
                pflat = layout.pack(state.params)
            out = F.flat_comm_round(
                strategy, layout, state.comm, state.params, pflat, batch, k,
                vgrad=vgrad, vgrad_per=vgrad_per, fuse_evals=False,
                group_evals=hp.group_evals, impl=impl, trace=trace)
            with trace.span("cada.server", "cada"):
                params, h, vhat, dsq = fused_update(
                    layout, pflat, state.h, state.vhat, F.nabla_f32(out.comm))
                comm = F.record_progress(out.comm, dsq, k)
            new_state = DistTrainState(step=k + 1, params=params, h=h,
                                       vhat=vhat, comm=comm)
            return new_state, {"loss": out.losses.mean(), "dtheta_sq": dsq,
                               **out.metrics}

    return step_flat


def _step_args(state: DistTrainState, trace):
    """The ``train.step`` span's arguments (none when not tracing)."""
    return {"step": int(state.step)} if trace else None


def _make_pytree_step(strategy, hp: TrainHParams, m: int, vgrad,
                      vgrad_per):
    """The pytree plane's step (``fused=False``): the per-leaf round and
    :func:`_amsgrad_apply`."""
    if strategy.stateless:
        def step_always(state: DistTrainState, batch, trace=None):
            trace = as_tracer(trace)
            with trace.span("train.step", "train",
                            args=_step_args(state, trace)):
                losses, fresh = vgrad(state.params, batch)
                grad = tree_map(lambda g: torch.mean(g, dim=0), fresh)
                params, h, vhat, dsq = _amsgrad_apply(
                    state.params, state.h, state.vhat, grad, hp)
                new_state = state._replace(step=state.step + 1,
                                           params=params, h=h, vhat=vhat)
                return new_state, _always_metrics(losses, m, dsq)
        return step_always

    def step(state: DistTrainState, batch, trace=None):
        trace = as_tracer(trace)
        k = state.step
        with trace.span("train.step", "train", args=_step_args(state, trace)):
            out = comm_round(strategy, state.comm, state.params, batch, k,
                             vgrad=vgrad, vgrad_per=vgrad_per)
            params, h, vhat, dsq = _amsgrad_apply(
                state.params, state.h, state.vhat, nabla_f32(out.comm), hp)
            comm = record_progress(out.comm, dsq, k)
            new_state = DistTrainState(step=k + 1, params=params, h=h,
                                       vhat=vhat, comm=comm)
            return new_state, {"loss": out.losses.mean(), "dtheta_sq": dsq,
                               **out.metrics}

    return step


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
    ``pool_path`` put it in files). Requires ``hp.fused``."""
    if not hp.fused:
        raise ValueError("the cohort plane requires fused=True")
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
    driver (:func:`run_cohort_train`) runs. Requires ``hp.fused``."""
    if not hp.fused:
        raise ValueError("the cohort plane requires fused=True")
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


# ------------------------------------------------------------ mesh runtime

def worker_axis_name(mesh) -> str:
    """The mesh axis of CADA's workers: "pod" on the multi-pod mesh, else
    "data"."""
    return POD if POD in mesh.shape else DATA


def flat_state_axes(cfg: ModelConfig, mesh, hp: TrainHParams) -> tuple:
    """Mesh axes the (n_flat,) flat SERVER planes (θ, h, v̂, ∇) shard over:
    explicit ``state_fsdp_axes``, then ``shard_cada_state`` (("data",)),
    then the param FSDP axes when FSDP is on (explicitly or by
    ``sharding.wants_fsdp``), else none. Axes absent from the mesh or of
    size 1 are dropped, so the same hyper-parameters resolve on every
    mesh. The pytree plane has no flat state: ()."""
    if not hp.fused:
        return ()
    if hp.state_fsdp_axes:
        axes = hp.state_fsdp_axes
    elif hp.shard_cada_state:
        axes = (DATA,)
    elif hp.fsdp or (hp.fsdp is None and wants_fsdp(cfg, mesh)):
        axes = hp.fsdp_axes
    else:
        return ()
    return tuple(a for a in axes if a in mesh.shape and mesh.shape[a] > 1)


def flat_sharding(cfg: ModelConfig, mesh, hp: TrainHParams) -> FlatSharding:
    """The resolved :class:`sharding.FlatSharding` for (cfg, mesh, hp): the
    one object the layout's pad divisor (``.shards``), the plane specs and
    the shard-local kernels all read."""
    return FlatSharding(mesh=mesh, waxis=worker_axis_name(mesh),
                        axes=flat_state_axes(cfg, mesh, hp),
                        pspecs=param_pspecs(cfg, mesh, hp.fsdp,
                                            hp.fsdp_axes))


def tree_sharding(cfg: ModelConfig, mesh, hp: TrainHParams
                  ) -> TreeSharding:
    """The pytree plane's ``sharding.TreeSharding`` for (cfg, mesh, hp):
    the reference's spec trees (its ``train_state_specs`` pytree branch).
    The moments may ZeRO over more axes than the parameters
    (``state_fsdp_axes``), and the gradient-shaped CADA state, which has
    no compute locality, over "data" under ``shard_cada_state`` whatever
    the parameters' FSDP. Where the moments' table would put one axis on
    two dims of a leaf (``state_fsdp_axes`` naming "model", the axis of
    its tensor-parallel dim), the FSDP dim leaves it
    (``sharding.one_dim_per_axis``): the reference's table is then a spec
    its ``NamedSharding`` rejects, and its mesh-free step, the one that
    runs there, ignores the knob."""
    psp = param_pspecs(cfg, mesh, hp.fsdp, hp.fsdp_axes)
    waxis = worker_axis_name(mesh)
    msp = (tree_map(one_dim_per_axis, param_pspecs(
        cfg, mesh, True, hp.state_fsdp_axes)) if hp.state_fsdp_axes
        else psp)
    gsp = (param_pspecs(cfg, mesh, True, (DATA,)) if hp.shard_cada_state
           else psp)
    return TreeSharding(mesh=mesh, waxis=waxis, psp=psp, msp=msp, gsp=gsp,
                        gwsp=_prepend_worker(gsp, waxis),
                        wsp=_prepend_worker(psp, waxis))


def state_sharding(cfg: ModelConfig, mesh, hp: TrainHParams):
    """The state's sharding on ``mesh``: :func:`flat_sharding` on the flat
    plane, :func:`tree_sharding` on the pytree plane (``fused=False``).
    :func:`shard_train_state` and :func:`unshard_train_state` take
    either."""
    return (flat_sharding(cfg, mesh, hp) if hp.fused
            else tree_sharding(cfg, mesh, hp))


def flat_state_shards(cfg: ModelConfig, mesh, hp: TrainHParams) -> int:
    """The flat plane's state-shard count on ``mesh``: pass it as
    ``shards=`` to :func:`init_train_state` for :func:`jit_train_step`."""
    return flat_sharding(cfg, mesh, hp).shards


def flat_layout(cfg: ModelConfig, shards: int = 1) -> F.FlatLayout:
    """The trainer's flat layout for ``cfg`` at a state-shard count."""
    return F.layout_of(abstract_params(cfg), shards=shards)


def _prepend_worker(specs, axis: str):
    """(M, ...)-leading per-worker tree: the worker axis leads; inner dims
    keep their param sharding minus the worker axis."""
    return tree_map(lambda sp: P(axis, *strip_axis(sp, axis)), specs)


def train_state_specs(cfg: ModelConfig, mesh, hp: TrainHParams
                      ) -> DistTrainState:
    """PartitionSpecs of the state (the reference's table). The flat
    plane: (n_flat,) server planes over the state axes, (M, n_flat) planes
    over the worker axis × the column axes, parameter-shaped entries by
    their param specs. The pytree plane: every leaf by its spec tree of
    :func:`tree_sharding`."""
    if not hp.fused:
        return _tree_state_specs(tree_sharding(cfg, mesh, hp), hp)
    psp = param_pspecs(cfg, mesh, hp.fsdp, hp.fsdp_axes)
    waxis = worker_axis_name(mesh)
    strategy = strategy_for(hp.rule)
    fs = flat_sharding(cfg, mesh, hp)
    return DistTrainState(
        step=P(), params=psp, h=fs.server_spec(), vhat=fs.server_spec(),
        comm=(None if strategy.stateless else
              F.flat_comm_state_specs(
                  strategy, psp, _prepend_worker(psp, waxis), waxis, P,
                  state_axes=fs.axes, col_axes=fs.col_axes)))


def _tree_state_specs(ts: TreeSharding, hp: TrainHParams) -> DistTrainState:
    """The pytree plane's state specs from its spec trees: the moments by
    ``msp``, the CommState by ``comm_state_specs`` (∇ by ``gsp``, the
    worker trees by ``gwsp``, cada2's stale iterates by ``wsp``, the (M,)
    vectors replicated)."""
    strategy = strategy_for(hp.rule)
    return DistTrainState(
        step=P(), params=ts.psp, h=ts.msp, vhat=ts.msp,
        comm=(None if strategy.stateless else
              comm_state_specs(strategy, ts.psp, ts.wsp, ts.gsp, ts.gwsp,
                               P(None))))


def train_batch_specs(mesh, local_steps: int = 1):
    """``spec_for(key, ndim)``: the worker-split batch's spec. Leaves are
    (M, b_m, ...); M shards over the worker axis, b_m over "data" on the
    multi-pod mesh (where the worker is a whole pod); M-RoPE positions are
    (M, 3, b_m, S). With ``local_steps`` H > 1 every leaf gains a leading
    replicated local-step axis."""
    waxis = worker_axis_name(mesh)
    inner = DATA if waxis == POD else None
    lead = (None,) if local_steps > 1 else ()

    def spec_for(key, ndim):
        ndim -= len(lead)
        if key == "positions":
            return P(*lead, waxis, None, inner, *(None,) * (ndim - 3))
        return P(*lead, waxis, inner, *(None,) * (ndim - 2))

    return spec_for


def worker_split_abstract(batch: dict, m: int, local_steps: int = 1
                          ) -> dict:
    """:func:`worker_split`'s shapes on the ``meta`` device."""
    lead = (local_steps,) if local_steps > 1 else ()
    hm = local_steps * m
    out = {}
    for key, leaf in batch.items():
        if key == "positions":
            three, b = leaf.shape[0], leaf.shape[1]
            shp = lead + (m, three, b // hm) + tuple(leaf.shape[2:])
        else:
            shp = lead + (m, leaf.shape[0] // hm) + tuple(leaf.shape[1:])
        out[key] = torch.empty(shp, dtype=leaf.dtype, device="meta")
    return out


def _worker_planes(strategy) -> tuple:
    """The comm state's (M, n_flat) entries: the stale rows and the
    strategy's per-worker planes."""
    return ("worker_grads",) + tuple(strategy.pooled_extras())


def _param_extras_specs(fs: FlatSharding, hp: TrainHParams) -> dict:
    """The specs of the comm state's parameter-shaped extras (cada1's
    snapshot, cada2's ring), by the parameter specs."""
    psp = fs.pspecs
    specs = strategy_for(hp.rule).flat_extras_specs(
        psp, _prepend_worker(psp, fs.waxis), fs.waxis, P,
        col_axes=fs.col_axes)
    return {k: v for k, v in specs.items() if isinstance(v, dict)}


def _walk(f, state, specs):
    """``f(tensor, spec)`` over every tensor of a state (NamedTuples and
    dicts) and its spec tree of the same structure; other leaves kept."""
    if isinstance(state, dict):
        return {k: _walk(f, v, specs[k]) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_walk(f, v, sp)
                             for v, sp in zip(state, specs)))
    return f(state, specs) if torch.is_tensor(state) else state


def shard_train_state(state: DistTrainState, fs, hp: TrainHParams
                      ) -> DistTrainState:
    """A whole state (every rank holds the same one) -> this rank's.

    The flat plane (``fs`` a ``FlatSharding``; the state made by
    :func:`init_train_state` at ``shards=fs.shards``): its server slice of
    h, v̂ and ∇, its worker row of the (M, n_flat) planes cut to its
    columns, its blocks of the parameters and of their copies (the ring,
    the snapshot) by ``fs.pspecs``; (M,) vectors stay whole. The pytree
    plane (``fs`` a ``TreeSharding``): its block of every leaf by
    :func:`train_state_specs`, of a worker tree its worker's row."""
    if isinstance(fs, TreeSharding):
        return _walk(lambda x, sp: cut(x, sp, fs.mesh), state,
                     _tree_state_specs(fs, hp))
    layout = F.layout_of(state.params, shards=fs.shards)
    mine = {"h": fs.cut_server(state.h, layout),
           "vhat": fs.cut_server(state.vhat, layout)}
    mine["params"] = cut_tree(state.params, fs.pspecs, fs.mesh)
    if state.comm is not None:
        planes = _worker_planes(strategy_for(hp.rule))
        trees = _param_extras_specs(fs, hp)
        extras = {k: fs.cut_rows(v, layout) if k in planes
                  else cut_tree(v, trees[k], fs.mesh) if k in trees else v
                  for k, v in state.comm.extras.items()}
        mine["comm"] = state.comm._replace(
            nabla=fs.cut_server(state.comm.nabla, layout),
            worker_grads=fs.cut_rows(state.comm.worker_grads, layout),
            extras=extras)
    return state._replace(**mine)


def unshard_train_state(state: DistTrainState, fs, hp: TrainHParams
                        ) -> DistTrainState:
    """This rank's state -> the whole one, on every rank (the gathers of
    :func:`shard_train_state`'s cuts)."""
    if isinstance(fs, TreeSharding):
        return _walk(lambda x, sp: uncut(x, sp, fs.mesh), state,
                     _tree_state_specs(fs, hp))
    whole = {"h": fs.gather_server(state.h),
             "vhat": fs.gather_server(state.vhat)}
    whole["params"] = uncut_tree(state.params, fs.pspecs, fs.mesh)
    if state.comm is not None:
        planes = _worker_planes(strategy_for(hp.rule))
        trees = _param_extras_specs(fs, hp)
        extras = {k: fs.gather_rows(v) if k in planes
                  else uncut_tree(v, trees[k], fs.mesh) if k in trees else v
                  for k, v in state.comm.extras.items()}
        whole["comm"] = state.comm._replace(
            nabla=fs.gather_server(state.comm.nabla),
            worker_grads=fs.gather_rows(state.comm.worker_grads),
            extras=extras)
    return state._replace(**whole)


def train_context(cfg: ModelConfig, fs, worker: bool = False):
    """The ``sharding.TPContext`` a rank's forward and backward run under
    (the model axis, the FSDP leaves of ``fs.pspecs``), or None where the
    parameters are whole on every rank. ``worker``: the context of an
    evaluation at a point that is the rank's worker's own (cada2's stale
    iterate, a delta rule's local parameters), cut by
    ``fs.worker_pspecs``: its FSDP gathers leave out the worker axis,
    whose other ranks hold other workers' points."""
    tp = TPContext(cfg, fs.mesh,
                   pspecs=fs.worker_pspecs if worker else fs.pspecs)
    return tp if tp.size > 1 or tp.fsdp else None


def _mesh_vgrads(cfg: ModelConfig, hp: TrainHParams, fs,
                 layout: F.FlatLayout, tp=None, tp_worker=None):
    """The rank's worker's gradients, as whole leaves: ``vgrad`` at θ
    under ``tp``, ``vgrad_per`` at the worker's own point under
    ``tp_worker`` (``train_context(..., worker=True)``). Each is computed
    on the rank's shards (an FSDP leaf's whole on its FSDP dim already)
    and gathered over the model axis. On the multi-pod mesh the worker is
    a pod: each of its "data" ranks takes its slice of the pod's batch,
    and the pod's gradient and loss are their mean (one all-reduce of the
    packed fp32 gradient over "data")."""
    vgrad = make_vgrads(cfg, hp, tp)[0]
    vgrad_per = make_vgrads(cfg, hp, tp_worker)[1]
    msp = model_specs(fs.pspecs)

    def whole(f):
        def call(p, b):
            losses, grads = f(p, b)
            return losses, uncut_tree(grads, msp, fs.mesh, lead=1)
        return call

    vgrad, vgrad_per = whole(vgrad), whole(vgrad_per)
    d = fs.mesh.size((DATA,)) if fs.waxis == POD else 1
    if d == 1:
        return vgrad, vgrad_per
    f32 = [torch.float32] * len(layout.sizes)

    def pod_mean(out):
        losses, grads = out
        plane = fs.all_reduce(layout.pack_worker(grads), (DATA,)) / d
        return (fs.all_reduce(losses.float(), (DATA,)) / d,
                layout.unpack_worker(plane, f32))

    return (lambda p, b: pod_mean(vgrad(p, b)),
            lambda p, b: pod_mean(vgrad_per(p, b)))


def _local_batch(batch: dict, fs: FlatSharding, lead: int) -> dict:
    """The rank's part of a worker-split batch: its worker's row (kept as
    a one-row axis) and, on the multi-pod mesh, its "data" slice of the
    pod's b_m samples (``train_batch_specs``)."""
    w = fs.mesh.coord(fs.waxis)
    d = fs.mesh.size((DATA,)) if fs.waxis == POD else 1
    out = {}
    for key, leaf in batch.items():
        x = leaf.narrow(lead, w, 1)
        if d > 1:
            bdim = lead + (2 if key == "positions" else 1)
            b = x.shape[bdim]
            if b % d:
                raise ValueError(f"{key}: b_m = {b} does not divide into "
                                 f"the pod's {d} data ranks")
            x = x.narrow(bdim, fs.mesh.coord(DATA) * (b // d), b // d)
        out[key] = x
    return out


def _owning(params: dict, plane: torch.Tensor) -> dict:
    """``params`` with every leaf that is still a view of the whole θ
    ``plane`` (a leaf no axis cuts) copied, so that the plane is freed
    with the step instead of living on in the state: unless every leaf is
    such a view, when the plane is the parameters themselves."""
    leaves = tree_leaves(params)
    ptr = plane.untyped_storage().data_ptr()
    views = [x.untyped_storage().data_ptr() == ptr for x in leaves]
    if all(views):
        return params
    return tree_unflatten(tree_paths(params), [
        x.clone() if v else x for x, v in zip(leaves, views)])


def jit_train_step(cfg: ModelConfig, mesh, hp: TrainHParams, *, impl=None):
    """The mesh runtime's step builder: the counterpart of the reference's
    ``jit_train_step``, whose name it keeps so that a reader finds it
    (nothing is traced or compiled here). Returns ``(make, specs, m)``:
    ``make(batch)`` gives ``step(state, batch) -> (state, metrics)`` for
    batches shaped like ``batch``, ``specs`` are
    :func:`train_state_specs`, and ``m`` is the worker axis's size.

    Every rank of ``mesh`` (a ``launch.mesh.Mesh`` over the process group)
    calls this and then ``step`` in lockstep. ``state`` is the rank's:
    :func:`shard_train_state` of :func:`init_train_state` (at
    ``shards=flat_state_shards(cfg, mesh, hp)``) by
    ``state_sharding(cfg, mesh, hp)``, its parameters cut by
    ``param_pspecs(cfg, mesh, hp.fsdp, hp.fsdp_axes)`` (the model axis,
    and the FSDP axes where FSDP is on). ``batch`` is the whole
    worker-split batch (:func:`worker_split`, the same on every rank); the
    step reads its rank's part. Metrics are whole (M,) vectors on every
    rank. ``impl`` is the dispatch override of ``kernels/ops.py`` (the
    pytree plane's step launches no kernel, as the reference's)."""
    fs = state_sharding(cfg, mesh, hp)
    fs.groups()
    tp = train_context(cfg, fs)
    tp_worker = train_context(cfg, fs, worker=True)
    m = mesh.shape[fs.waxis]
    specs = train_state_specs(cfg, mesh, hp)
    layout = flat_layout(cfg, flat_state_shards(cfg, mesh, hp))
    strategy = strategy_for(hp.rule)
    lead = int(strategy.delta_payload
               and F.batch_has_local_axis(hp.rule, None))
    vgrad, vgrad_per = _mesh_vgrads(cfg, hp, fs, layout, tp, tp_worker)
    if not hp.fused:
        step = _pytree_mesh_step(strategy, hp, fs, m, lead, vgrad,
                                 vgrad_per)
        return _maker(step, fs, m, lead), specs, m
    if strategy.delta_payload:
        # the local steps run at whole per-worker parameters (unpacked
        # from the flat plane): the rank takes its blocks of its worker's
        shard_per = vgrad_per
        vgrad_per = lambda wp, b: shard_per(       # noqa: E731
            cut_tree(wp, fs.worker_pspecs, mesh, lead=1), b)

    def packed(params):
        """θ as the whole (n_flat,) fp32 plane, from the rank's shards."""
        return layout.pack(uncut_tree(params, fs.pspecs, mesh))

    def server_step(pserver, h, vhat, grad):
        """The AMSGrad kernel on the rank's server slice of θ, Σupd²
        summed over the state axes, then θ' gathered whole, rounded
        through each leaf's dtype and cut to the rank's shards."""
        theta, h2, vh2, dsq = kops.fused_amsgrad_flat(
            pserver, h, vhat, grad, hp.lr, b1=hp.b1,
            b2=hp.b2, eps=hp.eps, impl=impl, shard=fs)
        plane = layout.cast_roundtrip(fs.gather_server(theta))
        params = cut_tree(layout.unpack(plane), fs.pspecs, mesh)
        return _owning(params, plane), h2, vh2, dsq

    def step_always(state: DistTrainState, batch):
        wb = _local_batch(batch, fs, lead)
        losses, fresh = vgrad(state.params, wb)
        grad = fs.cols_to_server(kops.eq3_row_mean(
            fs.cut_cols(layout.pack_worker(fresh), layout), m, shard=fs),
            layout)
        params, h, vhat, dsq = server_step(
            fs.cut_server(packed(state.params), layout), state.h,
            state.vhat, grad)
        return state._replace(step=state.step + 1, params=params, h=h,
                              vhat=vhat), _always_metrics(
            fs.rows_sum(losses, (fs.waxis,)), m, dsq)

    def step_flat(state: DistTrainState, batch):
        k = state.step
        pflat = packed(state.params)
        pserver = fs.cut_server(pflat, layout)
        if not strategy.delta_payload:
            # only a delta rule's local steps read θ's whole flat plane:
            # the others keep the server slice alone through the round
            pflat = None
        out = F.flat_comm_round(
            strategy, layout, state.comm, state.params, pflat,
            _local_batch(batch, fs, lead), k, vgrad=vgrad,
            vgrad_per=vgrad_per, fuse_evals=False,
            group_evals=hp.group_evals, impl=impl, shard=fs)
        params, h, vhat, dsq = server_step(pserver, state.h, state.vhat,
                                           F.nabla_f32(out.comm))
        new_state = DistTrainState(step=k + 1, params=params, h=h,
                                   vhat=vhat,
                                   comm=F.record_progress(out.comm, dsq, k))
        return new_state, {"loss": out.losses.mean(), "dtheta_sq": dsq,
                           **out.metrics}

    step = step_always if strategy.stateless else step_flat
    return _maker(step, fs, m, lead), specs, m


def _maker(step, fs, m: int, lead: int):
    """``make(batch)``: the step, for batches shaped like ``batch``
    (checked against the mesh: M rows, and b_m that the pod's data ranks
    divide)."""
    def make(batch: dict):
        for key, leaf in batch.items():
            if leaf.shape[lead] != m:
                raise ValueError(f"{key}: {leaf.shape[lead]} worker rows "
                                 f"for a worker axis of {m}")
        _local_batch(batch, fs, lead)
        return step

    return make


def _pytree_mesh_step(strategy, hp: TrainHParams, ts: TreeSharding, m: int,
                      lead: int, vgrad, vgrad_per):
    """The pytree plane's step on the rank's blocks (``_make_pytree_step``
    on the mesh). ``vgrad``/``vgrad_per`` are :func:`_mesh_vgrads`' (the
    rank's worker's whole gradients at the rank's parameter shards, or at
    its blocks of its worker's own point); the round sees them cut to the
    ``gwsp`` blocks, at the rank's shards of θ or of the snapshot, or at
    its worker's stale iterate, whose ``wsp`` blocks are the worker
    point's. A delta rule's local steps run at whole per-worker
    parameters, cut to the rank's blocks for each evaluation."""
    mesh = ts.mesh

    def blocks(f):
        def call(p, b):
            losses, grads = f(p, b)
            return losses, ts.cut_worker(grads)
        return call

    fresh_fn = blocks(vgrad)
    if strategy.delta_payload:
        def per_fn(wp, b):
            return vgrad_per(cut_tree(wp, ts.worker_pspecs, mesh, lead=1), b)
    else:
        per_fn = blocks(vgrad_per)
    msp_leaves = tree_leaves(ts.msp)

    def server_step(params, h, vhat, grad):
        """``_amsgrad_apply`` on the rank's blocks under the moments'
        specs (θ and the gradient moved there), Σupd² completed over
        their axes, θ' moved back to the parameters' blocks."""
        new, h2, vh2, dsq = _amsgrad_apply(
            ts.move_tree(params, ts.psp, ts.msp), h, vhat,
            ts.move_tree(grad, ts.gsp, ts.msp), hp,
            complete=lambda sums: ts.complete(sums, msp_leaves))
        return ts.move_tree(new, ts.msp, ts.psp), h2, vh2, dsq

    def step_always(state: DistTrainState, batch):
        losses, fresh = fresh_fn(state.params, _local_batch(batch, ts, lead))
        grad = ts.worker_to_grad(tree_map(lambda g: torch.mean(g, dim=0),
                                          ts.worker_rows(fresh)))
        params, h, vhat, dsq = server_step(state.params, state.h,
                                           state.vhat, grad)
        return state._replace(step=state.step + 1, params=params, h=h,
                              vhat=vhat), _always_metrics(
            ts.rows_sum(losses), m, dsq)

    def step(state: DistTrainState, batch):
        k = state.step
        out = comm_round(strategy, state.comm, state.params,
                         _local_batch(batch, ts, lead), k, vgrad=fresh_fn,
                         vgrad_per=per_fn, shard=ts)
        params, h, vhat, dsq = server_step(state.params, state.h,
                                           state.vhat, nabla_f32(out.comm))
        new_state = DistTrainState(step=k + 1, params=params, h=h,
                                   vhat=vhat,
                                   comm=record_progress(out.comm, dsq, k))
        return new_state, {"loss": out.losses.mean(), "dtheta_sq": dsq,
                           **out.metrics}

    return step_always if strategy.stateless else step
