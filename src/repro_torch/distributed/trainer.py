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

The forward takes the model's training route (``lm_loss(train=True)``):
the reference's jnp attention and chunked scan, here in PyTorch under
autograd. The kernels on the step's path are the server step and the rule
LHS norms (``kernels/ops.py``): on a CUDA tensor they launch or raise.

Not here, and refused by name where a field asks for them: the mesh, FSDP
and ZeRO-sharded state (``fsdp``, ``fsdp_axes``, ``state_fsdp_axes``,
``shard_cada_state``), the grouped second evaluation (``group_evals``),
the per-leaf debug plane (``fused=False``), the cohort step and the pod
shard_map.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

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


def worker_split(batch: dict, m: int) -> dict:
    """Global batch -> (M, b_m, ...) per-worker leading axis (positions:
    (3, B, S) -> (M, 3, b_m, S)). Leaves may be tensors or numpy arrays."""
    out = {}
    for key, leaf in batch.items():
        if key == "positions":
            three, b = leaf.shape[0], leaf.shape[1]
            out[key] = leaf.reshape((three, m, b // m)
                                    + tuple(leaf.shape[2:])).swapaxes(0, 1)
        else:
            b = leaf.shape[0]
            out[key] = leaf.reshape((m, b // m) + tuple(leaf.shape[1:]))
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


def make_vgrads(cfg: ModelConfig, hp: TrainHParams, m: int):
    """``(vgrad, vgrad_per)``: the M workers' (losses (M,), M-stacked
    gradient trees), each worker on its own slice of the batch, at one
    shared parameter tree (``vgrad``) or at its own row of an M-leading one
    (``vgrad_per``). A loop over the workers, one at a time."""
    worker_grad = make_worker_grad(cfg, hp)

    def run(point, batch):
        losses, grads = [], []
        for i in range(m):
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
    on the LM. ``batch`` leaves carry an (M,)-leading worker axis
    (:func:`worker_split`). ``impl`` is the dispatch override of
    ``kernels/ops.py`` (None on the main path). The state is not updated in
    place."""
    strategy = strategy_for(hp.rule)
    vgrad, vgrad_per = make_vgrads(cfg, hp, m)

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
