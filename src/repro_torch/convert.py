"""Carry weights, engine and trainer state across from numpy.

The JAX package's parameters, ``EngineState`` and trainer
``DistTrainState`` (on the flat plane or the per-leaf pytree plane),
cohort-plane states (``CohortEngineState``, ``CohortTrainState``) and LM
``DecodeCache`` convert to numpy with ``jax.tree.map(np.asarray, ...)``;
these functions turn that numpy form into the port's tensors on
``device`` (None means ``cuda``, as everywhere in the port), and a JAX
``WorkerPool``'s host planes into the port's pool. They read fields by name and import
nothing of the JAX package. An LM's parameters (nested dicts, bf16 leaves
included) and the CNN's (HWIO kernels, as the reference keeps them) go
through :func:`params_from_numpy` leaf for leaf. To move a state through
a file instead, :mod:`repro_torch.checkpoint` reads and writes the
reference's checkpoint format.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.comm import CommState
from repro_torch.core.engine import CohortEngineState, EngineState
from repro_torch.core.flat import CohortServerState, FlatCommState, WorkerPool
from repro_torch.device import resolve_device
from repro_torch.distributed.trainer import CohortTrainState, DistTrainState
from repro_torch.models.model import DecodeCache
from repro_torch.optim.adam import AdamState
from repro_torch.optim.fused import FusedState
from repro_torch.optim.sgd import MomentumState


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (bf16 arrays included) as a tensor on ``device``."""
    return _host_tensor(np.asarray(a)).to(resolve_device(device))


def params_from_numpy(tree, device=None):
    """A (nested) dict of numpy arrays as a dict of tensors."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def opt_state_from_numpy(opt, device=None):
    """A server-optimizer state of the JAX package (numpy leaves) as the
    port's, read by field names: ``FusedState`` (count, h, vhat),
    ``AdamState`` (count, h, v, vhat; FedAdam's non-AMSGrad server too),
    ``MomentumState`` (count, momentum), or SGD's bare step count (local
    momentum's sgd(1.0) server)."""
    device = resolve_device(device)
    fields = getattr(opt, "_fields", None)
    if fields is None:
        return int(opt)
    tree = {f: getattr(opt, f) for f in fields if f != "count"}
    kind = {("count", "h", "vhat"): FusedState,
            ("count", "h", "v", "vhat"): AdamState,
            ("count", "momentum"): MomentumState}.get(tuple(fields))
    if kind is None:
        raise ValueError(f"unknown optimizer state with fields {fields}")
    return kind(count=int(opt.count), **params_from_numpy(tree, device))


def comm_state_from_numpy(comm, device=None):
    """The JAX package's communication state (numpy leaves) as the port's,
    with every rule's extras: a flat ``FlatCommState`` (CADA1's snapshot
    and δ̃ plane, CADA2's ring, slots and versions, laq/topk's residual,
    avp's periods, local momentum's momenta plane) or, where ∇ is a dict,
    the pytree plane's ``CommState`` (the same extras as dicts of
    (M,)-leading leaves; CADA2's dense stale iterates)."""
    device = resolve_device(device)
    kind = CommState if isinstance(comm.nabla, dict) else FlatCommState
    return kind(
        nabla=params_from_numpy(comm.nabla, device),
        worker_grads=params_from_numpy(comm.worker_grads, device),
        staleness=tensor_from_numpy(comm.staleness, device),
        diff_hist=tensor_from_numpy(comm.diff_hist, device),
        extras=params_from_numpy(dict(comm.extras), device))


def engine_state_from_numpy(state, device=None) -> EngineState:
    """The JAX engine's ``EngineState`` (numpy leaves) of either plane as
    the port's :class:`EngineState`: the server optimizer's state and the
    communication state (:func:`comm_state_from_numpy`); ``params_flat``
    is None on the pytree plane."""
    device = resolve_device(device)
    return EngineState(
        step=int(state.step),
        params=params_from_numpy(state.params, device),
        opt_state=opt_state_from_numpy(state.opt_state, device),
        comm=comm_state_from_numpy(state.comm, device),
        params_flat=(None if state.params_flat is None else
                     tensor_from_numpy(state.params_flat, device)),
    )


def train_state_from_numpy(state, device=None) -> DistTrainState:
    """The JAX trainer's ``DistTrainState`` (numpy leaves) of either plane
    as the port's: the step as a Python int, the parameters, the moments
    ((n_flat,) buffers, or dicts on the pytree plane), and the
    communication state (None for a stateless rule)."""
    device = resolve_device(device)
    return DistTrainState(
        step=int(state.step),
        params=params_from_numpy(state.params, device),
        h=params_from_numpy(state.h, device),
        vhat=params_from_numpy(state.vhat, device),
        comm=(None if state.comm is None
              else comm_state_from_numpy(state.comm, device)))


def cohort_state_from_numpy(state, device=None):
    """The JAX package's cohort-plane state (numpy leaves) as the port's:
    an engine ``CohortEngineState`` (step, params, opt_state, server,
    params_flat) or a trainer ``CohortTrainState`` (step, params, h, vhat,
    server, params_flat), told apart by their fields. The server state
    carries ∇, the (M,) staleness, the RHS ring and the non-pooled extras;
    the pooled planes go through :func:`pool_from_numpy`."""
    device = resolve_device(device)
    srv = state.server
    server = CohortServerState(
        nabla=tensor_from_numpy(srv.nabla, device),
        staleness=tensor_from_numpy(srv.staleness, device),
        diff_hist=tensor_from_numpy(srv.diff_hist, device),
        extras=params_from_numpy(dict(srv.extras), device))
    common = dict(step=int(state.step),
                  params=params_from_numpy(state.params, device),
                  server=server,
                  params_flat=tensor_from_numpy(state.params_flat, device))
    if hasattr(state, "opt_state"):
        return CohortEngineState(
            opt_state=opt_state_from_numpy(state.opt_state, device),
            **common)
    return CohortTrainState(h=tensor_from_numpy(state.h, device),
                            vhat=tensor_from_numpy(state.vhat, device),
                            **common)


def pool_from_numpy(pool, storage: str = "ram", path: str | None = None,
                    device=None) -> WorkerPool:
    """A JAX ``WorkerPool`` (or a dict of (M, n_flat) numpy planes) as the
    port's :class:`WorkerPool`: the same planes in its ``plane_order`` and
    storage dtype (bf16 by its bits), RAM or memmap as ``storage`` says,
    staging for ``device``."""
    planes = pool.planes if hasattr(pool, "planes") else pool
    order = getattr(pool, "plane_order", tuple(planes))
    return WorkerPool({name: _host_tensor(planes[name]) for name in order},
                      storage=storage, path=path, device=device)


def _host_tensor(a) -> torch.Tensor:
    """One numpy array as a host tensor that owns a copy of it (bf16 by
    its uint16 bits)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def decode_cache_from_numpy(cache, device=None) -> DecodeCache:
    """The JAX package's LM ``DecodeCache`` (numpy leaves) as the port's:
    ``index`` as a Python int, ``slot_pos`` and the K/V, conv and SSM
    caches (None where the model has none) as tensors."""
    device = resolve_device(device)

    def opt(a):
        return None if a is None else tensor_from_numpy(a, device)

    return DecodeCache(index=int(cache.index),
                       slot_pos=tensor_from_numpy(cache.slot_pos, device),
                       k=opt(cache.k), v=opt(cache.v), conv=opt(cache.conv),
                       ssm=opt(cache.ssm))
