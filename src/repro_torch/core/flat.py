"""Flat-buffer state plane: Algorithm 1's per-iteration math on contiguous
buffers instead of per-leaf dicts (the dense part of the JAX package's
``core/flat.py``).

  * :class:`FlatLayout` — the static flat layout of a parameter dict
    (per-leaf offsets/sizes/shapes/dtypes, padded length ``n_flat``) with
    exact ``pack``/``unpack``. Leaves are ordered by SORTED key, the order
    ``jax.tree.flatten`` gives a dict, so a port plane and a JAX plane line
    up element for element;
  * :class:`FlatCommState` — the Algorithm-1 communication state with ∇ as
    one (n_flat,) buffer and every per-worker quantity as one (M, n_flat)
    plane;
  * the flat wire compressors: the b-bit quantizer with one scale per
    (worker, leaf segment), exact top-k per segment, and the (values,
    indices) sparse wire with its server-side scatter;
  * :func:`flat_comm_round` — one round of Algorithm 1 (lines 4-15) as
    whole-plane ops, the rule LHS norms through the batched kernels and
    eq. (3)'s aggregate through its order-fixed row-mean kernel; for the
    delta-payload rules (``local_momentum``, ``fedadam``) the round's
    payload is the model delta of H local steps (the local-steps cadence:
    :func:`batch_has_local_axis`, :func:`local_steps_vector`).

Rule-specific behaviour lives in the strategy objects of
:mod:`repro_torch.core.comm`. State is never updated in place: every round
returns new tensors, so a state may be kept and stepped again.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantize import (keep_where, round_trip, topk_count,
                                       topk_indices, topk_threshold_mask)
from repro_torch.kernels import ops as kops
from repro_torch.utils.trees import (tree_leaves, tree_map, tree_paths,
                                     tree_unflatten)

# Minimal flat-buffer alignment (the reference's PAD_ALIGN): every row of an
# (M, n_flat) plane starts 32-byte aligned in fp32.
PAD_ALIGN = 8


# ------------------------------------------------------------------- layout

@dataclass(frozen=True)
class FlatLayout:
    """Static flat layout of a parameter dict: one contiguous padded buffer.

    ``n`` is the true scalar count, ``n_flat`` the padded buffer length (a
    multiple of ``PAD_ALIGN``); padding lanes stay zero through every op.
    """
    paths: tuple
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    offsets: tuple
    n: int
    n_flat: int

    def pack(self, tree, dtype=torch.float32) -> torch.Tensor:
        """Dict -> (n_flat,) buffer in ``dtype`` (zero-padded tail)."""
        flat = torch.cat([l.reshape(-1).to(dtype) for l in tree_leaves(tree)])
        return F.pad(flat, (0, self.n_flat - self.n))

    def pack_worker(self, tree, dtype=torch.float32) -> torch.Tensor:
        """M-leading dict -> (M, n_flat) plane in ``dtype``."""
        leaves = tree_leaves(tree)
        m = leaves[0].shape[0]
        flat = torch.cat([l.reshape(m, -1).to(dtype) for l in leaves], dim=1)
        return F.pad(flat, (0, self.n_flat - self.n))

    def unpack_worker(self, buf, dtypes=None) -> dict:
        """(M, n_flat) plane -> M-leading dict (leaves cast to the layout
        dtypes)."""
        dtypes = dtypes or self.dtypes
        m = buf.shape[0]
        outs = [buf[:, o:o + s].reshape((m,) + shp).to(dt)
                for o, s, shp, dt in zip(self.offsets, self.sizes,
                                         self.shapes, dtypes)]
        return tree_unflatten(self.paths, outs)

    def unpack(self, buf, dtypes=None) -> dict:
        """(n_flat,) buffer -> dict (leaves cast to the layout dtypes)."""
        dtypes = dtypes or self.dtypes
        outs = [buf[o:o + s].reshape(shp).to(dt)
                for o, s, shp, dt in zip(self.offsets, self.sizes,
                                         self.shapes, dtypes)]
        return tree_unflatten(self.paths, outs)

    @property
    def all_f32(self) -> bool:
        return all(dt == torch.float32 for dt in self.dtypes)

    def cast_roundtrip(self, buf: torch.Tensor) -> torch.Tensor:
        """Round-trip a (n_flat,) fp32 buffer through the per-leaf storage
        dtypes, so ``buf == pack(unpack(buf))`` holds exactly even for
        reduced-precision leaves. No-op for all-fp32 layouts."""
        if self.all_f32:
            return buf
        parts = [buf[o:o + s].to(dt).to(buf.dtype)
                 for o, s, dt in zip(self.offsets, self.sizes, self.dtypes)]
        parts.append(buf[self.n:])
        return torch.cat(parts)


def layout_of(tree, align: int = PAD_ALIGN) -> FlatLayout:
    """The :class:`FlatLayout` of a dict of tensors (only shapes and dtypes
    are read)."""
    leaves = tree_leaves(tree)
    shapes = tuple(tuple(l.shape) for l in leaves)
    sizes = tuple(int(l.numel()) for l in leaves)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    n_flat = off + ((-off) % align)
    return FlatLayout(paths=tuple(tree_paths(tree)), shapes=shapes,
                      dtypes=tuple(l.dtype for l in leaves), sizes=sizes,
                      offsets=tuple(offsets), n=off,
                      n_flat=max(n_flat, align))


# --------------------------------------------------------- wire compressors

def _segment_ids(layout: FlatLayout) -> np.ndarray:
    """(n_flat,) int64 leaf-segment id per buffer position; the padding
    tail is its own trailing segment ``len(sizes)``."""
    ids = np.full((layout.n_flat,), len(layout.sizes), np.int64)
    for i, (o, s) in enumerate(zip(layout.offsets, layout.sizes)):
        ids[o:o + s] = i
    return ids


@functools.lru_cache(maxsize=16)
def _segment_ids_on(layout: FlatLayout, device: torch.device) -> torch.Tensor:
    """:func:`_segment_ids` as a tensor on ``device``, built once per
    (layout, device) so a round copies nothing to the card."""
    return torch.from_numpy(_segment_ids(layout)).to(device)


def per_worker_quantize_dequantize_flat(layout: FlatLayout, buf, bits: int):
    """Flat-plane twin of ``quantize.per_worker_quantize_dequantize``: b-bit
    symmetric uniform round trip with one max-abs scale per (worker, leaf
    segment), bit-identical to the dict form (a max is exact). One row-max
    per segment (a scatter-max onto the (M, segments) scales would contend
    on a few dozen outputs) and one gather spreads the scales back; the
    padding tail passes through untouched."""
    if bits <= 0 or bits >= 32:
        return buf
    levels = float(2 ** (bits - 1) - 1)
    n_seg = len(layout.sizes)
    seg = _segment_ids_on(layout, buf.device)
    mag = buf.float().abs()
    ones = torch.ones((buf.shape[0],), dtype=torch.float32, device=buf.device)
    # the padding tail's column is never used: its entries pass through
    seg_max = torch.stack(
        [mag[:, o:o + s].amax(dim=1) if s else ones
         for o, s in zip(layout.offsets, layout.sizes)] + [ones], dim=1)
    scale = torch.clamp_min(seg_max, 1e-12)[:, seg]       # (M, n_flat)
    deq = round_trip(buf, scale, levels)
    if layout.n_flat > layout.n:
        deq = torch.where(seg < n_seg, deq, buf)
    return deq


def per_worker_topk_sparsify_flat(layout: FlatLayout, buf, frac: float):
    """Flat-plane twin of ``quantize.per_worker_topk_sparsify``: keep
    EXACTLY the top-⌈frac·size⌉ largest-|x| entries per (worker, leaf
    segment), ties to the lower index, zero the rest: the same selection
    over the same entries in the same order as the dict form. The padding
    tail passes through untouched."""
    if frac >= 1.0:
        return buf
    parts = []
    for o, s in zip(layout.offsets, layout.sizes):
        seg = buf[:, o:o + s]
        parts.append(keep_where(topk_threshold_mask(seg.float(),
                                                    topk_count(s, frac)),
                                seg))
    if layout.n_flat > layout.n:
        parts.append(buf[:, layout.n:])
    return torch.cat(parts, dim=1)


def per_worker_topk_extract_flat(layout: FlatLayout, plane, frac: float):
    """The top-k SPARSE WIRE of an (M, n_flat) sparsified plane: ((M, K)
    fp32 values, (M, K) int64 global flat positions) with
    K = Σ_seg ⌈frac·size_seg⌉. It selects exactly the support the exact-k
    mask kept, so :func:`sparse_rows_to_dense` rebuilds the plane bit for
    bit. (The reference's positions are int32; a torch scatter takes
    int64.)"""
    vparts, iparts = [], []
    for o, s in zip(layout.offsets, layout.sizes):
        seg = plane[:, o:o + s].float()
        idx = topk_indices(seg, topk_count(s, frac))
        vparts.append(torch.gather(seg, 1, idx))
        iparts.append(idx + o)
    return torch.cat(vparts, dim=1), torch.cat(iparts, dim=1)


def sparse_rows_to_dense(idx, vals, n_flat: int) -> torch.Tensor:
    """Scatter per-worker (values, indices) wire pairs back onto a dense
    (M, n_flat) plane (the server side of the sparse collective). Indices
    are distinct per row, so the add (the reference's ``.at[].add``, which
    turns a −0.0 value into +0.0) sets each entry once."""
    return torch.zeros((vals.shape[0], n_flat), dtype=vals.dtype,
                       device=vals.device).scatter_add_(1, idx, vals)


# ----------------------------------------------------- local-steps cadence

def batch_map(f, batch):
    """``f`` on every tensor of a batch: an (x, y) tuple, a dict or one
    tensor."""
    if isinstance(batch, dict):
        return {k: batch_map(f, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(batch_map(f, v) for v in batch)
    return f(batch)


def batch_lead(batch) -> int:
    """The length of a batch's leading axis."""
    if isinstance(batch, dict):
        return batch_lead(next(iter(batch.values())))
    if isinstance(batch, (tuple, list)):
        return batch_lead(batch[0])
    return batch.shape[0]


def batch_has_local_axis(rule, local_steps) -> bool:
    """Whether a delta-payload round's batch leads with the H axis: when
    the rule runs more than one local step (``rule.local_steps > 1``) or a
    per-round schedule is passed (``local_steps is not None``). With H = 1
    and no schedule the batch keeps the plain (M, b, ...) form of the
    gradient rules."""
    return rule.local_steps > 1 or local_steps is not None


def local_steps_vector(m: int, batch_h, local_steps,
                       device=None) -> torch.Tensor:
    """(M,) int32 per-worker local-step counts of one delta-payload round.
    ``batch_h`` leads with the local-steps axis H, the padding bound;
    ``local_steps`` (None, a scalar or (M,)) is how many of those H steps
    each worker runs, clipped into [1, H] so a stale schedule never
    indexes past the batch; None runs all H."""
    h_max = batch_lead(batch_h)
    if local_steps is None:
        return torch.full((m,), h_max, dtype=torch.int32, device=device)
    h = torch.as_tensor(local_steps, dtype=torch.int32, device=device)
    return torch.clamp(h.expand((m,)), 1, h_max).to(torch.int32)


# -------------------------------------------------------------- comm state

class FlatCommState(NamedTuple):
    """Algorithm-1 communication state on the flat plane."""
    nabla: torch.Tensor         # (n_flat,) storage dtype
    worker_grads: torch.Tensor  # (M, n_flat) storage dtype
    staleness: torch.Tensor     # (M,) int32
    diff_hist: torch.Tensor     # (d_max,) fp32 RHS ring buffer
    extras: dict                # strategy-owned flat slices


class FlatCommContext(NamedTuple):
    """What a strategy's flat hooks may consult. ``fresh`` is the packed
    (M, n_flat) fp32 fresh-gradient plane; ``second`` the packed gradients
    at the strategy's second evaluation points (None if it has none)."""
    layout: FlatLayout
    params: Any               # θ^k dict
    fresh: torch.Tensor
    second: torch.Tensor | None
    comm: FlatCommState
    step: int
    m: int
    impl: Any = None          # dispatch override of kernels/ops.py
    participation: Any = None  # (M,) bool round-participation mask | None


class FlatCommRoundResult(NamedTuple):
    losses: torch.Tensor
    comm: FlatCommState       # diff_hist NOT yet updated (record_progress)
    upload: torch.Tensor
    metrics: dict


def init_flat_comm_state(strategy, layout: FlatLayout, params, m: int,
                         grad_dtype=torch.float32,
                         params_flat=None) -> FlatCommState:
    """Fresh flat CommState: τ_m starts at D so iteration 0 uploads."""
    r = strategy.rule
    if params_flat is None:
        params_flat = layout.pack(params)
    dev = params_flat.device
    return FlatCommState(
        nabla=torch.zeros((layout.n_flat,), dtype=grad_dtype, device=dev),
        worker_grads=torch.zeros((m, layout.n_flat), dtype=grad_dtype,
                                 device=dev),
        staleness=torch.full((m,), r.max_delay, dtype=torch.int32,
                             device=dev),
        diff_hist=torch.zeros((r.d_max,), dtype=torch.float32, device=dev),
        extras=strategy.init_flat_extras(layout, params, params_flat, m,
                                         grad_dtype),
    )


# ------------------------------------------------------------ two-point eval

def stacked_two_point_eval(layout: FlatLayout, params, pts, batch, m: int,
                           vgrad_per):
    """Fresh and second gradients from ONE vmapped call: the 2-way eval axis
    is an outer vmap level over which the batch is broadcast, not copied.
    Returns (losses, fresh, second) with the planes packed."""
    stacked = tree_map(
        lambda p, w: torch.stack([p.expand((m,) + p.shape), w.to(p.dtype)]),
        params, pts)
    losses2, grads2 = torch.func.vmap(vgrad_per, in_dims=(0, None))(
        stacked, batch)
    fresh = layout.pack_worker(tree_map(lambda g: g[0], grads2))
    second = layout.pack_worker(tree_map(lambda g: g[1], grads2))
    return losses2[0], fresh, second


def eval_two_point(strategy, layout: FlatLayout, extras: dict, params,
                   batch, m: int, *, vgrad, vgrad_per=None,
                   fuse_evals: bool = False):
    """The two-point eval dispatch. Returns ``(losses, fresh, second)``
    packed planes (``second`` is None for single-eval rules).

    The strategy's INDEXED family (``second_eval_indexed``) decides the
    form: ``slot=None`` is the degenerate one-row ring, a point shared by
    every worker (CADA1's snapshot), evaluated in the broadcast form; a real
    slot vector gathers ``ring[slot]`` (R → M rows) and evaluates either
    per worker (``vgrad_per``) or, with ``fuse_evals``, stacked onto the
    fresh evaluation in one call (:func:`stacked_two_point_eval`).
    """
    indexed = strategy.second_eval_indexed(extras)
    if indexed is None:
        losses, fresh_tree = vgrad(params, batch)
        return losses, layout.pack_worker(fresh_tree), None
    ring, slot = indexed
    if slot is None:
        shared_pt = tree_map(lambda x: x[0], ring)
        losses, fresh_tree = vgrad(params, batch)
        _, second_tree = vgrad(shared_pt, batch)
        return (losses, layout.pack_worker(fresh_tree),
                layout.pack_worker(second_tree))
    idx = slot.long()
    pts = tree_map(lambda x: x.index_select(0, idx), ring)
    if fuse_evals:
        return stacked_two_point_eval(layout, params, pts, batch, m,
                                      vgrad_per)
    losses, fresh_tree = vgrad(params, batch)
    _, second_tree = vgrad_per(pts, batch)
    return (losses, layout.pack_worker(fresh_tree),
            layout.pack_worker(second_tree))


# ------------------------------------------------------------- shared round

def flat_comm_round(strategy, layout: FlatLayout, comm: FlatCommState,
                    params, params_flat, batch, k: int, *, vgrad,
                    vgrad_per: Callable | None = None,
                    fuse_evals: bool = True, impl=None,
                    participation=None,
                    local_steps=None) -> FlatCommRoundResult:
    """One communication round of Algorithm 1 (lines 4-15) on flat buffers.

    ``participation`` ((M,) bool or None) models partial participation: a
    non-participating worker never uploads this round, not even when its
    staleness is capped, and its staleness keeps growing.

    ``local_steps`` (None, a scalar or (M,)) is legal for the delta-payload
    rules only (``strategy.delta_payload``): each worker runs that many of
    the batch's H padded local steps and ships the model delta
    θ^k − θ_m^(h) in place of a fresh gradient; the batch leads with H
    where :func:`batch_has_local_axis` says so. Such a round always
    uploads (LHS +∞), and its grad evals are Σ_active h_w.
    """
    r = strategy.rule
    m = comm.staleness.shape[0]
    if local_steps is not None and not strategy.delta_payload:
        raise ValueError(
            f"rule kind {r.kind!r} ships per-iteration gradients; "
            "local_steps is only meaningful for delta-payload rules "
            "(local_momentum, fedadam)")

    # Line 4 (rule-owned): e.g. CADA1 snapshot refresh every D iterations.
    extras = strategy.flat_pre_step(comm.extras, params, params_flat, k)

    if strategy.delta_payload:
        # the worker runs h_w local optimizer steps and ships the model
        # delta in place of the fresh gradient; with the always-upload
        # cadence the worker copies telescope to the last payload, so
        # ∇ = mean_m(payload) and the rule's server optimizer closes the
        # round (periodic averaging, FedAdam)
        batch_h = (batch if batch_has_local_axis(r, local_steps)
                   else batch_map(lambda x: x[None], batch))
        h_steps = local_steps_vector(m, batch_h, local_steps,
                                     device=params_flat.device)
        losses, fresh, cache = strategy.flat_local_payload(
            layout, extras, params_flat, batch_h, m, vgrad_per, h_steps)
        second = None
    else:
        h_steps = None
        # Lines 6/8: fresh gradients at θ^k, plus the rule's second
        # evaluation.
        losses, fresh, second = eval_two_point(
            strategy, layout, extras, params, batch, m, vgrad=vgrad,
            vgrad_per=vgrad_per, fuse_evals=fuse_evals)
    ctx = FlatCommContext(layout=layout, params=params, fresh=fresh,
                          second=second, comm=comm._replace(extras=extras),
                          step=k, m=m, impl=impl,
                          participation=participation)

    # Lines 7/9: rule LHS vs the shared recent-progress RHS; a delta round
    # always uploads (the "skip" axis is folded into h_w).
    if strategy.delta_payload:
        lhs = torch.full((m,), torch.inf, dtype=torch.float32,
                         device=fresh.device)
    else:
        lhs, cache = strategy.flat_lhs(ctx, extras)
    rhs = r.rhs(comm.diff_hist)
    # Line 10: upload if the condition is VIOLATED or staleness capped.
    upload = (lhs > rhs) | (comm.staleness >= r.max_delay)
    if participation is not None:
        upload = upload & participation

    # Eq. (3): innovation delta, wire format, masked aggregation, whole
    # planes.
    wg32 = comm.worker_grads.float()
    delta = strategy.flat_wire_delta(ctx, extras, cache, fresh - wg32)
    sparse = strategy.flat_sparse_wire(ctx, extras, cache, delta)
    if sparse is not None:
        # True sparse wire: the (M, K) value/index pair is the payload; the
        # dense plane is rebuilt server-side. Values are masked and cast as
        # the dense wire is, so the two paths agree bit for bit.
        vals, idx = sparse
        vals = torch.where(upload[:, None], vals, 0.0).to(
            comm.worker_grads.dtype)
        wire = sparse_rows_to_dense(idx, vals, layout.n_flat)
    else:
        wire = torch.where(upload[:, None], delta, 0.0).to(
            comm.worker_grads.dtype)
    # Order-fixed row accumulation: masked zero rows are exact no-ops.
    nabla = (comm.nabla.float() + kops.eq3_row_mean(wire, m, impl=impl)).to(
        comm.nabla.dtype)
    worker_grads = (wg32 + wire.float()).to(comm.worker_grads.dtype)

    staleness = torch.where(upload, 1, comm.staleness + 1).to(torch.int32)
    extras = strategy.flat_post_upload(extras, cache, upload, ctx)

    uploads = upload.sum(dtype=torch.int32)
    # offline workers evaluate nothing — charge grad evals to participants
    n_active = (torch.tensor(m, dtype=torch.int32, device=upload.device)
                if participation is None
                else participation.sum(dtype=torch.int32))
    if strategy.delta_payload:
        # one eval per local step: Σ_active h_w
        grad_evals = (h_steps if participation is None
                      else torch.where(participation, h_steps, 0)
                      ).sum(dtype=torch.int32)
    else:
        grad_evals = n_active * strategy.grad_evals_per_iter
    metrics = {
        "uploads": uploads,
        "skip_rate": 1.0 - uploads.float() / n_active,
        "upload_mask": upload,
        "staleness": staleness,
        "rhs": rhs,
        "lhs": lhs,
        "mean_lhs": torch.where(torch.isfinite(lhs), lhs, 0.0).mean(),
        "max_staleness": staleness.max(),
        "grad_evals": grad_evals,
        "bytes_up": uploads.float() * strategy.bytes_per_upload(layout.n),
    }
    new_comm = FlatCommState(nabla=nabla, worker_grads=worker_grads,
                             staleness=staleness, diff_hist=comm.diff_hist,
                             extras=extras)
    return FlatCommRoundResult(losses=losses, comm=new_comm, upload=upload,
                               metrics=metrics)


def record_progress(comm: FlatCommState, dtheta_sq, k: int) -> FlatCommState:
    """Push ||θ^{k+1} − θ^k||² into the RHS ring buffer (line 17's tail)."""
    diff_hist = comm.diff_hist.clone()
    diff_hist[k % diff_hist.shape[0]] = dtheta_sq
    return comm._replace(diff_hist=diff_hist)


def nabla_f32(comm: FlatCommState) -> torch.Tensor:
    """∇^k, which drives the server update, as an fp32 flat buffer
    (line 16)."""
    return comm.nabla.float()
