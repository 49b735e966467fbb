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
import os
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantize import (keep_where, round_trip, topk_count,
                                       topk_indices, topk_threshold_mask)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.obs.trace import as_tracer
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
    # the cohort plane (flat_cohort_round): the (C,) int64 sorted global
    # worker ids whose rows are on the device this round, or None on the
    # dense plane. When set, ``m`` is C, every pooled per-worker plane has
    # C rows, and the (M,) server extras (avp's periods, cada2's slots)
    # must be indexed by it
    cohort: Any = None


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
                   fuse_evals: bool = False, cohort=None):
    """The two-point eval dispatch. Returns ``(losses, fresh, second)``
    packed planes (``second`` is None for single-eval rules).

    ``cohort`` ((C,) int64 global worker ids, or None): a cohort round.
    ``m`` is then C, ``batch`` holds the cohort's rows only, and the (M,)
    slot vector of the indexed family is cut to the cohort before the
    gather, so the ring stays on the server at full M while only C rows
    are evaluated.

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
    if cohort is not None and slot is not None:
        slot = slot[cohort]
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


# ------------------------------------------------------------ cohort plane
#
# At federated scale (M ≥ 10⁴) the dense (M, n_flat) worker planes do not
# fit on the card, and eq. (3) needs only the AGGREGATE of the uploaded
# innovations, while a worker's rows are touched only on the rounds it is
# sampled. The cohort plane keeps the O(M·n) planes in a host WorkerPool
# and moves the C sampled workers' rows to the card and back each round;
# the server keeps the (n_flat,) aggregate, the (M,) staleness, slot and
# period vectors, the RHS ring and the shared extras (CADA1's snapshot,
# CADA2's stale-iterate ring).
#
# A cohort round is EXACTLY the dense plane run with ``participation`` =
# the cohort's indicator mask: offline workers age (+1 staleness), upload
# nothing, keep their rows and periods, and keep their ring slots
# referenced. Rows never mix, the LHS norms of a row do not depend on how
# many rows the plane has, and eq. (3)'s order-fixed row sum gives the
# same bits with the zero rows of the masked plane dropped
# (kops.eq3_row_mean), so the aggregate is the dense masked mean bit for
# bit wherever the gradient rows are.


class _Fetch(NamedTuple):
    """A block on its way back to the pool: the cohort's row ids (CPU
    int64), the (P, C, n_flat) host rows (a pinned staging slot, or on the
    CPU the block itself), the event of its D2H copy and its slot (None
    on the CPU)."""
    idx: torch.Tensor
    rows: torch.Tensor
    done: Any
    slot: int | None


class WorkerPool:
    """Host-resident per-worker state pool backing the cohort plane.

    (M, n_flat) host tensors: ``worker_grads`` and the planes the strategy
    pools (``strategy.pooled_extras()``: CADA1's ``worker_delta``,
    laq/topk's ``residual``, local momentum's ``momenta``). All planes
    share one storage dtype. ``gather_fused`` moves the C sampled rows to
    the device as one (P, C, n_flat) block (rows in cohort order, sorted
    ascending: the order the parity with the dense plane rests on), and
    ``scatter_fused`` writes a round's block back.

    On a CUDA ``device`` the rows pass through two PINNED staging slots
    ((2, P, C, n_flat), allocated at the first gather), with one copy
    stream per direction: an H2D copy is issued on its stream and the
    compute stream waits on its event before it reads the block; a D2H
    copy waits on an event recorded on the compute stream after the
    producing step, reads the block (which is ``record_stream``-ed to the
    D2H stream, so the caching allocator does not hand it out while the
    copy reads it) into a slot, and the host waits on its event before it
    writes the rows into the planes. Before the host refills a slot it
    waits on that slot's last copies in both directions. Two streams, not
    one: on one in-order stream a round's D2H copy, which waits for the
    round's step, would hold back the next round's H2D copy behind it. On
    the CPU (the tests) the same code runs with no stream and no pinning;
    on a CUDA device a failed pinned allocation raises.

    ``storage="memmap"`` backs each plane with an ``np.memmap`` file
    ``<path>/<name>.plane`` (bf16 as uint16 bits), seen through
    ``torch.from_numpy``: only the touched pages are resident, and
    ``load_state_dict`` writes in place, so the pool stays mapped.
    ``nbytes`` is the logical O(M·n) total; ``mapped_nbytes`` and
    ``resident_nbytes`` report the split.
    """

    STORAGES = ("ram", "memmap")

    def __init__(self, planes: dict, storage: str = "ram",
                 path: str | None = None, device=None):
        if storage not in self.STORAGES:
            raise ValueError(f"storage must be one of {self.STORAGES}, "
                             f"got {storage!r}")
        if storage == "memmap" and path is None:
            raise ValueError('storage="memmap" needs path= (a directory '
                             "for the plane files)")
        self.storage = storage
        self.path = path
        self.device = resolve_device(device)
        self._maps: dict = {}
        if storage == "memmap":
            os.makedirs(path, exist_ok=True)
            self.planes = {}
            for name, v in planes.items():
                v = torch.as_tensor(v)
                # numpy has no bf16: its planes are files of uint16 bits
                np_dtype = (np.uint16 if v.dtype == torch.bfloat16
                            else torch.empty(0, dtype=v.dtype).numpy().dtype)
                mm = np.memmap(os.path.join(path, f"{name}.plane"),
                               dtype=np_dtype, mode="w+",
                               shape=tuple(v.shape))
                plane = torch.from_numpy(mm).view(v.dtype)
                if bool(v.any()):   # a new file reads as zeros already
                    plane.copy_(v)
                self._maps[name] = mm
                self.planes[name] = plane
        else:
            # own host storage: scatter writes in place
            self.planes = {
                name: (v if v.device.type == "cpu" and v.is_contiguous()
                       else v.to("cpu").contiguous())
                for name, v in ((n, torch.as_tensor(x))
                                for n, x in planes.items())}
        shapes = {tuple(v.shape) for v in self.planes.values()}
        if len(shapes) != 1 or len(next(iter(shapes))) != 2:
            raise ValueError(f"pool planes must share one (M, n_flat) "
                             f"shape: {shapes}")
        dtypes = {v.dtype for v in self.planes.values()}
        if len(dtypes) != 1:
            raise ValueError(f"pool planes must share one dtype: {dtypes}")
        self._order = tuple(self.planes)
        self._dtype = dtypes.pop()
        self._stage = None        # (2, P, C, n_flat) host staging slots
        self._h2d = self._d2h = None
        if self.device.type == "cuda":
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
        # per slot: the events of its last H2D and D2H copies, and whether
        # it holds fetched rows not landed yet
        self._slot_events = [[None, None], [None, None]]
        self._unlanded = [False, False]

    @property
    def m(self) -> int:
        return next(iter(self.planes.values())).shape[0]

    @property
    def n_flat(self) -> int:
        return next(iter(self.planes.values())).shape[1]

    @property
    def plane_order(self) -> tuple:
        """The stacking order of the planes in the (P, C, n_flat) block."""
        return self._order

    @property
    def plane_dtype(self) -> torch.dtype:
        """The planes' common storage dtype."""
        return self._dtype

    @property
    def nbytes(self) -> int:
        """Logical plane bytes (the O(M·n) side of the split): host RAM
        for ``storage="ram"``, mapped address space for memmap pools."""
        return int(sum(v.nbytes for v in self.planes.values()))

    @property
    def mapped_nbytes(self) -> int:
        """Bytes living in memmap files rather than RAM."""
        return self.nbytes if self.storage == "memmap" else 0

    @property
    def resident_nbytes(self) -> int:
        """Bytes held in RAM for sure: RAM planes and the staging slots.
        (A memmap plane's touched pages are cached at the OS's discretion
        and not counted.)"""
        planes = 0 if self.storage == "memmap" else self.nbytes
        stage = self._stage.nbytes if self._stage is not None else 0
        return int(planes + stage)

    def device_row_bytes(self, c: int) -> int:
        """Device bytes a C-row gather materializes (the O(C·n) side)."""
        return int(sum(v.element_size() * c * v.shape[1]
                       for v in self.planes.values()))

    # ---- the fused staging path: one copy per round per direction
    @staticmethod
    def _index(cohort) -> torch.Tensor:
        return torch.as_tensor(np.asarray(cohort), dtype=torch.long)

    def _wait_slot(self, slot: int) -> None:
        """The host waits until no copy reads or writes the slot; a slot
        whose fetched rows were not landed may not be refilled."""
        if self._unlanded[slot]:
            raise RuntimeError(f"staging slot {slot} holds fetched rows "
                               "not landed yet")
        for ev in self._slot_events[slot]:
            if ev is not None:
                ev.synchronize()

    def _stage_view(self, c: int, slot: int) -> torch.Tensor:
        if self._stage is None or self._stage.shape[2] != c:
            self._wait_slot(0)
            self._wait_slot(1)
            self._stage = torch.empty(
                (2, len(self._order), c, self.n_flat), dtype=self._dtype,
                pin_memory=self.device.type == "cuda")
        return self._stage[slot]

    def gather_fused(self, cohort, slot: int = 0) -> torch.Tensor:
        """Cohort rows -> device as ONE (P, C, n_flat) block.

        The planes' rows are gathered into staging slot ``slot & 1`` and
        sent in one copy; plane p is ``plane_order[p]``, rows follow
        ``cohort``. On the card the copy runs on the H2D stream and the
        current stream waits on it; the block is ``record_stream``-ed to
        the current stream."""
        idx = self._index(cohort)
        slot &= 1
        buf = self._stage_view(idx.shape[0], slot)
        self._wait_slot(slot)
        for p, name in enumerate(self._order):
            torch.index_select(self.planes[name], 0, idx, out=buf[p])
        if self._h2d is None:
            return buf.clone()     # the slot is reused next round
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._h2d):
            block = torch.empty(buf.shape, dtype=buf.dtype,
                                device=self.device)
            block.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._h2d)
        self._slot_events[slot][0] = done
        compute.wait_event(done)
        block.record_stream(compute)
        return block

    def fetch(self, cohort, fused, slot: int = 0) -> _Fetch:
        """Start writing a (P, C, n_flat) block back: on the card, the D2H
        copy into staging slot ``slot & 1``, after the work the current
        stream has queued (the step that made the block). :meth:`land`
        finishes the write."""
        idx = self._index(cohort)
        fused = fused.to(self._dtype)
        if fused.device.type == "cpu":
            return _Fetch(idx, fused, None, None)
        slot &= 1
        buf = self._stage_view(idx.shape[0], slot)
        if self._unlanded[slot]:
            raise RuntimeError(f"staging slot {slot} holds fetched rows "
                               "not landed yet")
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._d2h):
            self._d2h.wait_event(ready)
            if self._slot_events[slot][0] is not None:
                self._d2h.wait_event(self._slot_events[slot][0])
            buf.copy_(fused, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._d2h)
        fused.record_stream(self._d2h)
        self._slot_events[slot][1] = done
        self._unlanded[slot] = True
        return _Fetch(idx, buf, done, slot)

    def land(self, fetch: _Fetch) -> None:
        """Write a fetched block's rows into the planes (the host waits
        for its D2H copy first)."""
        if fetch.done is not None:
            fetch.done.synchronize()
        for p, name in enumerate(self._order):
            self.planes[name].index_copy_(0, fetch.idx, fetch.rows[p])
        if fetch.slot is not None:
            self._unlanded[fetch.slot] = False

    def scatter_fused(self, cohort, fused, slot: int = 0) -> None:
        """Write a (P, C, n_flat) block back into the planes: one D2H copy,
        then the host writes (:meth:`fetch`, :meth:`land`)."""
        self.land(self.fetch(cohort, fused, slot))

    def gather(self, cohort) -> dict:
        """Cohort rows -> device: {name: (C, n_flat)} views of one
        fused block."""
        return split_fused_rows(self.gather_fused(cohort), self._order)

    def scatter(self, cohort, rows: dict) -> None:
        """Write a round's (C, n_flat) rows back into the pool (one fused
        copy)."""
        self.scatter_fused(cohort, stack_fused_rows(rows, self._order,
                                                    self._dtype))

    def flush(self) -> None:
        """Sync memmap-backed planes to their files (no-op for RAM)."""
        for mm in self._maps.values():
            mm.flush()

    def resum_nabla(self) -> torch.Tensor:
        """Drift guard: ∇ = mean_m(worker_grads) recomputed from the pool,
        the rows added in order in fp64, the result in fp32 (a host
        tensor). The incremental aggregate equals it in real arithmetic;
        in fp32 each round adds rounding noise."""
        wg = self.planes["worker_grads"]
        acc = torch.zeros((wg.shape[1],), dtype=torch.float64)
        for block in wg.split(256):
            for row in block.double():
                acc += row
        return (acc / wg.shape[0]).float()

    # ---- checkpoint: the planes ride checkpoint.io as ordinary leaves,
    # and (M, n_flat) planes reshard through ``_reshard_flat``
    def state_dict(self) -> dict:
        return dict(self.planes)

    def load_state_dict(self, d: dict) -> None:
        for name, plane in self.planes.items():
            t = torch.as_tensor(d[name])
            if tuple(t.shape) != tuple(plane.shape):
                raise ValueError(
                    f"pool plane {name!r}: shape {tuple(t.shape)} != "
                    f"{tuple(plane.shape)}")
            # in place: memmap planes stay mapped, RAM planes stay owned
            plane.copy_(t)


class CohortServerState(NamedTuple):
    """Device-resident server state of the cohort plane: everything that
    is NOT an O(M·n) per-worker plane. ``extras`` holds the shared and
    indexed strategy extras (snapshot, ring, (M,) slot and period
    vectors); the pooled planes live in the :class:`WorkerPool`.
    :func:`record_progress` works on it unchanged."""
    nabla: torch.Tensor        # (n_flat,) storage dtype
    staleness: torch.Tensor    # (M,) int32
    diff_hist: torch.Tensor    # (d_max,) fp32 RHS ring buffer
    extras: dict               # non-pooled strategy extras


class FlatCohortRoundResult(NamedTuple):
    losses: torch.Tensor       # (C,)
    server: CohortServerState  # diff_hist NOT yet updated (record_progress)
    rows: dict                 # updated pooled rows -> WorkerPool.scatter
    upload: torch.Tensor       # (C,) bool
    metrics: dict


def init_cohort_state(strategy, layout: FlatLayout, params, m: int,
                      grad_dtype=torch.float32, params_flat=None,
                      pool_storage: str = "ram",
                      pool_path: str | None = None):
    """Fresh cohort-plane state: (CohortServerState, WorkerPool).

    Field for field the split of :func:`init_flat_comm_state`'s state:
    the pooled per-worker planes go to the host pool (``pool_storage`` and
    ``pool_path`` pick RAM or memmap), the rest stays on ``params_flat``'s
    device, which is also the pool's. τ_m starts at D, so every worker
    uploads on its first sampled round. The plane order is
    ``worker_grads`` first, then the strategy's ``pooled_extras()``: the
    stacking order of the fused block."""
    r = strategy.rule
    if params_flat is None:
        params_flat = layout.pack(params)
    dev = params_flat.device
    full_extras = strategy.init_flat_extras(layout, params, params_flat, m,
                                            grad_dtype)
    # zeros written page by page up front: a RAM pool is resident, and a
    # gather then never meets a page that faults in on its first read
    planes = {"worker_grads": torch.zeros((m, layout.n_flat),
                                          dtype=grad_dtype)}
    for name in strategy.pooled_extras():
        if name in full_extras:
            planes[name] = full_extras.pop(name).to("cpu")
    server = CohortServerState(
        nabla=torch.zeros((layout.n_flat,), dtype=grad_dtype, device=dev),
        staleness=torch.full((m,), r.max_delay, dtype=torch.int32,
                             device=dev),
        diff_hist=torch.zeros((r.d_max,), dtype=torch.float32, device=dev),
        extras=full_extras)
    return server, WorkerPool(planes, storage=pool_storage, path=pool_path,
                              device=dev)


def flat_cohort_round(strategy, layout: FlatLayout,
                      server: CohortServerState, rows: dict, params,
                      params_flat, batch, k: int, cohort, *, m_total: int,
                      vgrad, vgrad_per: Callable | None = None,
                      fuse_evals: bool = True,
                      impl=None) -> FlatCohortRoundResult:
    """One Algorithm-1 round on the cohort plane.

    ``rows`` is the WorkerPool gather for ``cohort`` ((C,) int64 global
    worker ids on the device, SORTED ascending); ``batch`` holds only the
    cohort's rows ((C, b, ...) leaves, or (H, C, b, ...) for a
    delta-payload rule with H > 1 local steps). The round CONSUMES
    ``server``, as the reference's donated cohort step does: cada2's ring
    row is written in place, so only the returned state is live. Bit-exact
    against
    :func:`flat_comm_round` run with ``participation`` = the cohort's
    indicator on the dense plane, wherever the gradient rows are:

      * per-row quantities (gradients, LHS norms, wires) never mix rows;
      * eq. (3)'s aggregate is the order-fixed C-row sum / m_total, the
        dense masked mean's bits with no full-plane re-sum anywhere;
      * offline workers age as dense non-participants do: staleness +1,
        rows and periods untouched, ring slots still referenced (the
        strategies' cohort branches handle the (M,) server extras).
    """
    r = strategy.rule
    c = rows["worker_grads"].shape[0]
    pooled = strategy.pooled_extras()
    merged = {**server.extras, **{name: rows[name] for name in pooled}}
    stale_c = server.staleness[cohort]
    comm_row = FlatCommState(
        nabla=server.nabla, worker_grads=rows["worker_grads"],
        staleness=stale_c, diff_hist=server.diff_hist, extras=merged)

    extras = strategy.flat_pre_step(merged, params, params_flat, k)
    if strategy.delta_payload:
        # the C sampled workers run their H local steps (the cohort plane
        # carries no per-worker schedule) and ship model deltas
        batch_h = (batch if batch_has_local_axis(r, None)
                   else batch_map(lambda x: x[None], batch))
        h_steps = local_steps_vector(c, batch_h, None,
                                     device=params_flat.device)
        losses, fresh, cache = strategy.flat_local_payload(
            layout, extras, params_flat, batch_h, c, vgrad_per, h_steps)
        second = None
    else:
        h_steps = None
        losses, fresh, second = eval_two_point(
            strategy, layout, extras, params, batch, c, vgrad=vgrad,
            vgrad_per=vgrad_per, fuse_evals=fuse_evals, cohort=cohort)
    ctx = FlatCommContext(layout=layout, params=params, fresh=fresh,
                          second=second,
                          comm=comm_row._replace(extras=extras), step=k,
                          m=c, impl=impl, cohort=cohort)
    if strategy.delta_payload:
        lhs = torch.full((c,), torch.inf, dtype=torch.float32,
                         device=fresh.device)
    else:
        lhs, cache = strategy.flat_lhs(ctx, extras)
    rhs = r.rhs(server.diff_hist)
    upload = (lhs > rhs) | (stale_c >= r.max_delay)

    # At an LM's width each (C, n_flat) fp32 plane is gigabytes, so each
    # goes as soon as it is dead (no hook reads ctx.second after the LHS
    # or ctx.fresh after the wire), and the wire is masked in its storage
    # dtype. The bits are the dense round's: a bf16 row widens to fp32
    # exactly, and casting commutes with the mask.
    ctx = ctx._replace(second=None)
    del second
    wgs = rows["worker_grads"]
    delta = strategy.flat_wire_delta(ctx, extras, cache, fresh - wgs)
    sparse = strategy.flat_sparse_wire(ctx, extras, cache, delta)
    ctx = ctx._replace(fresh=None)
    del fresh
    if sparse is not None:
        vals, idx = sparse
        vals = torch.where(upload[:, None], vals, 0.0).to(wgs.dtype)
        wire = sparse_rows_to_dense(idx, vals, layout.n_flat)
    else:
        wire = torch.where(upload[:, None], delta.to(wgs.dtype), 0)
    del delta, sparse
    # ∇ += Σ_cohort δ_m / M: the offline rows would add exact zeros
    nabla = (server.nabla.float()
             + kops.eq3_row_mean(wire, m_total, impl=impl)).to(
                 server.nabla.dtype)
    worker_grads = (wgs.float() + wire.float()).to(wgs.dtype)
    del wire

    staleness = (server.staleness + 1).index_copy(
        0, cohort, torch.where(upload, 1, stale_c + 1).to(torch.int32))
    extras = strategy.flat_post_upload(extras, cache, upload, ctx)
    new_rows = {"worker_grads": worker_grads,
                **{name: extras[name] for name in pooled}}
    server_extras = {name: v for name, v in extras.items()
                     if name not in pooled}

    uploads = upload.sum(dtype=torch.int32)
    metrics = {
        "uploads": uploads,
        "skip_rate": 1.0 - uploads.float() / c,
        "upload_mask": upload,
        "staleness": staleness[cohort],
        "rhs": rhs,
        "lhs": lhs,
        "mean_lhs": torch.where(torch.isfinite(lhs), lhs, 0.0).mean(),
        "max_staleness": staleness.max(),
        "grad_evals": (h_steps.sum(dtype=torch.int32)
                       if strategy.delta_payload
                       else torch.full((), c * strategy.grad_evals_per_iter,
                                       dtype=torch.int32,
                                       device=upload.device)),
        "bytes_up": uploads.float() * strategy.bytes_per_upload(layout.n),
    }
    new_server = CohortServerState(nabla=nabla, staleness=staleness,
                                   diff_hist=server.diff_hist,
                                   extras=server_extras)
    return FlatCohortRoundResult(losses=losses, server=new_server,
                                 rows=new_rows, upload=upload,
                                 metrics=metrics)


# ------------------------------------------------- pipelined cohort driver
#
# The serial cohort loop is a chain per round: host gather and H2D copy,
# the step, D2H copy and host scatter. The pipelined driver reorders
# TRANSFERS, never arithmetic:
#
#   round i:   enqueue step(i)                  [the card runs round i]
#              land out(i-1) in the pool        [its D2H rode under step i]
#              enqueue the D2H copy of out(i)   [after step i, copy stream]
#              gather rows(i+1), enqueue H2D    [under step i]
#
# Round i's rows land in the pool one round late, so when round i+1's
# rows are gathered the pool misses round i's updates. Where consecutive
# cohorts overlap, those rows are forwarded ON THE DEVICE instead: the
# ``src`` schedule maps each round-(i+1) position to its position in round
# i's output block (or -1), and :func:`patch_fused_rows` takes round i's
# output rows there. Those are the bits the scatter + gather round trip
# would have given, so the pipeline equals the serial loop bit for bit.


def cohort_overlap_schedule(cohorts: np.ndarray) -> np.ndarray:
    """(T, C) int32 forwarding schedule of the deferred-scatter pipeline.

    ``src[i, j]`` = the position of worker ``cohorts[i, j]`` in
    ``cohorts[i-1]`` (whose output block is still on the device when round
    i runs), or -1 where the worker was not in the previous cohort. Row 0
    is all -1. Rows must be sorted ascending (the ``sample_cohorts``
    invariant)."""
    cohorts = np.asarray(cohorts, np.int64)
    t, c = cohorts.shape
    src = np.full((t, c), -1, np.int32)
    for i in range(1, t):
        prev = cohorts[i - 1]
        pos = np.clip(np.searchsorted(prev, cohorts[i]), 0, c - 1)
        src[i] = np.where(prev[pos] == cohorts[i], pos, -1).astype(np.int32)
    return src


def patch_fused_rows(fused: torch.Tensor, prev: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """Forward the previous round's output rows into this round's gather.

    ``fused`` and ``prev`` are (P, C, n_flat) and (P, C_prev, n_flat)
    blocks on one device, ``src`` the (C,) schedule row of
    :func:`cohort_overlap_schedule` there; positions with ``src < 0``
    keep the gathered rows. A pure copy of rows: no bit changes."""
    src = src.long()
    safe = src.clamp(0, prev.shape[1] - 1)
    return torch.where((src >= 0)[None, :, None],
                       prev.index_select(1, safe), fused)


def split_fused_rows(fused: torch.Tensor, order: tuple) -> dict:
    """(P, C, n_flat) block -> {plane_name: (C, n_flat)} views."""
    return {name: fused[p] for p, name in enumerate(order)}


def stack_fused_rows(rows: dict, order: tuple, dtype) -> torch.Tensor:
    """{plane_name: (C, n_flat)} -> one (P, C, n_flat) block in the pool's
    storage dtype."""
    return torch.stack([rows[name].to(dtype) for name in order])


def _fetch_metrics(window: list) -> list:
    """Device metric dicts of a window of rounds -> host numpy dicts, one
    copy per key."""
    host = {k: torch.stack([m[k] for m in window]).cpu().numpy()
            for k in window[0]}
    return [{k: v[i] for k, v in host.items()} for i in range(len(window))]


def run_cohort_rounds(step_fn, state, pool: WorkerPool, batch_fn,
                      cohorts: np.ndarray, *, pipeline: bool = True,
                      metrics_every: int = 8, on_round=None,
                      on_round_every: int = 0,
                      trace=None, metrics_out: list | None = None):
    """Drive T cohort rounds through a fused step.

    ``step_fn(state, fused, batch, cohort) -> (state, fused_out,
    metrics)``, with ``fused`` the (P, C, n_flat) gathered block and
    ``cohort`` the round's (C,) int64 ids on the pool's device.
    ``batch_fn(i, cohorts[i])`` supplies round i's cohort batch;
    ``cohorts`` is (T, C) int32, every row sorted ascending with unique
    ids (checked up front: ValueError otherwise). An empty schedule
    returns ``(state, [])``.

    ``pipeline=False`` is the serial oracle: gather → step → scatter per
    round. ``pipeline=True`` gathers round i+1's rows and sends them while
    round i's step runs, and defers round i's writeback one round (its
    D2H copy is queued behind the step, the host lands it in the next
    round); rows that round i+1 shares with round i are forwarded from
    round i's output block on the device (:func:`patch_fused_rows`, a
    separate call, skipped in rounds with no overlap). Both drive the
    same step. The pending writeback is landed on ANY exit, exceptions
    included, so an interrupted run leaves the pool consistent through
    the last completed round.

    Metrics stay on the device and are fetched every ``metrics_every``
    rounds (one copy per key); the partial window is fetched on any exit
    too. ``metrics_out`` (a list, which doubles as the return value)
    holds the fetched host dicts through the last completed round even
    when the run raises. ``on_round(i, state) -> state | None`` fires
    every ``on_round_every`` rounds AFTER the pool holds round i (the
    drift guard's hook). ``trace`` (an ``obs.trace.Tracer`` or None)
    records each round's gather/patch/step/scatter spans on the
    ``"pipeline"`` track, on the host's clock: they time the host's work
    and waits, not the device's. Returns (state, list of host metric
    dicts).
    """
    cohorts = np.asarray(cohorts, np.int32)
    t_rounds = cohorts.shape[0]
    mets_host: list = metrics_out if metrics_out is not None else []
    if t_rounds == 0:
        return state, mets_host
    # the overlap schedule searchsorts the previous row, so an unsorted
    # cohort would forward the WRONG rows; sorting here instead would
    # desynchronize the cohorts from batch_fn's batches
    if not (np.diff(cohorts, axis=1) > 0).all():
        raise ValueError(
            "run_cohort_rounds: every cohorts row must be sorted "
            "ascending with unique worker ids (the sample_cohorts "
            "invariant) — sort each cohort AND its batch together "
            "before calling")
    metrics_every = max(1, int(metrics_every))
    tracer = as_tracer(trace)
    # the schedule goes to the device once; a round takes views of it
    cohorts_dev = torch.as_tensor(cohorts, dtype=torch.long,
                                  device=pool.device)
    mets_dev: list = []

    def flush_metrics():
        if mets_dev:
            mets_host.extend(_fetch_metrics(mets_dev))
            mets_dev.clear()

    def after_round(i, met):
        """Queue round i's metrics; whether the hook fires now."""
        mets_dev.append(met)
        if len(mets_dev) >= metrics_every:
            flush_metrics()
        return (on_round is not None and on_round_every
                and (i + 1) % on_round_every == 0)

    if not pipeline:
        try:
            for i in range(t_rounds):
                with tracer.span("gather", track="pipeline"):
                    fused = pool.gather_fused(cohorts[i])
                with tracer.span("step", track="pipeline"):
                    state, out, met = step_fn(state, fused,
                                              batch_fn(i, cohorts[i]),
                                              cohorts_dev[i])
                del fused
                with tracer.span("scatter", track="pipeline"):
                    pool.scatter_fused(cohorts[i], out)
                del out
                if after_round(i, met):
                    state = _maybe(on_round(i, state), state)
        finally:
            flush_metrics()
        return state, mets_host

    src_sched = cohort_overlap_schedule(cohorts)
    has_overlap = (src_sched >= 0).any(axis=1)
    src_dev = torch.as_tensor(src_sched, dtype=torch.long,
                              device=pool.device)
    prev = None                        # round i-1's output block
    with tracer.span("gather", track="pipeline"):
        fused_next = pool.gather_fused(cohorts[0], slot=0)
    pending = None                     # round i-1's writeback in flight
    try:
        for i in range(t_rounds):
            batch = batch_fn(i, cohorts[i])
            if has_overlap[i]:
                # rows shared with round i-1 are stale in the early
                # gather: take them from round i-1's output block
                with tracer.span("patch", track="pipeline"):
                    fused_next = patch_fused_rows(fused_next, prev,
                                                  src_dev[i])
            with tracer.span("step", track="pipeline"):
                state, out, met = step_fn(state, fused_next, batch,
                                          cohorts_dev[i])
            fused_next = prev = None
            with tracer.span("scatter", track="pipeline"):
                if pending is not None:
                    pool.land(pending)
                # round i's writeback: its D2H copy waits for step i
                pending = pool.fetch(cohorts[i], out, slot=i & 1)
            prev = out
            del out
            if i + 1 < t_rounds:
                with tracer.span("gather", track="pipeline"):
                    fused_next = pool.gather_fused(cohorts[i + 1],
                                                   slot=(i + 1) & 1)
            if after_round(i, met):
                # the hook reads the pool: land round i's rows first
                pool.land(pending)
                pending = None
                state = _maybe(on_round(i, state), state)
    finally:
        # land on ANY exit: the pool and the metrics are consistent
        # through the last completed round
        if pending is not None:
            pool.land(pending)
        flush_metrics()
    return state, mets_host


def _maybe(new_state, state):
    return state if new_state is None else new_state
