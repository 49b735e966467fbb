"""Dispatch of the ops between a CUDA kernel and its plain version.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``).
A tensor on the card goes to the CUDA kernel (``kernels/cada_update.py``,
``kernels/ssm_scan.py``, ``kernels/flash_attention.py``), which launches or
raises: there is no fallback. ``impl="plain"`` forces the
plain version on any device; it exists so a comparison on the card can run
both, and the engine's main path never passes it. ``impl="kernel"`` asks
for the kernel and raises on a CPU tensor.

The shard-local forms (``shard=``, a ``distributed.sharding.FlatSharding``
of the mesh runtime): each rank runs the same kernel on its own slice (its
``n_flat / shards`` of the server planes, or its rows × column slice of an
(M, n_flat) plane), and ONE all-reduce of the fp32 partials completes the
scalars: ‖Δθ‖² over the state axes, the (M,) norms over the worker and
column axes. No plane is gathered. Eq. (3)'s row mean on the mesh is the
reference's tree sum: a sum over the worker group, then ``/ m_total``;
it launches no kernel.

On the ``meta`` device (the dry run, ``launch/dryrun.py``) the two
serving kernels take a shape-only route: their outputs' shapes and
dtypes, with their operations counted by formula (:func:`counting_meta_ops`)
(the plain versions' loops over time would run S small ops a layer).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import cada_update as _cu
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten

IMPLS = (None, "plain", "kernel")

_META_COUNTS: list = []   # the dicts of the open ``counting_meta_ops``


@contextlib.contextmanager
def counting_meta_ops():
    """Inside, the operations the shape-only routes on ``meta`` tensors
    stand for are counted into the yielded dict (kernel name -> count):
    no PyTorch counter sees a kernel's work, so each adds its count by
    formula. Outside any such block nothing is counted."""
    counts: dict = {}
    _META_COUNTS.append(counts)
    try:
        yield counts
    finally:
        _META_COUNTS.remove(counts)


def count_meta_ops(name: str, ops: int) -> None:
    """Add ``ops`` operations to ``name``'s count in every open
    :func:`counting_meta_ops` block."""
    for counts in _META_COUNTS:
        counts[name] = counts.get(name, 0) + int(ops)


def live_pairs(s: int, window: int = 0) -> int:
    """(query, key) pairs a causal (windowed) attention of length ``s``
    computes."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def use_kernel(t, impl=None) -> bool:
    """True where ``t`` goes to the CUDA kernel, False where to the plain
    version; raises where neither applies."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "plain":
        return False
    if t.device.type == "cuda":
        return True
    if impl == "kernel":
        raise RuntimeError(f"impl='kernel' needs a CUDA tensor, got one on "
                           f"{t.device}")
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain route for device {t.device}")


def fused_amsgrad_flat(theta, h, vhat, grad, lr, *, b1=0.9, b2=0.999,
                       eps=1e-8, impl=None, shard=None):
    """Fused AMSGrad/CADA step over (n,) buffers of any length:
    (θ', h', v̂', Σupd²). Moments keep their storage dtype. With ``shard``
    the buffers are the rank's server slice and Σupd² is summed over the
    state axes; the step is elementwise, so each slice's result is the
    whole plane's there."""
    f = (_cu.fused_amsgrad_flat if use_kernel(theta, impl)
         else _ref.amsgrad_ref)
    out = f(theta, h, vhat, grad, lr, b1=b1, b2=b2, eps=eps)
    if shard is not None and shard.axes:
        return (*out[:3], shard.all_reduce(out[3], shard.axes))
    return out


def batched_diff_sq_norm(a, b, *, impl=None, shard=None):
    """(R,) per-row ||a_r − b_r||² over (R, n) planes (the rule LHS for all
    workers in one pass). A row's value depends on neither R nor any other
    row. With ``shard`` the planes are the rank's rows × column slice and
    the result is (M,): every worker's norm."""
    if use_kernel(a, impl):
        part = _cu.batched_diff_sq_norm_flat(a, b)
    else:
        part = _ref.batched_diff_sq_norm_ref(a, b)
    return part if shard is None else shard.rows_sum(part, shard.plane_axes)


def batched_sq_norm(a, *, impl=None, shard=None):
    """(R,) per-row ||a_r||² over an (R, n) fp32 or bf16 plane (the gate of
    the compressed-wire rules cinn, laq, topk), accumulated in fp32. A
    row's value depends on neither R nor any other row. ``shard`` as in
    :func:`batched_diff_sq_norm`."""
    if use_kernel(a, impl):
        part = _cu.batched_sq_norm_flat(a)
    else:
        part = _ref.batched_sq_norm_ref(a)
    return part if shard is None else shard.rows_sum(part, shard.plane_axes)


def diff_sq_norm_flat(a, b, *, impl=None):
    """Scalar ||a − b||² over (n,) buffers of any length, a 0-d fp32
    tensor."""
    if use_kernel(a, impl):
        return _cu.diff_sq_norm_flat(a, b)
    return _ref.diff_sq_norm_ref(a, b)


def _flatten_padded(tree, dtype, block=1024):
    """Concat all leaves (as ``dtype``) into one flat buffer padded to a
    multiple of ``block``, in the reference's leaf order. Returns (flat,
    unflatten) with ``unflatten(buf, out_dtypes=None)`` cutting a buffer
    back into the tree's shapes, each leaf in its own dtype or in
    ``out_dtypes``."""
    paths, leaves = tree_paths(tree), tree_leaves(tree)
    sizes = [l.numel() for l in leaves]
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    flat = torch.cat([l.reshape(-1).to(dtype) for l in leaves])
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))

    def unflatten(buf, out_dtypes=None):
        out_dtypes = out_dtypes or dtypes
        outs, off = [], 0
        for sz, shp, dt in zip(sizes, shapes, out_dtypes):
            outs.append(buf[off:off + sz].reshape(shp).to(dt))
            off += sz
        return tree_unflatten(paths, outs)

    return flat, unflatten


def fused_cada_update(params, h, vhat, grads, lr, *, b1=0.9, b2=0.999,
                      eps=1e-8, impl=None):
    """The fused CADA/AMSGrad step over dicts of tensors: each tree is cast
    to fp32 and packed into one buffer padded to a multiple of 1024, ONE
    step runs over the buffers (the kernel on the card), and the result is
    cut back into leaves. Returns (params' in each leaf's dtype, h' and
    v̂' in fp32, ||θ'−θ||²). Padding lanes carry zero gradients, so their
    moments stay zero and their update is 0 (eps > 0)."""
    pf, unflat_p = _flatten_padded(params, torch.float32)
    hf, unflat_m = _flatten_padded(h, torch.float32)
    vhf, _ = _flatten_padded(vhat, torch.float32)
    gf, _ = _flatten_padded(grads, torch.float32)
    pt, ht, vht, sq = fused_amsgrad_flat(pf, hf, vhf, gf, lr, b1=b1, b2=b2,
                                         eps=eps, impl=impl)
    f32 = [torch.float32] * len(tree_leaves(h))
    p_dtypes = [l.dtype for l in tree_leaves(params)]
    return (unflat_p(pt, p_dtypes), unflat_m(ht, f32),
            unflat_m(vht, f32), sq)


def diff_sq_norm(tree_a, tree_b, *, impl=None):
    """||a − b||² over two dicts of tensors of the same structure: each is
    packed into one fp32 buffer in the reference's leaf order."""
    af = torch.cat([x.reshape(-1).float() for x in tree_leaves(tree_a)])
    bf = torch.cat([x.reshape(-1).float() for x in tree_leaves(tree_b)])
    return diff_sq_norm_flat(af, bf, impl=impl)


def eq3_row_mean(plane, m_total: int, *, impl=None, shard=None):
    """Eq. (3) aggregate increment Σ_rows(plane) / m_total of an (R, n)
    plane as (n,) fp32, order-fixed (see ``ref.eq3_row_mean_ref``): the
    same bits on both routes, and the same bits with all-zero rows
    dropped.

    With ``shard`` (the mesh runtime) ``plane`` holds the rank's rows of
    its column slice, and the result is that slice's sum over every
    worker, ``/ m_total``: the reference's tree sum under a sharded worker
    axis (a cross-rank sequential order is not expressible), one
    all-reduce over the worker group and no kernel. The all-reduce moves
    the slice in fp32 (4 · n / column shards bytes; a ring all-reduce over
    W ranks sends and receives 2 · (W − 1) / W of that a rank) and the
    caller cuts its server slice out of the sum: a reduce-scatter would
    move half, but all-reduce and all-gather are the collectives gloo
    takes CUDA tensors for, and local momentum's momenta need the whole
    column slice."""
    if shard is not None:
        return shard.all_reduce(plane.float().sum(dim=0),
                                (shard.waxis,)) / m_total
    if use_kernel(plane, impl):
        return _cu.eq3_row_mean_flat(plane, m_total)
    return _ref.eq3_row_mean_ref(plane, m_total)


def selective_scan(dt, x, a, b, c, *, impl=None):
    """Selective scan from a zero state: (y (G, S, D) fp32 without the D·x
    skip or the gate, h_final (G, D, N) fp32). dt/x (G, S, D); a (G, D, N)
    (a zero-stride view over G is fine; stride 0 on N gives the kernel's
    one-decay-per-channel form); b/c (G, S, N). On ``meta`` tensors the
    outputs' shapes and dtypes alone, and 6·G·S·D·N operations counted
    (:func:`counting_meta_ops`) (three FMA-class operations a state and step)."""
    if dt.device.type == "meta":
        g, s, d = dt.shape
        n = a.shape[-1]
        count_meta_ops("selective_scan", 6 * g * s * d * n)
        return (torch.empty((g, s, d), dtype=torch.float32, device="meta"),
                torch.empty((g, d, n), dtype=torch.float32, device="meta"))
    if use_kernel(dt, impl):
        return _ss.selective_scan(dt, x, a, b, c)
    return _ref.selective_scan_ref(dt, x, a, b, c)


def flash_attention(q, k, v, *, window: int = 0, impl=None):
    """Causal (optionally windowed) self-attention, q (B, S, Hq, hd), k/v
    (B, S, Hkv, hd), GQA by a head-index map; output in q's dtype. On
    ``meta`` tensors the output's shape and dtype alone, and the two
    products' 4·hd flops a live (query, key) pair and head counted
    (:func:`counting_meta_ops`)."""
    if q.device.type == "meta":
        b, s, hq, hd = q.shape
        count_meta_ops("flash_attention", 4 * hd * live_pairs(s, window)
                    * b * hq)
        return torch.empty_like(q)
    if use_kernel(q, impl):
        return _fa.flash_attention(q, k, v, window=window)
    return _ref.flash_attention_ref(q, k, v, window=window)
