"""Dispatch of the ops between a CUDA kernel and its plain version.

A tensor on the CPU goes to the plain PyTorch version (``kernels/ref.py``).
A tensor on the card goes to the CUDA kernel (``kernels/cada_update.py``,
``kernels/ssm_scan.py``, ``kernels/flash_attention.py``), which launches or
raises: there is no fallback. ``impl="plain"`` forces the
plain version on any device; it exists so a comparison on the card can run
both, and the engine's main path never passes it. ``impl="kernel"`` asks
for the kernel and raises on a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cada_update as _cu
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.utils.trees import tree_leaves

IMPLS = (None, "plain", "kernel")


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
                       eps=1e-8, impl=None):
    """Fused AMSGrad/CADA step over (n,) buffers of any length:
    (θ', h', v̂', Σupd²). Moments keep their storage dtype."""
    f = (_cu.fused_amsgrad_flat if use_kernel(theta, impl)
         else _ref.amsgrad_ref)
    return f(theta, h, vhat, grad, lr, b1=b1, b2=b2, eps=eps)


def batched_diff_sq_norm(a, b, *, impl=None):
    """(R,) per-row ||a_r − b_r||² over (R, n) planes (the rule LHS for all
    workers in one pass). A row's value depends on neither R nor any other
    row."""
    if use_kernel(a, impl):
        return _cu.batched_diff_sq_norm_flat(a, b)
    return _ref.batched_diff_sq_norm_ref(a, b)


def batched_sq_norm(a, *, impl=None):
    """(R,) per-row ||a_r||² over an (R, n) fp32 or bf16 plane (the gate of
    the compressed-wire rules cinn, laq, topk), accumulated in fp32. A
    row's value depends on neither R nor any other row."""
    if use_kernel(a, impl):
        return _cu.batched_sq_norm_flat(a)
    return _ref.batched_sq_norm_ref(a)


def diff_sq_norm_flat(a, b, *, impl=None):
    """Scalar ||a − b||² over (n,) buffers of any length, a 0-d fp32
    tensor."""
    if use_kernel(a, impl):
        return _cu.diff_sq_norm_flat(a, b)
    return _ref.diff_sq_norm_ref(a, b)


def diff_sq_norm(tree_a, tree_b, *, impl=None):
    """||a − b||² over two dicts of tensors of the same structure: each is
    packed into one fp32 buffer in the reference's leaf order."""
    af = torch.cat([x.reshape(-1).float() for x in tree_leaves(tree_a)])
    bf = torch.cat([x.reshape(-1).float() for x in tree_leaves(tree_b)])
    return diff_sq_norm_flat(af, bf, impl=impl)


def eq3_row_mean(plane, m_total: int, *, impl=None):
    """Eq. (3) aggregate increment Σ_rows(plane) / m_total of an (R, n)
    plane as (n,) fp32, order-fixed (see ``ref.eq3_row_mean_ref``): the
    same bits on both routes, and the same bits with all-zero rows
    dropped."""
    if use_kernel(plane, impl):
        return _cu.eq3_row_mean_flat(plane, m_total)
    return _ref.eq3_row_mean_ref(plane, m_total)


def selective_scan(dt, x, a, b, c, *, impl=None):
    """Selective scan from a zero state: (y (G, S, D) fp32 without the D·x
    skip or the gate, h_final (G, D, N) fp32). dt/x (G, S, D); a (G, D, N)
    (a zero-stride view over G is fine; stride 0 on N gives the kernel's
    one-decay-per-channel form); b/c (G, S, N)."""
    if use_kernel(dt, impl):
        return _ss.selective_scan(dt, x, a, b, c)
    return _ref.selective_scan_ref(dt, x, a, b, c)


def flash_attention(q, k, v, *, window: int = 0, impl=None):
    """Causal (optionally windowed) self-attention, q (B, S, Hq, hd), k/v
    (B, S, Hkv, hd), GQA by a head-index map; output in q's dtype."""
    if use_kernel(q, impl):
        return _fa.flash_attention(q, k, v, window=window)
    return _ref.flash_attention_ref(q, k, v, window=window)
