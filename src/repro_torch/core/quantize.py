"""Lossy innovation compression: uniform quantization, top-k
sparsification, and error-feedback residuals (the JAX package's
``core/quantize.py``).

Per-leaf symmetric uniform quantization with a max-abs scale:
    q = round(x / s · (2^(b-1) − 1)),   x̂ = q · s / (2^(b-1) − 1)
written in exactly that order (``torch.round`` rounds half to even, as
``jnp.round`` does), so the port's x̂ equals the reference's bit for bit.

Top-k keeps exactly the k largest-magnitude entries per (worker, leaf),
ties to the LOWER index; error feedback carries the dropped or rounded mass
in a per-worker residual e_m:
    wire_m = C(δ_m + e_m),   e_m ← (δ_m + e_m) − wire_m   (on upload)
``ef_correct``/``ef_residual`` are tree maps, so they serve both dicts of
(M, ...) leaves and bare (M, n_flat) planes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.utils.trees import tree_map


def _levels(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def round_trip(x, scale, levels: float):
    """x̂ = round(x / s · L) · s / L in fp32, stored back in x's dtype.

    The division by L divides by a tensor on x's device: PyTorch's CUDA
    division by a Python or CPU scalar multiplies by its reciprocal, which
    rounds otherwise than the true division of the CPU and of XLA."""
    xf = x.float()
    q = torch.round(xf / scale * levels)
    lv = torch.full((), levels, dtype=torch.float32, device=x.device)
    return (q * scale / lv).to(x.dtype)


def quantize_dequantize(tree, bits: int):
    """Round-trip b-bit uniform quantization of every leaf (what the server
    receives), one scale per leaf."""
    if bits <= 0 or bits >= 32:
        return tree
    levels = _levels(bits)

    def leaf(x):
        scale = torch.clamp_min(x.float().abs().amax(), 1e-12)
        return round_trip(x, scale, levels)

    return tree_map(leaf, tree)


def per_worker_quantize_dequantize(tree, bits: int):
    """Same, but leaves carry a leading worker axis: one scale per worker
    (axis 0), as each worker would transmit independently."""
    if bits <= 0 or bits >= 32:
        return tree
    levels = _levels(bits)

    def leaf(x):
        mag = x.float().abs()
        dims = tuple(range(1, x.dim()))
        # (M,) leaves: one entry per worker (amax over no axis)
        scale = torch.clamp_min(
            mag.amax(dim=dims, keepdim=True) if dims else mag, 1e-12)
        return round_trip(x, scale, levels)

    return tree_map(leaf, tree)


# ------------------------------------------------------------------- top-k

def topk_count(size: int, frac: float) -> int:
    """Entries kept per worker for a leaf/segment of ``size`` (at least 1)."""
    return max(1, min(size, int(math.ceil(frac * size))))


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """(M, k) int64 column indices of the k largest |x| per row, ties to the
    LOWER index. A stable descending sort gives that order on every device;
    ``torch.topk`` promises no order among ties."""
    k = int(min(max(k, 1), x.shape[1]))
    order = torch.sort(x.abs(), dim=1, descending=True, stable=True).indices
    return order[:, :k]


def topk_threshold_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """(M, s) bool mask of the k largest-|x| entries per row: EXACTLY k,
    ties to the lower index (``lax.top_k``'s order), so the kept count is
    the k the sparse accounting charges for."""
    idx = topk_indices(x, k)
    return torch.zeros(x.shape, dtype=torch.bool, device=x.device).scatter_(
        1, idx, True)


def keep_where(mask, x):
    """x where ``mask``, +0.0 elsewhere. The reference writes ``x * mask``,
    which XLA compiles to this select; an eager product would leave −0.0
    under negative entries."""
    return torch.where(mask, x, 0.0)


def per_worker_topk_sparsify(tree, frac: float):
    """Keep the top-⌈frac·size⌉ largest-magnitude entries per (worker,
    leaf); everything else becomes exactly zero. Leaves carry a leading
    worker axis."""
    if frac >= 1.0:
        return tree

    def leaf(x):
        xf = x.float()
        flat = xf.reshape(xf.shape[0], -1)
        mask = topk_threshold_mask(flat, topk_count(flat.shape[1], frac))
        return keep_where(mask, flat).reshape(xf.shape).to(x.dtype)

    return tree_map(leaf, tree)


# ----------------------------------------------------------- error feedback

def ef_correct(delta, residual):
    """δ_m + e_m in fp32: the innovation the compressor actually sees."""
    return tree_map(lambda d, e: d.float() + e.float(), delta, residual)


def ef_residual(corrected, wire, upload, residual):
    """Post-upload residual transition (storage dtype follows
    ``residual``): uploaders keep what their wire dropped,
    e_m ← (δ_m+e_m) − wire_m; skippers carry e_m unchanged."""
    def leaf(c, w, e):
        mm = upload.reshape((-1,) + (1,) * (c.dim() - 1))
        return torch.where(mm, (c.float() - w.float()).to(e.dtype), e)
    return tree_map(leaf, corrected, wire, residual)
