"""Attention: GQA with RoPE / partial RoPE, the causal prefill path, and
the one-token decode path over a (possibly ring-buffered) KV cache. The
port of the JAX package's ``models/attention.py``: logits and softmax in
fp32, values in the model dtype, GQA grouped without repeating K/V in the
model code.

The prefill route differs from the reference's on purpose. The reference
sends a self-attention of S < 2048 to ``naive_attention`` and one of
S >= 2048 to its own jnp blockwise loop, and never calls its Pallas flash
kernel. Here :func:`causal_attention` sends every self-attention with
standard positions, at every length, through ``ops.flash_attention``: the
CUDA kernel on the card, its plain version on the CPU. Both compute the
same causal softmax; they differ from the reference's routes only in
rounding (the kernel scales q before the product, the reference's routes
after it).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

_NEG = -1e30


# ----------------------------------------------------------------- RoPE

def rope_angles(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2)."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rotary_pct: float = 1.0):
    """x (..., S, H, hd); cos/sin (..., S, rot/2) broadcast over heads; the
    first ``rot = hd * rotary_pct`` dims rotate, the rest pass through."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    c = cos[..., None, : rot // 2]
    s = sin[..., None, : rot // 2]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ------------------------------------------------------------- projections

def qkv(params, cfg: ModelConfig, x):
    """x (B,S,d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    return q, k, v


def out_proj(params, x):
    b, s = x.shape[:2]
    return x.reshape(b, s, -1) @ params["wo"]


# ------------------------------------------------------------ core attention

def _grouped_scores(q, k):
    """q (B,Sq,Hq,hd), k (B,Sk,Hkv,hd) -> fp32 scores (B,Hq,Sq,Sk) / √hd
    via GQA groups."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    return scores.reshape(b, hq, sq, k.shape[1]) / torch.sqrt(
        torch.tensor(float(hd)))


def _grouped_values(probs, v):
    """probs (B,Hq,Sq,Sk), v (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd)."""
    b, hq, sq, sk = probs.shape
    hkv = v.shape[2]
    pg = probs.reshape(b, hkv, hq // hkv, sq, sk)
    out = torch.einsum("bkgqs,bskh->bqkgh", pg, v.to(probs.dtype))
    return out.reshape(b, sq, hq, v.shape[3])


def naive_attention(q, k, v, positions_q=None, positions_k=None,
                    window: int = 0, dtype=torch.bfloat16):
    """O(S²)-memory attention with explicit positions (tests, and the
    CPU route of non-standard positions)."""
    sq, sk = q.shape[1], k.shape[1]
    if positions_q is None:
        positions_q = torch.arange(sq, device=q.device)
    if positions_k is None:
        positions_k = torch.arange(sk, device=q.device)
    scores = _grouped_scores(q, k)
    rel = positions_q[:, None] - positions_k[None, :]        # (Sq, Sk)
    mask = rel >= 0
    if window:
        mask &= rel < window
    scores = torch.where(mask[None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_values(probs, v).to(dtype)


def causal_attention(q, k, v, positions_q=None, positions_k=None,
                     window: int = 0, dtype=torch.bfloat16, impl=None):
    """Causal (optionally sliding-window) attention for prefill/forward.

    Self-attention with standard positions goes through
    ``ops.flash_attention`` at every length (see the module docstring).
    Explicit positions (M-RoPE) have no kernel yet: on the CPU they take
    :func:`naive_attention`, on the card they raise.
    """
    standard = positions_q is None and positions_k is None
    if standard and q.shape[1] == k.shape[1]:
        return ops.flash_attention(q, k, v, window=window,
                                   impl=impl).to(dtype)
    if q.device.type == "cuda":
        raise NotImplementedError(
            "causal_attention with explicit positions (M-RoPE) or Sq != Sk "
            "on the card: no kernel is ported for it (MoE/VLM slice)")
    return naive_attention(q, k, v, positions_q, positions_k, window, dtype)


def decode_attention(q, k_cache, v_cache, valid, dtype=torch.bfloat16):
    """One-token attention over a (possibly ring-buffered) cache, plain
    PyTorch on every device, as the reference's is plain jnp.

    q (B,1,Hq,hd); k/v_cache (B,W,Hkv,hd); valid (B,W) bool.
    """
    scores = _grouped_scores(q, k_cache)                     # (B,Hq,1,W)
    scores = torch.where(valid[:, None, None, :], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_values(probs, v_cache).to(dtype)
