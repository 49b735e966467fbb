"""Attention: GQA with RoPE / partial RoPE / M-RoPE, the causal prefill
path, and
the one-token decode path over a (possibly ring-buffered) KV cache. The
port of the JAX package's ``models/attention.py``: logits and softmax in
fp32, values in the model dtype, GQA grouped without repeating K/V in the
model code.

:func:`causal_attention` has two routes.
  * Serving (prefill and forward) differs from the reference's on purpose.
    The reference sends a self-attention of S < 2048 to
    ``naive_attention`` and one of S >= 2048 to its own jnp blockwise
    loop, and never calls its Pallas flash kernel. Here every
    self-attention with standard positions, at every length, goes through
    ``ops.flash_attention``: the CUDA kernel on the card, its plain version
    on the CPU. Both compute the same causal softmax; they differ from the
    reference's routes only in rounding (the kernel scales q before the
    product, the reference's routes after it). Explicit positions, or
    Sq != Sk, take :func:`naive_attention` on every device, the
    reference's own route for them. The models never pass positions to
    attention (M-RoPE positions only shape the rotary tables), so their
    prefill always runs the kernel.
  * Training (``train=True``) makes the reference's choice, in PyTorch
    under autograd on every device: :func:`blockwise_attention` for a long
    self-attention, :func:`naive_attention` otherwise. The kernel has no
    backward, as the reference's Pallas kernel has none.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig

_NEG = -1e30

FLASH_THRESHOLD = 2048   # training: blockwise attention at/above this length
FLASH_Q_CHUNK = 1024
FLASH_KV_CHUNK = 1024


# ----------------------------------------------------------------- RoPE

def rope_angles(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2)."""
    half = dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_angles(positions, dim: int, theta: float, sections):
    """M-RoPE (Qwen2-VL): positions (3, B, S) for the (t, h, w) axes; the
    head dim's halves are split into per-axis sections. -> cos/sin
    (B, S, dim/2)."""
    half = dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not add up "
                         f"to dim/2 = {half}")
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang_per_axis = positions.float()[..., None] * freqs      # (3,B,S,half)
    chunks, start = [], 0
    for axis, sec in enumerate(sections):
        chunks.append(ang_per_axis[axis, ..., start:start + sec])
        start += sec
    ang = torch.cat(chunks, dim=-1)                          # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rotary_pct: float = 1.0, impl=None):
    """x (..., S, H, hd); cos/sin (..., S, rot/2) broadcast over heads; the
    first ``rot = hd * rotary_pct`` dims rotate, the rest pass through.

    Where autograd would record the call (grad enabled and x, cos or sin
    requiring grad), the eager expression ``ref.rope_ref``: the kernel has
    no backward. Every other call goes to ``ops.apply_rope``, the one-pass
    kernel on the card (x (B, S, H, hd) contiguous), which gives the same
    bits."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, cos, sin)):
        return ref.rope_ref(x, cos, sin, rotary_pct)
    return ops.apply_rope(x, cos, sin, rotary_pct, impl=impl)


# ------------------------------------------------------------- projections

def qkv(params, cfg: ModelConfig, x, tp=None):
    """x (B,S,d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd); the head counts are
    the weights' (a rank's heads where they are sharded). Where ``wq`` is
    a block of the heads, x enters the column-parallel block under ``tp``
    (its gradient summed over the model axis), and so do ``wk``/``wv``
    where they stay whole (:func:`local_kv` then takes the rank's KV heads
    of the whole K/V)."""
    b, s, _ = x.shape
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    if tp is not None and wq.shape[-1] != cfg.n_heads * cfg.hd:
        x = tp.enter(x)
        if wk.shape[-1] == cfg.n_kv_heads * cfg.hd:
            wk, wv = tp.enter(wk), tp.enter(wv)
    q = (x @ wq).reshape(b, s, -1, cfg.hd)
    k = (x @ wk).reshape(b, s, -1, cfg.hd)
    v = (x @ wv).reshape(b, s, -1, cfg.hd)
    return q, k, v


def out_proj(params, x, tp=None):
    """The heads' outputs through ``wo``. With ``tp`` the rank holds a
    block of the heads (``wo`` row-parallel): the partial product is
    all-reduced over the model axis."""
    b, s = x.shape[:2]
    y = x.reshape(b, s, -1) @ params["wo"]
    return y if tp is None else tp.all_reduce(y)


def local_kv(k, v, cfg: ModelConfig, hq: int, tp):
    """K/V (..., Hkv, hd) for the rank's ``hq`` query heads. Where ``wq`` is
    sharded over the model axis and ``wk``/``wv`` are not (the KV heads do
    not divide it), the rank keeps the KV heads its query heads read by
    the GQA grouping of :func:`_grouped_scores` (query head j reads KV head
    j // (Hq / Hkv)): a block of them where the grouping stays uniform,
    else one per query head. Otherwise K/V are the rank's already."""
    g = cfg.n_heads // cfg.n_kv_heads
    if k.shape[-2] * g == hq:
        return k, v
    lo = tp.index * hq
    idx = [(lo + j) // g for j in range(hq)]
    block = sorted(set(idx))
    if idx == [u for u in block for _ in range(hq // len(block))]:
        idx = block
    idx = torch.tensor(idx, device=k.device)
    return k.index_select(-2, idx), v.index_select(-2, idx)


# ------------------------------------------------------------ core attention

def _grouped_scores(q, k, scale=None):
    """q (B,Sq,Hq,hd), k (B,Sk,Hkv,hd) -> fp32 scores (B,Hq,Sq,Sk) / √hd
    (times ``scale`` where one is given) via GQA groups."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    scores = scores.reshape(b, hq, sq, k.shape[1])
    if scale is not None:
        return scores * scale
    return scores / torch.sqrt(torch.tensor(float(hd)))


def _grouped_values(probs, v):
    """probs (B,Hq,Sq,Sk), v (B,Sk,Hkv,hd) -> (B,Sq,Hq,hd)."""
    b, hq, sq, sk = probs.shape
    hkv = v.shape[2]
    pg = probs.reshape(b, hkv, hq // hkv, sq, sk)
    out = torch.einsum("bkgqs,bskh->bqkgh", pg, v.to(probs.dtype))
    return out.reshape(b, sq, hq, v.shape[3])


def naive_attention(q, k, v, positions_q=None, positions_k=None,
                    window: int = 0, dtype=torch.bfloat16, scale=None):
    """O(S²)-memory attention with explicit positions: the route of
    non-standard positions on every device, and of short training
    sequences. ``scale``: the softmax scale (None: 1/√hd), here and in
    the functions below."""
    sq, sk = q.shape[1], k.shape[1]
    if positions_q is None:
        positions_q = torch.arange(sq, device=q.device)
    if positions_k is None:
        positions_k = torch.arange(sk, device=q.device)
    scores = _grouped_scores(q, k, scale)
    rel = positions_q[:, None] - positions_k[None, :]        # (Sq, Sk)
    mask = rel >= 0
    if window:
        mask &= rel < window
    scores = torch.where(mask[None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return _grouped_values(probs, v).to(dtype)


def blockwise_attention(q, k, v, window: int = 0, dtype=torch.bfloat16,
                        q_chunk: int = FLASH_Q_CHUNK,
                        kv_chunk: int = FLASH_KV_CHUNK, scale=None):
    """Blockwise (flash-style) causal attention, O(S·chunk) memory: the
    reference's jnp ``flash_attention``, the training route's long
    self-attention.

    A loop over query blocks, each with its KV extent trimmed to the
    causal/window range, and an inner loop over KV blocks carrying the
    running (max, sum, acc) softmax state in fp32. Self-attention only
    (Sq == Sk, standard positions); GQA computed grouped.
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    kv_chunk = min(kv_chunk, q_chunk)  # causal trim needs kv | q blocks
    if s % q_chunk or q_chunk % kv_chunk:
        raise ValueError(f"blockwise attention: S={s}, q_chunk={q_chunk}, "
                         f"kv_chunk={kv_chunk} do not divide")
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(hd)))
    qg = q.reshape(b, s, hkv, g, hd)
    arange_q = torch.arange(q_chunk, device=q.device)
    arange_k = torch.arange(kv_chunk, device=q.device)
    outs = []
    for q_lo in range(0, s, q_chunk):
        kv_lo = 0 if not window else max(0, (q_lo - window) // kv_chunk
                                         * kv_chunk)
        qb = qg[:, q_lo:q_lo + q_chunk].float()           # (B,qc,Hkv,G,hd)
        pos_q = q_lo + arange_q
        m = torch.full((b, hkv, g, q_chunk), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for k_lo in range(kv_lo, q_lo + q_chunk, kv_chunk):
            kc = k[:, k_lo:k_lo + kv_chunk].float()          # (B,kc,Hkv,hd)
            vc = v[:, k_lo:k_lo + kv_chunk].float()
            sc = torch.einsum("bqkgh,bskh->bkgqs", qb, kc) * scale
            rel = pos_q[:, None] - (k_lo + arange_k)[None, :]
            mask = rel >= 0
            if window:
                mask &= rel < window
            sc = torch.where(mask[None, None, None], sc, _NEG)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vc)
            m = m_new
        ob = acc / l[..., None]                              # (B,Hkv,G,qc,hd)
        outs.append(ob.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, hq, hd))
    return torch.cat(outs, dim=1).to(dtype)


def causal_attention(q, k, v, positions_q=None, positions_k=None,
                     window: int = 0, dtype=torch.bfloat16, impl=None,
                     train=False, scale=None):
    """Causal (optionally sliding-window) attention for prefill/forward
    (see the module docstring for the two routes).

    Serving: self-attention with standard positions goes through
    ``ops.flash_attention`` at every length; explicit positions or
    Sq != Sk take :func:`naive_attention`, as in the reference.

    Training: :func:`blockwise_attention` where Sq = Sk ≥ 2048, both
    divisible by the chunk, with standard positions; else
    :func:`naive_attention` (the reference's dispatch).

    ``scale``: the softmax scale on every route (None: 1/√hd).
    """
    standard = positions_q is None and positions_k is None
    if train:
        sq, sk = q.shape[1], k.shape[1]
        if (standard and sq == sk and sq >= FLASH_THRESHOLD
                and sq % FLASH_Q_CHUNK == 0 and sk % FLASH_KV_CHUNK == 0):
            return blockwise_attention(q, k, v, window=window, dtype=dtype,
                                       scale=scale)
        return naive_attention(q, k, v, positions_q, positions_k, window,
                               dtype, scale)
    if standard and q.shape[1] == k.shape[1]:
        return ops.flash_attention(q, k, v, window=window, impl=impl,
                                   scale=scale).to(dtype)
    return naive_attention(q, k, v, positions_q, positions_k, window, dtype,
                           scale)


def decode_attention(q, k_cache, v_cache, valid, dtype=torch.bfloat16,
                     tp=None, scale=None):
    """One-token attention over a (possibly ring-buffered) cache, plain
    PyTorch on every device, as the reference's is plain jnp.

    q (B,1,Hq,hd); k/v_cache (B,W,Hkv,hd); valid (B,W) bool; ``scale``
    the softmax scale (None: 1/√hd).

    With ``tp`` the ring is sharded over W (``cache_pspecs`` when the KV
    heads do not divide the model axis): the rank holds W/m of the slots
    of every KV head, ``valid`` its slots' flags, and q every query head.
    The softmax completes as flash decoding does: the fp32 max of the
    scores all-reduced (MAX), then the sum of exp and the exp-weighted
    values all-reduced (SUM, one fp32 buffer), then divided. A rank with
    no valid slot adds zeros (exp(-1e30 - max)).
    """
    scores = _grouped_scores(q, k_cache, scale)              # (B,Hq,1,W)
    scores = torch.where(valid[:, None, None, :], scores, _NEG)
    if tp is None:
        probs = torch.softmax(scores, dim=-1)
        return _grouped_values(probs, v_cache).to(dtype)
    top = tp.all_reduce(scores.amax(dim=-1, keepdim=True), op="max")
    p = torch.exp(scores - top)
    out = _grouped_values(p, v_cache)                        # (B,1,Hq,hd)
    denom = p.sum(dim=-1).transpose(1, 2)[..., None]         # (B,1,Hq,1)
    packed = tp.all_reduce(torch.cat([out.flatten(), denom.flatten()]))
    out, denom = packed.split([out.numel(), denom.numel()])
    return (out.reshape(q.shape) / denom.reshape(
        *q.shape[:3], 1)).to(dtype)
