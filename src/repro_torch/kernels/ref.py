"""Plain PyTorch versions of the port's kernels: the CPU route, and the
oracle each CUDA kernel is held against on the card."""
from __future__ import annotations

import numpy as np
import torch


def amsgrad_ref(theta, h, vhat, grad, lr, *, b1=0.9, b2=0.999, eps=1e-8):
    """Fused AMSGrad/CADA update on flat buffers (paper eqs. 2a-2c: v from
    v̂, ε inside the root; only {h, v̂} persist).

    Moments keep their storage dtype (fp32 or bf16); the math is fp32 and
    the STORED, rounded moment drives the update. Returns
    (θ', h', v̂', Σupd²).
    """
    g = grad.float()
    h32 = h.float()
    vh32 = vhat.float()
    h_new = (b1 * h32 + (1.0 - b1) * g).to(h.dtype)
    v_new = b2 * vh32 + (1.0 - b2) * g * g
    vhat_new = torch.maximum(v_new, vh32).to(vhat.dtype)
    upd = -lr * h_new.float() / torch.sqrt(eps + vhat_new.float())
    theta_new = (theta.float() + upd).to(theta.dtype)
    return theta_new, h_new, vhat_new, torch.sum(upd * upd)


def batched_diff_sq_norm_ref(a, b):
    """(R,) per-row Σ_j (a_rj − b_rj)², accumulated in fp32."""
    d = a.float() - b.float()
    return torch.sum(d * d, dim=1)


def batched_sq_norm_ref(a):
    """(R,) per-row Σ_j a_rj², accumulated in fp32."""
    v = a.float()
    return torch.sum(v * v, dim=1)


def diff_sq_norm_ref(a, b):
    """Scalar Σ (a − b)² over two buffers, accumulated in fp32."""
    d = a.float() - b.float()
    return torch.sum(d * d)


def eq3_row_mean_ref(plane, m_total: int):
    """Eq. (3) aggregate increment Σ_rows(plane) / m_total.

    The rows are added one at a time in DESCENDING order from +0.0, then
    the sum is multiplied by the fp32 reciprocal of ``m_total``: the order
    and rounding of the JAX package's ``ops.eq3_row_mean``, bit for bit.
    A fixed order makes the result invariant to dropping all-zero rows.
    """
    plane = plane.float()
    acc = torch.zeros(plane.shape[1:], dtype=torch.float32,
                      device=plane.device)
    for i in range(plane.shape[0] - 1, -1, -1):
        acc = acc + plane[i]
    return acc * float(np.float32(1.0) / np.float32(m_total))


def selective_scan_ref(dt, x, a, b, c, h0=None):
    """Selective scan, a plain loop over time (the JAX package's
    ``kernels/ref.py::selective_scan_ref``, with an optional start state).

        h_t = exp(Δ_t ⊙ A) ⊙ h_{t−1} + (Δ_t x_t) ⊗ B_t,  y_t = h_t · C_t

    dt/x: (G, S, D); a: (G, D, N) (a broadcast view is fine); b/c:
    (G, S, N); h0: None (zeros) or (G, D, N). All math fp32. Returns y
    (G, S, D) fp32 — no D·x skip, no gate — and h_final (G, D, N) fp32.
    """
    dt, x, a, b, c = (t.float() for t in (dt, x, a, b, c))
    g, s, d = dt.shape
    n = a.shape[-1]
    h = (torch.zeros((g, d, n), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float())
    y = torch.empty((g, s, d), dtype=torch.float32, device=dt.device)
    for t in range(s):
        decay = torch.exp(dt[:, t, :, None] * a)
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        y[:, t] = torch.einsum("gdn,gn->gd", h, c[:, t])
    return y, h


def selective_scan_heads_ref(dt_h, x, a_h, b, c):
    """Mamba2's per-head scan as the plain loop: dt_h (G, S, H) and a_h
    (H,) repeated over each head's P = D / H channels (A as a view with
    stride 0 on N and over G, as ``models/ssm.py`` repeats them for the
    general scan), then :func:`selective_scan_ref` from a zero state."""
    g, s, hn = dt_h.shape
    p, n = x.shape[-1] // hn, b.shape[-1]
    dt = torch.repeat_interleave(dt_h.float(), p, dim=-1)
    a = torch.repeat_interleave(a_h.float(), p)[:, None].expand(-1, n)
    return selective_scan_ref(dt, x, a[None].expand(g, *a.shape), b, c)


FLASH_NEG = -1e30   # the masked score, finite as in the Pallas kernel


def flash_attention_ref(q, k, v, window: int = 0, scale=None):
    """Causal (optionally windowed) attention with the flash kernel's
    semantics, computed in one piece: q (B, S, Hq, hd), k/v (B, S, Hkv, hd);
    q is upcast and multiplied by ``scale`` (None: 1/√hd) before the
    product, scores are
    fp32, masked scores are −1e30 (finite), the softmax denominator is
    max(l, 1e-30), and query head h reads key/value head
    h // (Hq / Hkv). Returns (B, S, Hq, hd) in q's dtype."""
    bsz, s, hq, hd = q.shape
    hkv = k.shape[2]
    head = torch.arange(hq, device=q.device) // (hq // hkv)
    qf = q.float() * (1.0 / float(hd) ** 0.5 if scale is None else scale)
    kf = k.float().index_select(2, head)
    vf = v.float().index_select(2, head)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    pos = torch.arange(s, device=q.device)
    rel = pos[:, None] - pos[None, :]
    mask = rel >= 0
    if window:
        mask &= rel < window
    scores = torch.where(mask, scores, FLASH_NEG)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bhqd", p, vf) / denom
    return out.permute(0, 2, 1, 3).to(q.dtype)


def rope_ref(x, cos, sin, rotary_pct: float = 1.0):
    """The rotary embedding as eager PyTorch: x (..., S, H, hd); cos/sin
    (..., S, rot/2) broadcast over heads; the first ``rot = hd *
    rotary_pct`` dims rotate, the rest pass through. The products, the
    difference and the sum are fp32 where the tables are, then cast to
    x's dtype."""
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
