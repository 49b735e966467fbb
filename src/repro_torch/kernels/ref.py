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
