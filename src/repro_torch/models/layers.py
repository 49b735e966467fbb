"""Shared layer primitives: RMSNorm, the dense FFN, and the causal
depthwise conv of the Mamba blocks (full sequence and one decode step).
Each keeps the JAX package's dtype discipline (``models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def rmsnorm(x, w, eps: float = 1e-5):
    """fp32 statistics, the normalised value rounded to x's dtype before
    the weight multiplies it."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


_GATE_ACT = {"swiglu": F.silu, "geglu": _gelu}


def ffn(params, cfg: ModelConfig, x):
    """Dense FFN: gated (swiglu/geglu: w_gate, w_up, w_down) or plain
    gelu."""
    act = _GATE_ACT.get(cfg.mlp_act)
    if act is not None:
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = _gelu(x @ params["w_up"])
    return h @ params["w_down"]


def causal_conv1d(x, w, b):
    """Depthwise causal conv: x (B, S, C), w (K, C) fp32, b (C,); the taps
    are summed in fp32, the result is in x's dtype."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):  # K is tiny (4)
        out = out + pad[:, j:j + x.shape[1], :].float() * w[j]
    return (out + b).to(x.dtype)


def conv1d_step(conv_state, x_t, w, b):
    """One decode step. conv_state (B, K-1, C) holds the last K-1 inputs;
    x_t (B, C). Returns (new_state, y_t)."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B, K, C)
    y = torch.einsum("bkc,kc->bc", full.float(), w) + b
    return full[:, 1:, :], y.to(x_t.dtype)
