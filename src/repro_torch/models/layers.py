"""Shared layer primitives: RMSNorm, the FFNs (dense and expert-stacked),
the causal depthwise conv of the Mamba blocks (full sequence and one
decode step), and a layer's view into stacked parameters.
Each keeps the JAX package's dtype discipline (``models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s parameters: a view into every stacked tensor."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def rmsnorm(x, w, eps: float = 1e-5, tp=None):
    """fp32 statistics, the normalised value rounded to x's dtype before
    the weight multiplies it. With ``tp`` (a ``TPContext``) x's last dim is
    this rank's block of a dim sharded over the model axis: Σx² is
    all-reduced in fp32 (its gradient too: the rank's block consumes it)
    and divided by the whole dim."""
    xf = x.float()
    if tp is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = tp.shard_sum(torch.sum(xf * xf, dim=-1, keepdim=True)) \
            / (x.shape[-1] * tp.size)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


_GATE_ACT = {"swiglu": F.silu, "geglu": _gelu}


def ffn(params, cfg: ModelConfig, x, tp=None):
    """Dense FFN: gated (swiglu/geglu: w_gate, w_up, w_down) or plain
    gelu. Where the rank holds a block of d_ff (w_gate/w_up column-,
    w_down row-parallel), x enters the block (its gradient summed over
    ``tp``'s model axis) and the partial output is all-reduced; a
    replicated FFN runs whole."""
    split = tp is not None and params["w_down"].shape[-2] != cfg.d_ff
    if split:
        x = tp.enter(x)
    act = _GATE_ACT.get(cfg.mlp_act)
    if act is not None:
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = _gelu(x @ params["w_up"])
    y = h @ params["w_down"]
    return tp.all_reduce(y) if split else y


def ffn_stacked(params, cfg: ModelConfig, x):
    """Expert-stacked FFN: x (E, C, d) with weights (E, d, ff)/(E, ff, d),
    one batched product per projection."""
    act = _GATE_ACT.get(cfg.mlp_act)
    up = torch.bmm(x, params["w_up"])
    if act is not None:
        h = act(torch.bmm(x, params["w_gate"])) * up
    else:
        h = _gelu(up)
    return torch.bmm(h, params["w_down"])


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
