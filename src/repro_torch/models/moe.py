"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch:
the port of the JAX package's ``models/moe.py``.

  * the router runs in fp32 on its fp32 weight, with TF32 off (a TF32
    product moves the top-k cutoffs); the top-k gates are renormalised
    over the selected experts;
  * each expert takes its top-C tokens by gate score (C = capacity), the
    rest are dropped; the expert products are batched (E, C, d) x
    (E, d, ff) matmuls (``layers.ffn_stacked``);
  * load-balance auxiliary loss (Switch eq. 4): coeff · E · Σ_e f_e · p_e.

The gather and the scatter-add go one expert at a time, in expert order.
Within one expert each token appears at most once, so no index repeats
inside a call: a token chosen by several experts gets their rows added in
expert order, as the reference's scatter adds them, and the layer (its
backward too) gives the same bits from run to run on the card, where an
``index_add_`` over repeated indices adds in no fixed order.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ffn_stacked


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    c = max(8, -(-c // 8) * 8)  # round up to a multiple of 8
    return min(c, n_tokens)     # top_k can't exceed the token count


@contextlib.contextmanager
def _fp32_matmul(device: torch.device):
    """TF32 off for the products inside, on the card; nothing elsewhere."""
    if device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def moe_ffn(params, cfg: ModelConfig, x):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar).

    Global dispatch routes all B·S tokens together. With
    ``cfg.moe_local_dispatch`` routing happens per batch row (the
    reference's vmap over B, here a loop): capacity is enforced per
    sequence, and the aux loss is the mean of the rows'.
    """
    if cfg.moe_local_dispatch:
        rows = [_dispatch(params, cfg, x[i:i + 1]) for i in range(x.shape[0])]
        return (torch.cat([y for y, _ in rows]),
                torch.stack([a for _, a in rows]).mean())
    return _dispatch(params, cfg, x)


def _route(params, cfg: ModelConfig, xf):
    """Routing of the (N, d) tokens: (probs (N, E), gate_idx (N, k), the
    (N, E) combine weights, and each expert's top-C gates and tokens
    (E, C))."""
    with _fp32_matmul(xf.device):
        logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (N, E)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (N, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    # (N, E) combine weights: the renormalised gate if selected, else 0
    combine = torch.zeros_like(probs).scatter(1, gate_idx, gate_vals)
    # capacity dispatch: each expert picks its top-C tokens by gate weight
    top_gate, top_tok = torch.topk(combine.T, _capacity(xf.shape[0], cfg),
                                   dim=-1)                      # (E, C)
    return probs, gate_idx, combine, top_gate, top_tok


def _dispatch(params, cfg: ModelConfig, x):
    b, s, d = x.shape
    n, e = b * s, cfg.n_experts
    xf = x.reshape(n, d)
    probs, gate_idx, _, top_gate, top_tok = _route(params, cfg, xf)

    xe = torch.stack([xf.index_select(0, top_tok[j]) for j in range(e)])
    ye = ffn_stacked(params, cfg, xe)                           # (E, C, d)
    ye = (ye * top_gate[..., None].to(ye.dtype)).to(xf.dtype)

    out = torch.zeros_like(xf)
    for j in range(e):   # expert order; no index repeats within a call
        out.index_add_(0, top_tok[j], ye[j])

    # Switch-style load-balance loss
    # the (N, E) selection indicator (the reference's one-hot summed over
    # k; a scatter, which also runs under torch.func.vmap)
    sel = torch.zeros_like(probs).scatter(1, gate_idx, 1.0)
    frac_tokens = sel.mean(0)                                   # f_e
    mean_prob = probs.mean(0)                                   # p_e
    aux = cfg.router_aux_coeff * e * torch.sum(frac_tokens * mean_prob)
    return out.reshape(b, s, d), aux
