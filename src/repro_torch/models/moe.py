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


def moe_ffn(params, cfg: ModelConfig, x, tp=None):
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar).

    Global dispatch routes all B·S tokens together. With
    ``cfg.moe_local_dispatch`` routing happens per batch row (the
    reference's vmap over B, here a loop): capacity is enforced per
    sequence, and the aux loss is the mean of the rows'.

    Under tensor parallelism (``tp``) the replicated fp32 router routes
    every token on every rank. Where the rank holds E/m whole experts
    (expert-parallel) it runs its own experts over their capacity
    dispatch, in expert order, into a zero y; where it holds a block of
    every expert's d_ff (TP inside each expert) it runs every expert on
    that block. Either way one all-reduce over the model axis completes
    y. Global dispatch over a batch cut over the data axes routes the
    whole batch, gathered (the reference's capacity is over all B·S
    tokens), and keeps the rank's rows.

    Under autograd the rank's work holds a part of two gradients, which
    enter the split layer (summed over the model axis): the tokens'
    through the expert products, and the router probabilities' through
    the gates of the rank's experts. The aux loss, which every rank
    computes whole, takes the probabilities as they are.
    """
    split = tp is not None and (params["w_up"].shape[-3] != cfg.n_experts
                                or params["w_down"].shape[-2] != cfg.d_ff)
    if cfg.moe_local_dispatch:
        rows = [_dispatch(params, cfg, x[i:i + 1], tp, split)
                for i in range(x.shape[0])]
        y, aux = (torch.cat([y for y, _ in rows]),
                  torch.stack([a for _, a in rows]).mean())
    elif tp is not None and tp.batch_group is not None:
        y, aux = _dispatch(params, cfg, tp.gather_batch(x), tp, split)
        y = tp.batch_rows(y)
    else:
        y, aux = _dispatch(params, cfg, x, tp, split)
    return (tp.all_reduce(y) if split else y), aux


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last dim, equal values
    in index order, as ``jax.lax.top_k`` breaks ties (``torch.topk`` breaks
    them in no stated order: identical tokens tie for an expert's
    capacity)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, cfg: ModelConfig, xf, enter=None):
    """Routing of the (N, d) tokens: (probs (N, E), gate_idx (N, k), the
    (N, E) combine weights, and each expert's top-C gates and tokens
    (E, C)). ``enter`` (a split layer's ``tp.enter``) takes the
    probabilities the gates are made of."""
    with _fp32_matmul(xf.device):
        logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (N, E)
    gated = probs if enter is None else enter(probs)
    gate_vals, gate_idx = _top_k(gated, cfg.top_k)              # (N, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    # (N, E) combine weights: the renormalised gate if selected, else 0
    combine = torch.zeros_like(gated).scatter(1, gate_idx, gate_vals)
    # capacity dispatch: each expert picks its top-C tokens by gate weight
    top_gate, top_tok = _top_k(combine.T, _capacity(xf.shape[0], cfg))
    return probs, gate_idx, combine, top_gate, top_tok


def _dispatch(params, cfg: ModelConfig, x, tp=None, split=False):
    """The layer over one routing group: (this rank's y, aux); its own
    experts only where they are a block of E (``tp``, expert-parallel).
    ``split``: the rank holds a part of the layer (the docstring of
    :func:`moe_ffn`)."""
    b, s, d = x.shape
    n, e = b * s, cfg.n_experts
    xf = x.reshape(n, d)
    probs, gate_idx, _, top_gate, top_tok = _route(
        params, cfg, xf, tp.enter if split else None)
    n_own = params["w_up"].shape[-3]
    lo = 0 if n_own == e else tp.index * n_own
    top_gate, top_tok = top_gate[lo:lo + n_own], top_tok[lo:lo + n_own]

    xs = tp.enter(xf) if split else xf
    xe = torch.stack([xs.index_select(0, top_tok[j]) for j in range(n_own)])
    ye = ffn_stacked(params, cfg, xe)                           # (E, C, d)
    ye = (ye * top_gate[..., None].to(ye.dtype)).to(xf.dtype)

    out = torch.zeros_like(xf)
    for j in range(n_own):   # expert order; no index repeats within a call
        out.index_add_(0, top_tok[j], ye[j])

    # Switch-style load-balance loss
    # the (N, E) selection indicator (the reference's one-hot summed over
    # k; a scatter, which also runs under torch.func.vmap)
    sel = torch.zeros_like(probs).scatter(1, gate_idx, 1.0)
    frac_tokens = sel.mean(0)                                   # f_e
    mean_prob = probs.mean(0)                                   # p_e
    aux = cfg.router_aux_coeff * e * torch.sum(frac_tokens * mean_prob)
    return out.reshape(b, s, d), aux
