"""The port's per-layer pattern of mixers (``config.PatternConfig``,
granite-4.0-h): each layer a published Mamba2 mixer
(``ssm.mamba2_mixer``) or a NoPE GQA attention mixer with its own
weights, every mixer followed by the SwiGLU MLP, each branch times
``residual_multiplier`` before its residual add, the embedding times
``embedding_multiplier``. ``models/model.py`` draws its parameters
(``_pattern_params``), divides its logits by ``logits_scaling`` and hands
its layers to this module: the full sequence (prefill, the serving
forward, the training route), one decode step and the cache's state.

Its parameters: ``blocks`` holds the Mamba2 layers stacked (their MLPs'
``ln2``/``mlp`` beside them), ``attn_blocks`` the attention layers
(``ln1``, ``attn``, ``ln2``, ``mlp``), in layer order each. Its decode
cache holds K/V for the attention layers beside conv tails of [x, B, C]
and fp32 states for the Mamba2 layers.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.config import LAYER_ATTENTION, PatternConfig
from repro_torch.models.layers import ffn, layer, rmsnorm
from repro_torch.obs.trace import NULL


def slots(cfg: PatternConfig) -> list:
    """(kind, index among the layers of its kind) of each layer."""
    seen: dict = {}
    out = []
    for kind in cfg.layer_types:
        out.append((kind, seen.get(kind, 0)))
        seen[kind] = seen.get(kind, 0) + 1
    return out


def _layer(cfg: PatternConfig, params, kind: str, j: int, x, impl=None,
           train=False, state=False, trace=NULL):
    """The j-th layer of ``kind`` over the full sequence: the pre-norm
    mixer, then the pre-norm MLP. Returns (x, the layer's cache entry):
    with ``state`` (prefill) (K, V) of an attention layer or (conv tail,
    final state) of a Mamba2 layer, else None. ``trace``: prefill's tracer
    (``prefill.attn`` or ``prefill.ssm`` around the mixer, ``prefill.mlp``
    around the MLP)."""
    r = cfg.residual_multiplier
    if kind == LAYER_ATTENTION:
        lp = layer(params["attn_blocks"], j)
        with trace.span("prefill.attn", "prefill"):
            q, k, v = attn.qkv(lp["attn"], cfg,
                               rmsnorm(x, lp["ln1"], cfg.norm_eps))
            a = attn.causal_attention(q, k, v, window=cfg.sliding_window,
                                      dtype=x.dtype, impl=impl, train=train,
                                      scale=cfg.softmax_scale)
            x = x + attn.out_proj(lp["attn"], a) * r
        entry = (k, v)
    else:
        lp = layer(params["blocks"], j)
        with trace.span("prefill.ssm", "prefill"):
            out, tail, h_final = ssm.mamba2_mixer(
                lp, cfg, rmsnorm(x, lp["ln"], cfg.norm_eps), impl, train,
                state)
            x = x + out * r
        entry = (tail, h_final)
    with trace.span("prefill.mlp", "prefill"):
        x = x + ffn(lp["mlp"], cfg, rmsnorm(x, lp["ln2"], cfg.norm_eps)) * r
    return x, entry if state else None


def run_layers(cfg: PatternConfig, params, x, impl=None, cached=True,
               trace=NULL):
    """Every layer over the full sequence from the looked-up embeddings x
    (B, S, d), as ``model._run_layers`` returns: (x, the attention layers'
    (K, V), the Mamba2 layers' (conv tail, final state), a zero aux loss);
    the two lists are empty unless ``cached``. No rotary tables."""
    kv, states = [], []
    x = x * cfg.embedding_multiplier
    for kind, j in slots(cfg):
        x, entry = _layer(cfg, params, kind, j, x, impl, state=cached,
                          trace=trace)
        if cached:
            (kv if kind == LAYER_ATTENTION else states).append(entry)
    return x, kv, states, torch.zeros((), dtype=torch.float32,
                                      device=x.device)


def train_layers(cfg: PatternConfig, params, x):
    """Every layer on the training route from the looked-up embeddings,
    each layer (mixer and MLP) under ``torch.utils.checkpoint`` where
    ``cfg.remat`` is set."""
    def body(h, kind, j):
        return _layer(cfg, params, kind, j, h, train=True)[0]

    x = x * cfg.embedding_multiplier
    for kind, j in slots(cfg):
        x = (checkpoint(body, x, kind, j, use_reentrant=False)
             if cfg.remat else body(x, kind, j))
    return x


def decode_layers(cfg: PatternConfig, params, cache, x, slot: int):
    """Every layer for one looked-up token x (B, 1, d), at ring slot
    ``slot`` of ``cache`` (``model.DecodeCache``, its ``slot_pos`` already
    holding the step); the cache's entries are written in place."""
    r = cfg.residual_multiplier
    x = x * cfg.embedding_multiplier
    valid = (cache.slot_pos >= 0)[None]                          # (1, W)
    for kind, j in slots(cfg):
        if kind == LAYER_ATTENTION:
            lp = layer(params["attn_blocks"], j)
            q, k, v = attn.qkv(lp["attn"], cfg,
                               rmsnorm(x, lp["ln1"], cfg.norm_eps))
            cache.k[j][:, slot] = k[:, 0].to(cache.k.dtype)
            cache.v[j][:, slot] = v[:, 0].to(cache.v.dtype)
            a = attn.decode_attention(q, cache.k[j], cache.v[j], valid,
                                      dtype=x.dtype, scale=cfg.softmax_scale)
            x = x + attn.out_proj(lp["attn"], a) * r
        else:
            lp = layer(params["blocks"], j)
            out, conv_j, ssm_j = ssm.mamba2_mixer_step(
                lp, cfg, rmsnorm(x[:, 0], lp["ln"], cfg.norm_eps),
                cache.conv[j], cache.ssm[j])
            cache.conv[j] = conv_j
            cache.ssm[j] = ssm_j
            x = x + out[:, None] * r
        x = x + ffn(lp["mlp"], cfg, rmsnorm(x, lp["ln2"], cfg.norm_eps)) * r
    return x


def state_shapes(cfg: PatternConfig, batch_size: int) -> dict:
    """The Mamba2 layers' cache shapes: ``conv`` the last K − 1 inputs
    [x, B, C], ``ssm`` the states (fp32); none without such a layer."""
    n = cfg.n_ssm_layers
    if not n:
        return {}
    return {"conv": (n, batch_size, cfg.ssm_conv - 1, cfg.conv_dim),
            "ssm": (n, batch_size, cfg.ssm_heads, cfg.mamba_headdim,
                    cfg.ssm_state)}
