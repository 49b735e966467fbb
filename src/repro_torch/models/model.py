"""Model assembly for serving: parameter init, the forward pass, the LM
loss (forward only), prefill and single-token decode with KV/SSM caches.
The port of the JAX package's ``models/model.py``.

Layout conventions (the reference's, so weights convert leaf for leaf)
  * params["blocks"]: every per-layer tensor stacked with a leading
    n_layers axis; a Python loop over layers takes the place of
    ``lax.scan`` (and ``remat`` has no meaning without gradients);
  * logits are produced in the model dtype; the loss is taken in fp32.

Decode caches
  * attention: roped K/V ring buffer (L_attn, B, W, Hkv, hd) + a shared
    slot -> absolute position table (-1 = empty);
  * mamba1/2: conv tail (L, B, K-1, di) + fp32 SSM state.
  :func:`decode_step` writes the new K/V entries, conv tails and SSM
  states into the cache's tensors in place (the reference returns new
  arrays), so a decode step moves no more than its own entries.

Dense, pure-SSM (mamba1, mamba2) and hybrid (mamba2 + one shared attention
block) models are ported. ``block="moe"``, ``mrope`` and
``embed_input=False`` raise NotImplementedError: they come with the MoE/VLM
slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv1d, ffn, rmsnorm

INIT_STD = 0.02


def check_ported(cfg: ModelConfig) -> None:
    """Raises NotImplementedError, by name, on the parts of a config that
    the port does not run yet."""
    missing = [what for what, on in (("block='moe'", cfg.block == "moe"),
                                     ("mrope", cfg.mrope),
                                     ("embed_input=False",
                                      not cfg.embed_input)) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (they come "
            "with the MoE/VLM slice)")


# ================================================================== init

def _dense(gen, shape, dtype, std=INIT_STD):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * std).to(dtype)


def _full(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


def _attn_params(cfg: ModelConfig, gen, dtype, lead=()):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": _dense(gen, lead + (d, hq * hd), dtype),
            "wk": _dense(gen, lead + (d, hkv * hd), dtype),
            "wv": _dense(gen, lead + (d, hkv * hd), dtype),
            "wo": _dense(gen, lead + (hq * hd, d), dtype)}


def _ffn_params(cfg: ModelConfig, gen, dtype, lead=()):
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_up": _dense(gen, lead + (d, ff), dtype),
         "w_down": _dense(gen, lead + (ff, d), dtype)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["w_gate"] = _dense(gen, lead + (d, ff), dtype)
    return p


def _block_params(cfg: ModelConfig, gen, dtype):
    """Every block's tensors, stacked over the n_layers axis."""
    L, d, dev = cfg.n_layers, cfg.d_model, gen.device
    f32 = torch.float32
    if cfg.block == "dense":
        return {"ln1": _full((L, d), 1.0, dtype, dev),
                "ln2": _full((L, d), 1.0, dtype, dev),
                "attn": _attn_params(cfg, gen, dtype, (L,)),
                "mlp": _ffn_params(cfg, gen, dtype, (L,))}
    if cfg.block == "mamba1":
        di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
        a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=dev))
        return {
            "ln": _full((L, d), 1.0, dtype, dev),
            "in_x": _dense(gen, (L, d, di), dtype),
            "in_z": _dense(gen, (L, d, di), dtype),
            "conv_w": _dense(gen, (L, cfg.ssm_conv, di), f32, 0.1),
            "conv_b": _full((L, di), 0.0, f32, dev),
            "xp_dt": _dense(gen, (L, di, r), dtype),
            "xp_b": _dense(gen, (L, di, n), dtype),
            "xp_c": _dense(gen, (L, di, n), dtype),
            "dt_proj": _dense(gen, (L, r, di), f32, 1.0 / r ** 0.5),
            "dt_bias": _full((L, di), -4.0, f32, dev),
            "A_log": a_log.expand(L, di, n).clone(),
            "D": _full((L, di), 1.0, f32, dev),
            "out_proj": _dense(gen, (L, di, d), dtype),
        }
    if cfg.block == "mamba2":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        return {
            "ln": _full((L, d), 1.0, dtype, dev),
            "in_z": _dense(gen, (L, d, di), dtype),
            "in_x": _dense(gen, (L, d, di), dtype),
            "in_b": _dense(gen, (L, d, n), dtype),
            "in_c": _dense(gen, (L, d, n), dtype),
            "in_dt": _dense(gen, (L, d, h), dtype),
            "conv_w": _dense(gen, (L, cfg.ssm_conv, di), f32, 0.1),
            "conv_b": _full((L, di), 0.0, f32, dev),
            "dt_bias": _full((L, h), -4.0, f32, dev),
            "A_log": _full((L, h), 0.0, f32, dev),
            "D": _full((L, h), 1.0, f32, dev),
            "out_norm": _full((L, di), 1.0, dtype, dev),
            "out_proj": _dense(gen, (L, di, d), dtype),
        }
    raise ValueError(cfg.block)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random weights by the reference's init (normal, std 0.02; the SSM's
    A_log, dt_bias = -4, D = 1, norms 1), drawn on ``device`` (None: the
    card) from ``seed`` with an explicit ``torch.Generator``. The draws are
    not the reference's ``jax.random`` bits; tests convert the reference's
    own parameters with ``repro_torch.convert.lm_params_from_numpy``."""
    cfg.validate()
    check_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = cfg.torch_dtype
    params = {"embed": _dense(gen, (cfg.vocab, cfg.d_model), dtype),
              "blocks": _block_params(cfg, gen, dtype),
              "final_norm": _full((cfg.d_model,), 1.0, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(gen, (cfg.d_model, cfg.vocab), dtype)
    if cfg.attn_every:  # zamba2-style single shared attention+MLP block
        params["shared"] = {
            "ln1": _full((cfg.d_model,), 1.0, dtype, device),
            "ln2": _full((cfg.d_model,), 1.0, dtype, device),
            "attn": _attn_params(cfg, gen, dtype),
            "mlp": _ffn_params(cfg, gen, dtype),
        }
    return params


def layer(blocks: dict, i: int) -> dict:
    """Layer ``i``'s parameters: a view into every stacked tensor."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ================================================================ forward

def _attn_mlp_block(params, cfg: ModelConfig, x, cos, sin, impl=None):
    """Pre-norm attention + MLP over the full sequence; also returns the
    roped K and V (the decode cache's entries)."""
    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv(params["attn"], cfg, h)
    q = attn.apply_rope(q, cos, sin, cfg.rotary_pct)
    k = attn.apply_rope(k, cos, sin, cfg.rotary_pct)
    a = attn.causal_attention(q, k, v, window=cfg.sliding_window,
                              dtype=x.dtype, impl=impl)
    x = x + attn.out_proj(params["attn"], a)
    h2 = rmsnorm(x, params["ln2"], cfg.norm_eps)
    return x + ffn(params["mlp"], cfg, h2), k, v


def _rope_tables(cfg: ModelConfig, seq: int, device):
    if not cfg.has_attention:
        return None, None
    positions = torch.arange(seq, device=device)[None]         # (1,S) bcast
    return attn.rope_angles(positions, int(cfg.hd * cfg.rotary_pct),
                            cfg.rope_theta)


def _ssm_block_cached(lp, cfg: ModelConfig, x, impl=None):
    """Run an SSM block over the full sequence and emit its decode state:
    (x + block(x), conv tail (B, K-1, di), final SSM state)."""
    xn = rmsnorm(x, lp["ln"], cfg.norm_eps)
    if cfg.block == "mamba1":
        xi = xn @ lp["in_x"]
        z = xn @ lp["in_z"]
        xc = torch.nn.functional.silu(
            causal_conv1d(xi, lp["conv_w"], lp["conv_b"]))
        out, h_final = ssm.mamba1_inner(lp, cfg, xc, z, return_state=True,
                                        impl=impl)
    else:  # mamba2
        z, xi, b_ssm, c_ssm, dt_raw = ssm._mamba2_split(lp, cfg, xn)
        xc = torch.nn.functional.silu(
            causal_conv1d(xi, lp["conv_w"], lp["conv_b"]))
        out, h_final = ssm.mamba2_inner(lp, cfg, xc, z, b_ssm, c_ssm,
                                        dt_raw, return_state=True, impl=impl)
    return x + out, xi[:, -(cfg.ssm_conv - 1):, :], h_final


def _run_layers(cfg: ModelConfig, params, x, impl=None, cached=True):
    """Every layer over the full sequence, in the reference's order (a
    hybrid's shared block after each stage of ``attn_every`` SSM layers).
    Returns x and the per-layer cache entries: lists of (K, V) for the
    attention layers and, where ``cached`` (prefill), of (conv tail, SSM
    state) for the SSM layers; the forward pass runs the plain
    ``mamba*_block`` instead, as the reference's does."""
    cos, sin = _rope_tables(cfg, x.shape[1], x.device)
    kv, states = [], []
    if cfg.block == "dense":
        for i in range(cfg.n_layers):
            x, k, v = _attn_mlp_block(layer(params["blocks"], i), cfg, x,
                                      cos, sin, impl)
            kv.append((k, v))
        return x, kv, states
    ssm_block = (ssm.mamba2_block if cfg.block == "mamba2"
                 else ssm.mamba1_block)
    for i in range(cfg.n_layers):
        lp = layer(params["blocks"], i)
        if cached:
            x, conv_tail, h_final = _ssm_block_cached(lp, cfg, x, impl)
            states.append((conv_tail, h_final))
        else:
            x = ssm_block(lp, cfg, x, impl)
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            x, k, v = _attn_mlp_block(params["shared"], cfg, x, cos, sin,
                                      impl)
            kv.append((k, v))
    return x, kv, states


def hidden_states(cfg: ModelConfig, params, tokens, impl=None):
    """tokens (B, S) -> final hidden states (B, S, d) and the aux loss (0:
    no MoE router is ported)."""
    check_ported(cfg)
    x, _, _ = _run_layers(cfg, params, params["embed"][tokens], impl,
                          cached=False)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def logits_fn(cfg: ModelConfig, params, hidden):
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    return hidden @ head


def forward(cfg: ModelConfig, params, tokens, impl=None):
    hidden, aux = hidden_states(cfg, params, tokens, impl)
    return logits_fn(cfg, params, hidden), aux


def lm_loss(cfg: ModelConfig, params, batch, impl=None):
    """batch {"tokens": (B, S+1)} -> (scalar loss, metrics): the mean
    next-token NLL in fp32 (forward only)."""
    inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    logits, aux = forward(cfg, params, inputs, impl)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss = torch.mean(nll)
    return loss + aux, {"nll": loss, "aux": aux}


# ================================================================= decode

class DecodeCache(NamedTuple):
    """Cache for lock-step batched decode at absolute position ``index`` (a
    Python int). Attention K/V are stored ALREADY roped; ``slot_pos`` maps
    ring slots to absolute positions (-1 = empty)."""
    index: int
    slot_pos: torch.Tensor      # (W,) int32
    k: Any = None               # (L_attn, B, W, Hkv, hd)
    v: Any = None
    conv: Any = None            # (L_ssm, B, K-1, di)
    ssm: Any = None             # (L_ssm, B, ...) fp32


def cache_width(cfg: ModelConfig, max_seq: int) -> int:
    if not cfg.has_attention:
        return 0
    return min(cfg.sliding_window or max_seq, max_seq)


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.block in ("dense", "moe"):
        return cfg.n_layers
    if cfg.attn_every:
        return cfg.n_layers // cfg.attn_every
    return 0


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               device=None) -> DecodeCache:
    check_ported(cfg)
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    w = cache_width(cfg, max_seq)
    la = _n_attn_layers(cfg)
    k = v = conv = state = None
    if la:
        shape = (la, batch_size, w, cfg.n_kv_heads, cfg.hd)
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.block in ("mamba1", "mamba2"):
        conv = torch.zeros((cfg.n_layers, batch_size, cfg.ssm_conv - 1,
                            cfg.d_inner), dtype=dtype, device=device)
        if cfg.block == "mamba1":
            sshape = (cfg.n_layers, batch_size, cfg.d_inner, cfg.ssm_state)
        else:
            sshape = (cfg.n_layers, batch_size, cfg.ssm_heads,
                      cfg.mamba_headdim, cfg.ssm_state)
        state = torch.zeros(sshape, dtype=torch.float32, device=device)
    return DecodeCache(
        index=0,
        slot_pos=torch.full((max(w, 1),), -1, dtype=torch.int32,
                            device=device),
        k=k, v=v, conv=conv, ssm=state)


def _attn_decode_layer(lp, cfg: ModelConfig, x, k_c, v_c, slot, slot_pos,
                       cos, sin):
    """x (B,1,d); k_c/v_c (B,W,Hkv,hd), written in place at ``slot``."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv(lp["attn"], cfg, h)
    q = attn.apply_rope(q, cos, sin, cfg.rotary_pct)
    k = attn.apply_rope(k, cos, sin, cfg.rotary_pct)
    k_c[:, slot] = k[:, 0].to(k_c.dtype)
    v_c[:, slot] = v[:, 0].to(v_c.dtype)
    valid = (slot_pos >= 0)[None]                              # (1, W)
    a = attn.decode_attention(q, k_c, v_c, valid, dtype=x.dtype)
    x = x + attn.out_proj(lp["attn"], a)
    h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + ffn(lp["mlp"], cfg, h2)


def decode_step(cfg: ModelConfig, params, cache: DecodeCache, tokens):
    """One decode step for the whole batch. tokens (B,). Returns
    (logits (B, V), the cache at index + 1). The cache's tensors are
    updated in place (see the module docstring)."""
    check_ported(cfg)
    x = params["embed"][tokens][:, None, :]                   # (B,1,d)
    idx = cache.index
    w = cache.slot_pos.shape[0]
    slot = idx % w
    cos = sin = None
    if cfg.has_attention:
        cos, sin = attn.rope_angles(
            torch.full((1, 1), idx, dtype=torch.int32, device=x.device),
            int(cfg.hd * cfg.rotary_pct), cfg.rope_theta)
    cache.slot_pos[slot] = idx     # as the reference, a pure SSM's 1 slot too

    if cfg.block == "dense":
        for i in range(cfg.n_layers):
            x = _attn_decode_layer(layer(params["blocks"], i), cfg, x,
                                   cache.k[i], cache.v[i], slot,
                                   cache.slot_pos, cos, sin)
    else:
        dec = ssm.mamba2_decode if cfg.block == "mamba2" else \
            ssm.mamba1_decode
        for i in range(cfg.n_layers):
            y, conv_i, ssm_i = dec(layer(params["blocks"], i), cfg, x[:, 0],
                                   cache.conv[i], cache.ssm[i])
            cache.conv[i] = conv_i
            cache.ssm[i] = ssm_i
            x = y[:, None]
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                j = i // cfg.attn_every
                x = _attn_decode_layer(params["shared"], cfg, x, cache.k[j],
                                       cache.v[j], slot, cache.slot_pos,
                                       cos, sin)

    hidden = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params, hidden)[:, 0]
    return logits, cache._replace(index=idx + 1)


# ================================================================ prefill

def prefill(cfg: ModelConfig, params, tokens, max_seq: int | None = None,
            impl=None):
    """Full-sequence forward that also builds the decode cache.

    Returns (last-token logits (B, V), DecodeCache primed at index = S).
    """
    check_ported(cfg)
    b, s = tokens.shape
    max_seq = max_seq or s
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    w = cache.slot_pos.shape[0]

    def to_ring(t):  # (B, S, Hkv, hd) -> the last W entries in ring order
        tail = t[:, -w:]
        if s >= w:
            return torch.roll(tail, s % w, dims=1)
        return torch.nn.functional.pad(tail, (0, 0, 0, 0, 0, w - s))

    x, kv, states = _run_layers(cfg, params, params["embed"][tokens], impl)
    for j, (k, v) in enumerate(kv):
        cache.k[j] = to_ring(k)
        cache.v[j] = to_ring(v)
    for i, (conv_tail, h_final) in enumerate(states):
        cache.conv[i] = conv_tail
        cache.ssm[i] = h_final
    positions = torch.arange(max(s - w, 0), s, device=tokens.device)
    slots = positions % w if s >= w else torch.arange(
        min(s, w), device=tokens.device)
    cache.slot_pos[slots] = positions.to(torch.int32)

    hidden = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params, hidden)[:, 0]
    return logits, cache._replace(index=s)

