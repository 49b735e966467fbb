"""Model assembly: parameter init, the forward pass, the LM loss and its
gradients, prefill and single-token decode with KV/SSM caches. The port of
the JAX package's ``models/model.py``.

Two routes through the layers:
  * serving (the default): prefill and forward on the kernels, the CUDA
    flash attention and selective scan on the card (``ops``);
  * training (``train=True`` on :func:`hidden_states`, :func:`forward`,
    :func:`lm_loss`): the reference trainer's autograd-friendly code, the
    naive or blockwise attention and the chunked scan in PyTorch on every
    device, with ``cfg.remat`` wrapping the bodies the reference wraps in
    ``jax.checkpoint`` in ``torch.utils.checkpoint``.

Layout conventions (the reference's, so weights convert leaf for leaf)
  * params["blocks"]: every per-layer tensor stacked with a leading
    n_layers axis; a Python loop over layers takes the place of
    ``lax.scan``;
  * logits are produced in the model dtype; the loss is taken in fp32.

Decode caches
  * attention: roped K/V ring buffer (L_attn, B, W, Hkv, hd) + a shared
    slot -> absolute position table (-1 = empty);
  * mamba1/2: conv tail (L, B, K-1, di) + fp32 SSM state.
  :func:`decode_step` writes the new K/V entries, conv tails and SSM
  states into the cache's tensors in place (the reference returns new
  arrays), so a decode step moves no more than its own entries.

Tensor parallelism (serving): ``prefill``, ``decode_step`` and
``init_cache`` take ``tp``, a ``distributed.sharding.TPContext`` (None:
one process, no collective). The params and the cache are then the rank's
shards over the ``model`` axis (``shard_params``), every count is read
from the local shapes, and each sharded dim is completed by the
collective GSPMD inserts in the reference: an all-reduce after each
row-parallel product (``wo``, ``w_down``, the MoE layer, Mamba's
``out_proj`` and mamba1's ``xp_*``) and of the fp32 Σx² of mamba2's
norm over a sharded d_inner, the vocab-parallel lookup's all-reduce and
the logits' all-gather; a replicated tensor takes none.

Tensor parallelism and parameter FSDP (training): ``hidden_states``,
``forward`` and ``lm_loss`` take ``tp`` on the training route too
(``distributed/trainer.py``'s mesh runtime). Every collective has its
backward (``TPContext``): the input of each column-parallel block enters
it (its gradient summed over the model axis), a sum consumed inside the
rank's shard sums its gradient too, and a leaf that stays whole but is
used inside the shard enters as well. The loss of vocab-parallel logits
is taken without gathering them (``TPContext.vocab_nll``). A leaf
sharded over FSDP axes comes as a ``sharding.FSDPLeaf`` and is gathered
where it is used: per layer inside the remat region, so the recompute
gathers it again and the gathered leaf is not kept.

Every block of the reference is ported: dense, MoE (``models/moe.py``;
the Switch auxiliary loss of each layer is summed into the aux term),
pure-SSM (mamba1, mamba2) and hybrid (mamba2 + one shared attention
block). Each entry takes token ids or, for the embedding-input models
(``embed_input=False``: qwen2-vl, musicgen; ``models/frontends.py`` draws
their stub inputs), ``embeds`` (B, S, d); explicit ``positions`` ((B, S),
or (3, B, S) for M-RoPE) shape only the rotary tables, as in the
reference, so serving attention stays on the flash kernel.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv1d, ffn, rmsnorm
from repro_torch.models.moe import moe_ffn

INIT_STD = 0.02


# ================================================================== init

class _MetaGen:
    """Stands in for a generator on the ``meta`` device, which draws
    nothing: :func:`abstract_params` builds shapes and dtypes only."""
    device = torch.device("meta")


def _dense(gen, shape, dtype, std=INIT_STD):
    if isinstance(gen, _MetaGen):
        return torch.empty(shape, dtype=dtype, device="meta")
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
    if cfg.block in ("dense", "moe"):
        p = {"ln1": _full((L, d), 1.0, dtype, dev),
             "ln2": _full((L, d), 1.0, dtype, dev),
             "attn": _attn_params(cfg, gen, dtype, (L,))}
        if cfg.block == "moe":   # experts stacked (L, E, ...), fp32 router
            p["mlp"] = _ffn_params(cfg, gen, dtype, (L, cfg.n_experts))
            p["mlp"]["router"] = _dense(gen, (L, d, cfg.n_experts), f32)
        else:
            p["mlp"] = _ffn_params(cfg, gen, dtype, (L,))
        return p
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
    device = resolve_device(device)
    return _params(cfg, torch.Generator(device=device).manual_seed(seed))


def abstract_params(cfg: ModelConfig) -> dict:
    """:func:`init_params`' tree on the ``meta`` device: every leaf's shape
    and dtype, no storage (the reference's ``abstract_params``)."""
    return _params(cfg, _MetaGen())


def _params(cfg: ModelConfig, gen) -> dict:
    cfg.validate()
    device = gen.device
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

def _mlp(lp, cfg: ModelConfig, h, tp=None):
    """The block's MLP: (y, aux), the MoE FFN with its auxiliary loss in a
    MoE block, else the dense FFN and a zero aux."""
    if cfg.block == "moe" and "router" in lp["mlp"]:
        return moe_ffn(lp["mlp"], cfg, h, tp)
    return ffn(lp["mlp"], cfg, h, tp), torch.zeros((), dtype=torch.float32,
                                                   device=h.device)


def _heads_tp(cfg: ModelConfig, q, tp):
    """``tp`` where the rank holds a block of the query heads (``wq``
    column-, ``wo`` row-parallel), else None."""
    return tp if tp is not None and q.shape[-2] != cfg.n_heads else None


def _attn_mlp_block(params, cfg: ModelConfig, x, cos, sin, impl=None,
                    train=False, tp=None):
    """Pre-norm attention + MLP over the full sequence; also returns the
    roped K and V (the decode cache's entries: the rank's KV heads, or all
    of them where ``wk``/``wv`` are replicated) and the MLP's aux loss."""
    h = rmsnorm(x, params["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv(params["attn"], cfg, h, tp)
    q = attn.apply_rope(q, cos, sin, cfg.rotary_pct)
    k = attn.apply_rope(k, cos, sin, cfg.rotary_pct)
    kq, vq = attn.local_kv(k, v, cfg, q.shape[-2], tp)
    a = attn.causal_attention(q, kq, vq, window=cfg.sliding_window,
                              dtype=x.dtype, impl=impl, train=train)
    x = x + attn.out_proj(params["attn"], a, _heads_tp(cfg, q, tp))
    y, aux = _mlp(params, cfg, rmsnorm(x, params["ln2"], cfg.norm_eps), tp)
    return x + y, k, v, aux


def _rope_tables(cfg: ModelConfig, positions, batch: int, seq: int, device):
    """cos/sin of the rotary embedding: M-RoPE from (3, B, S) positions
    (by default t = h = w = 0..S-1), else RoPE from (B, S) positions (by
    default 0..S-1, broadcast over the batch)."""
    if not cfg.has_attention:
        return None, None
    if cfg.mrope:
        if positions is None:
            base = torch.arange(seq, device=device)[None].expand(batch, seq)
            positions = torch.stack([base] * 3)                 # (3,B,S)
        return attn.mrope_angles(positions, cfg.hd, cfg.rope_theta,
                                 cfg.mrope_sections_)
    if positions is None:
        positions = torch.arange(seq, device=device)[None]      # (1,S) bcast
    return attn.rope_angles(positions, int(cfg.hd * cfg.rotary_pct),
                            cfg.rope_theta)


def _embed(cfg: ModelConfig, params, tokens, embeds, tp=None):
    """The input stream: token embeddings, or ``embeds`` in the model
    dtype. Where the rank holds a block of the vocab (``embed`` sharded
    over the model axis), it looks up the ids in its range, zeros the
    rest, and an all-reduce completes the rows: exact, as each token has
    one non-zero term."""
    if embeds is not None:
        return embeds.to(cfg.torch_dtype)
    table = _gathered(tp, params["embed"])
    if tp is None or table.shape[0] == cfg.vocab:
        return table[tokens]
    ids = tokens - tp.index * table.shape[0]
    own = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)]
    return tp.all_reduce(torch.where(own[..., None], rows, 0))


def _ssm_block_cached(lp, cfg: ModelConfig, x, impl=None, tp=None):
    """Run an SSM block over the full sequence and emit its decode state:
    (x + block(x), conv tail (B, K-1, di), final SSM state)."""
    xn = rmsnorm(x, lp["ln"], cfg.norm_eps)
    if cfg.block == "mamba1":
        xi = xn @ lp["in_x"]
        z = xn @ lp["in_z"]
        xc = torch.nn.functional.silu(
            causal_conv1d(xi, lp["conv_w"], lp["conv_b"]))
        out, h_final = ssm.mamba1_inner(lp, cfg, xc, z, return_state=True,
                                        impl=impl, tp=tp)
    else:  # mamba2
        z, xi, b_ssm, c_ssm, dt_raw = ssm._mamba2_split(lp, cfg, xn)
        xc = torch.nn.functional.silu(
            causal_conv1d(xi, lp["conv_w"], lp["conv_b"]))
        out, h_final = ssm.mamba2_inner(lp, cfg, xc, z, b_ssm, c_ssm,
                                        dt_raw, return_state=True, impl=impl,
                                        tp=tp)
    return x + out, xi[:, -(cfg.ssm_conv - 1):, :], h_final


def _run_layers(cfg: ModelConfig, params, x, impl=None, cached=True,
                positions=None, tp=None):
    """Every layer over the full sequence, in the reference's order (a
    hybrid's shared block after each stage of ``attn_every`` SSM layers).
    Returns x, the per-layer cache entries: lists of (K, V) for the
    attention layers and, where ``cached`` (prefill), of (conv tail, SSM
    state) for the SSM layers (the forward pass runs the plain
    ``mamba*_block`` instead, as the reference's does), and the aux loss
    summed over the layers. ``tp``: the rank's shards (``TPContext``)."""
    cos, sin = _rope_tables(cfg, positions, x.shape[0], x.shape[1],
                            x.device)
    kv, states = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block in ("dense", "moe"):
        for i in range(cfg.n_layers):
            x, k, v, a = _attn_mlp_block(layer(params["blocks"], i), cfg, x,
                                         cos, sin, impl, tp=tp)
            kv.append((k, v))
            aux = aux + a
        return x, kv, states, aux
    ssm_block = (ssm.mamba2_block if cfg.block == "mamba2"
                 else ssm.mamba1_block)
    for i in range(cfg.n_layers):
        lp = layer(params["blocks"], i)
        if cached:
            x, conv_tail, h_final = _ssm_block_cached(lp, cfg, x, impl, tp)
            states.append((conv_tail, h_final))
        else:
            x = ssm_block(lp, cfg, x, impl)
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            x, k, v, a = _attn_mlp_block(params["shared"], cfg, x, cos, sin,
                                         impl, tp=tp)
            kv.append((k, v))
            aux = aux + a
    return x, kv, states, aux


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``torch.utils.checkpoint`` where ``cfg.remat`` is set:
    its activations are recomputed in the backward pass, not kept."""
    if not cfg.remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _gathered(tp, tree):
    """A parameter (sub)tree with its FSDP leaves gathered (``tp``'s
    ``gather``); as it is without ``tp``."""
    return tree if tp is None else tp.gather(tree)


def _train_layers(cfg: ModelConfig, params, x, positions=None, tp=None):
    """Every layer on the training route, in the reference's order, with
    ``cfg.remat`` wrapping what the reference wraps in ``jax.checkpoint``:
    each dense or MoE block, each pure-SSM layer, and each SSM layer inside
    a hybrid stage (not the shared attention block). Returns x and the aux
    loss summed over the layers. Under ``tp`` a layer's FSDP leaves are
    gathered inside its checkpointed body."""
    cos, sin = _rope_tables(cfg, positions, x.shape[0], x.shape[1],
                            x.device)
    blocks = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block in ("dense", "moe"):
        def block(h, i):
            h, _, _, a = _attn_mlp_block(_gathered(tp, layer(blocks, i)),
                                         cfg, h, cos, sin, train=True,
                                         tp=tp)
            return h, a
        body = _remat(cfg, block)
        for i in range(cfg.n_layers):
            x, a = body(x, i)
            aux = aux + a
        return x, aux
    ssm_block = (ssm.mamba2_block if cfg.block == "mamba2"
                 else ssm.mamba1_block)
    body = _remat(cfg, lambda h, i: ssm_block(
        _gathered(tp, layer(blocks, i)), cfg, h, train=True, tp=tp))
    for i in range(cfg.n_layers):
        x = body(x, i)
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            x, _, _, a = _attn_mlp_block(_gathered(tp, params["shared"]),
                                         cfg, x, cos, sin, train=True, tp=tp)
            aux = aux + a
    return x, aux


def hidden_states(cfg: ModelConfig, params, tokens=None, impl=None,
                  train=False, *, embeds=None, positions=None, tp=None):
    """tokens (B, S) or ``embeds`` (B, S, d) -> final hidden states
    (B, S, d) and the aux loss (the MoE layers' summed). ``train`` takes
    the training route (module docstring); ``impl`` applies to the serving
    route's kernels; ``positions`` shape the rotary tables; ``tp``: the
    rank's shards (``TPContext``)."""
    x = _embed(cfg, params, tokens, embeds, tp)
    if train:
        x, aux = _train_layers(cfg, params, x, positions, tp)
    else:
        x, _, _, aux = _run_layers(cfg, params, x, impl, cached=False,
                                   positions=positions, tp=tp)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


def logits_fn(cfg: ModelConfig, params, hidden, tp=None):
    """hidden @ the output head (``embed.T`` where tied); where the rank
    holds a block of the vocab, the logits of the ranks' blocks are
    all-gathered over the model axis."""
    head = _head(cfg, params, tp)
    logits = hidden @ head
    if tp is not None and logits.shape[-1] != cfg.vocab:
        logits = tp.all_gather(logits, dim=-1)
    return logits


def _head(cfg: ModelConfig, params, tp=None):
    """The output head (d, V), or the rank's block (d, V/m) of it."""
    if cfg.tie_embeddings:
        return _gathered(tp, params["embed"]).T
    return _gathered(tp, params["lm_head"])


def forward(cfg: ModelConfig, params, tokens=None, impl=None, train=False,
            *, embeds=None, positions=None, tp=None):
    hidden, aux = hidden_states(cfg, params, tokens, impl, train,
                                embeds=embeds, positions=positions, tp=tp)
    return logits_fn(cfg, params, hidden, tp), aux


def lm_loss(cfg: ModelConfig, params, batch, impl=None, train=False,
            tp=None):
    """batch {"tokens": (B, S+1)} or {"embeds": (B, S, d), "labels":
    (B, S)}, each with optional "positions" -> (scalar loss, metrics): the
    mean next-token NLL in fp32 plus the aux loss. With ``train`` the
    forward takes the training route, whose every op has a gradient under
    autograd (the serving route's kernels have none). With ``tp`` (the
    rank's shards) logits of a vocab block stay the rank's: the hidden
    states enter the vocab-parallel head and ``tp.vocab_nll`` completes
    the NLL without gathering them."""
    positions = batch.get("positions")
    if "tokens" in batch:
        inputs, labels = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
        hidden, aux = hidden_states(cfg, params, inputs, impl, train,
                                    positions=positions, tp=tp)
    else:
        hidden, aux = hidden_states(cfg, params, None, impl, train,
                                    embeds=batch["embeds"],
                                    positions=positions, tp=tp)
        labels = batch["labels"]
    head = _head(cfg, params, tp)
    if tp is not None and head.shape[-1] != cfg.vocab:
        nll = tp.vocab_nll(tp.enter(hidden) @ head, labels)
    else:
        logp = torch.log_softmax((hidden @ head).float(), dim=-1)
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
               device=None, tp=None) -> DecodeCache:
    """An empty cache for ``batch_size`` sequences. With ``tp`` its fields
    take the rank's shapes on the model axis (``cache_pspecs``: the KV
    heads, or the ring's W where they do not divide; d_inner; the SSM
    heads); ``slot_pos`` stays whole."""
    device = resolve_device(device)
    w = cache_width(cfg, max_seq)
    shapes, dtypes = {}, {}
    if _n_attn_layers(cfg):
        shapes["k"] = shapes["v"] = (_n_attn_layers(cfg), batch_size, w,
                                     cfg.n_kv_heads, cfg.hd)
    if cfg.block in ("mamba1", "mamba2"):
        shapes["conv"] = (cfg.n_layers, batch_size, cfg.ssm_conv - 1,
                          cfg.d_inner)
        if cfg.block == "mamba1":
            shapes["ssm"] = (cfg.n_layers, batch_size, cfg.d_inner,
                             cfg.ssm_state)
        else:
            shapes["ssm"] = (cfg.n_layers, batch_size, cfg.ssm_heads,
                             cfg.mamba_headdim, cfg.ssm_state)
        dtypes["ssm"] = torch.float32
    if tp is not None:
        shapes = tp.local_cache_shapes(cfg, shapes)
    return DecodeCache(
        index=0,
        slot_pos=torch.full((max(w, 1),), -1, dtype=torch.int32,
                            device=device),
        **{name: torch.zeros(shape, dtype=dtypes.get(name, cfg.torch_dtype),
                             device=device)
           for name, shape in shapes.items()})


def _attn_decode_layer(lp, cfg: ModelConfig, x, k_c, v_c, slot, slot_pos,
                       cos, sin, tp=None):
    """x (B,1,d); k_c/v_c (B,W,Hkv,hd), written in place at ``slot``.

    Under ``tp`` with a ring sharded over W (the rank holds slots
    ``[lo, lo + W/m)`` of every KV head), the slot's owner writes it, the
    query heads are all-gathered, and :func:`attn.decode_attention`
    completes the softmax over the ranks; the rank then keeps its own
    heads' outputs for ``wo``."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv(lp["attn"], cfg, h)
    q = attn.apply_rope(q, cos, sin, cfg.rotary_pct)
    k = attn.apply_rope(k, cos, sin, cfg.rotary_pct)
    heads_tp = _heads_tp(cfg, q, tp)
    w_own = k_c.shape[1]
    valid = (slot_pos >= 0)[None]                              # (1, W)
    if w_own == slot_pos.shape[0]:
        k_c[:, slot] = k[:, 0].to(k_c.dtype)
        v_c[:, slot] = v[:, 0].to(v_c.dtype)
        kq, vq = attn.local_kv(k_c, v_c, cfg, q.shape[-2], tp)
        a = attn.decode_attention(q, kq, vq, valid, dtype=x.dtype)
    else:
        lo = tp.index * w_own
        if lo <= slot < lo + w_own:
            k_c[:, slot - lo] = k[:, 0].to(k_c.dtype)
            v_c[:, slot - lo] = v[:, 0].to(v_c.dtype)
        hq = q.shape[-2]
        if heads_tp is not None:
            q = tp.all_gather(q, dim=2)
        a = attn.decode_attention(q, k_c, v_c, valid[:, lo:lo + w_own],
                                  dtype=x.dtype, tp=tp)
        if heads_tp is not None:
            a = a[:, :, tp.index * hq:(tp.index + 1) * hq]
    x = x + attn.out_proj(lp["attn"], a, heads_tp)
    y, _ = _mlp(lp, cfg, rmsnorm(x, lp["ln2"], cfg.norm_eps), tp)
    return x + y


def decode_step(cfg: ModelConfig, params, cache: DecodeCache, tokens=None,
                *, embeds=None, tp=None):
    """One decode step for the whole batch. tokens (B,) or ``embeds``
    (B, 1, d). Returns (logits (B, V), the cache at index + 1). The cache's
    tensors are updated in place (see the module docstring). Every axis of
    an M-RoPE position is the step's index, as in the reference. With
    ``tp`` the params and cache are the rank's shards
    (``distributed/serving.py``) and the logits come back whole."""
    x = _embed(cfg, params, None if tokens is None else tokens[:, None],
               embeds, tp)                                  # (B,1,d)
    idx = cache.index
    w = cache.slot_pos.shape[0]
    slot = idx % w
    cos = sin = None
    pos = torch.full((1, 1), idx, dtype=torch.int32, device=x.device)
    if cfg.mrope:
        cos, sin = attn.mrope_angles(pos[None].expand(3, 1, 1), cfg.hd,
                                     cfg.rope_theta, cfg.mrope_sections_)
    elif cfg.has_attention:
        cos, sin = attn.rope_angles(pos, int(cfg.hd * cfg.rotary_pct),
                                    cfg.rope_theta)
    cache.slot_pos[slot] = idx     # as the reference, a pure SSM's 1 slot too

    if cfg.block in ("dense", "moe"):
        for i in range(cfg.n_layers):
            x = _attn_decode_layer(layer(params["blocks"], i), cfg, x,
                                   cache.k[i], cache.v[i], slot,
                                   cache.slot_pos, cos, sin, tp)
    else:
        dec = ssm.mamba2_decode if cfg.block == "mamba2" else \
            ssm.mamba1_decode
        for i in range(cfg.n_layers):
            y, conv_i, ssm_i = dec(layer(params["blocks"], i), cfg, x[:, 0],
                                   cache.conv[i], cache.ssm[i], tp)
            cache.conv[i] = conv_i
            cache.ssm[i] = ssm_i
            x = y[:, None]
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
                j = i // cfg.attn_every
                x = _attn_decode_layer(params["shared"], cfg, x, cache.k[j],
                                       cache.v[j], slot, cache.slot_pos,
                                       cos, sin, tp)

    hidden = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params, hidden, tp)[:, 0]
    return logits, cache._replace(index=idx + 1)


# ================================================================ prefill

def prefill(cfg: ModelConfig, params, tokens=None,
            max_seq: int | None = None, impl=None, *, embeds=None,
            positions=None, tp=None):
    """Full-sequence forward that also builds the decode cache, from
    tokens (B, S) or ``embeds`` (B, S, d); ``positions`` shape the rotary
    tables. With ``tp`` the params are the rank's shards, the cache is
    built in the rank's shapes (:func:`init_cache`) and the logits come
    back whole.

    Returns (last-token logits (B, V), DecodeCache primed at index = S).
    """
    x = _embed(cfg, params, tokens, embeds, tp)
    b, s = x.shape[:2]
    device = x.device
    max_seq = max_seq or s
    cache = init_cache(cfg, b, max_seq, device=device, tp=tp)
    w = cache.slot_pos.shape[0]
    # the rank's slots where the ring is sharded over W
    lo, w_own = 0, w if cache.k is None else cache.k.shape[2]
    if w_own != w:
        lo = tp.index * w_own

    def to_ring(t):  # (B, S, Hkv, hd) -> the last W entries in ring order
        tail = t[:, -w:]
        if s >= w:
            ring = torch.roll(tail, s % w, dims=1)
        else:
            ring = torch.nn.functional.pad(tail, (0, 0, 0, 0, 0, w - s))
        return ring[:, lo:lo + w_own]

    x, kv, states, _ = _run_layers(cfg, params, x, impl,
                                   positions=positions, tp=tp)
    for j, (k, v) in enumerate(kv):
        cache.k[j] = to_ring(k)
        cache.v[j] = to_ring(v)
    for i, (conv_tail, h_final) in enumerate(states):
        cache.conv[i] = conv_tail
        cache.ssm[i] = h_final
    filled = torch.arange(max(s - w, 0), s, device=device)
    slots = filled % w if s >= w else torch.arange(min(s, w), device=device)
    cache.slot_pos[slots] = filled.to(torch.int32)

    hidden = rmsnorm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = logits_fn(cfg, params, hidden, tp)[:, 0]
    return logits, cache._replace(index=s)

