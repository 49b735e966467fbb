"""The benchmark's plain reference of granite-4.0-h (``model_type``
granitemoehybrid, no experts), the yardstick of
``serve.granite-4.0-h-micro.prefill``: the published forward pass in
float32 with TF32 off (``reference.no_tf32``), from its equations alone.
It imports nothing of the port and takes no tensor the program made; it
reads the parameters by the leaf paths the benchmark draws them under
(``bench/weights.py``: ``blocks/...`` the Mamba2 layers stacked, each
with its MLP; ``attn_blocks/...`` the attention layers), upcast to
float32. The CPU tests hold the port's pattern path to it too
(``tests/test_torch_granite_h.py``, over the port's parameter tree
flattened to these paths):

  x = embed[tokens] · embedding_multiplier
  per layer: x = x + mixer(rmsnorm(x)) · r, then x = x + mlp(rmsnorm(x)) · r
  logits = rmsnorm(x) @ embedᵀ / logits_scaling

The mixers: GQA attention without rotary embeddings (NoPE), scores times
``attn_scale``; the published Mamba2 mixer, its causal conv over [x, B,
C], Δ = softplus(Δ + dt_bias), A = −exp(A_log), the scan per head, the D
skip and the gated RMSNorm of y·silu(z). The scan is exact, in chunks of
``CHUNK`` steps with the state carried, so that 8,192 tokens fit.

:class:`Variant` holds what a control or a fault changes: ``num`` the
products (``reference.Numerics``: fp8 operands), ``state_bf16`` the scan's
carried state rounded to bf16 at every chunk, ``conv_bc`` False leaves B
and C as projected (the conv over x alone, as the JAX package's Mamba2),
``scale`` another softmax scale.

Departures from the published model, none of them in the mathematics:
the in-projection as five products, the MLP's ``input_linear`` as two and
q, k, v as three, where the checkpoint packs each into one matrix.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from bench.reference import FP32, Numerics, layer, rmsnorm

CHUNK = 256     # the published mamba_chunk_size


@dataclass(frozen=True)
class Variant:
    num: Numerics = FP32
    state_bf16: bool = False
    conv_bc: bool = True
    scale: float | None = None


PLAIN = Variant()


def _sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def mlp(h, p, num: Numerics):
    return num.mm(F.silu(num.mm(h, p["w_gate"])) * num.mm(h, p["w_up"]),
                  p["w_down"])


def attention(h, p, m: dict, v: Variant, block: int = 2048):
    """Causal GQA self-attention of h (B, S, d), no rotary embedding,
    formed ``block`` queries at a time."""
    b, s, _ = h.shape
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    scale = v.scale if v.scale is not None else m["attn_scale"]
    num = v.num
    q = num.mm(h, p["wq"]).reshape(b, s, hq, hd)
    k = num.mm(h, p["wk"]).reshape(b, s, hkv, hd)
    val = num.mm(h, p["wv"]).reshape(b, s, hkv, hd)
    k = k.repeat_interleave(hq // hkv, dim=2)
    val = val.repeat_interleave(hq // hkv, dim=2)
    outs = []
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        scores = num.einsum("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, :q1]) * scale
        causal = torch.ones(q1 - q0, q1, dtype=torch.bool,
                            device=h.device).tril(q0)
        probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
        outs.append(num.einsum("bhqk,bkhd->bqhd", probs, val[:, :q1]))
    return num.mm(torch.cat(outs, 1).reshape(b, s, hq * hd), p["wo"])


def causal_conv(u, w, bias):
    """Depthwise causal conv of u (B, S, C) with taps w (K, C) and a bias."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    return sum(pad[:, j:j + s] * w[j] for j in range(k)) + bias


def ssd_scan(x, dt, a, bm, cm, v: Variant, chunk: int = CHUNK):
    """The Mamba2 scan from a zero state, exactly, in chunks: x (B, S, H,
    P), dt (B, S, H), a (H,), bm, cm (B, S, N) -> y (B, S, H, P)."""
    bsz, s, nh, p = x.shape
    num = v.num
    h = torch.zeros(bsz, nh, p, bm.shape[-1], dtype=x.dtype, device=x.device)
    ys = []
    for lo in range(0, s, chunk):
        xs, dts = x[:, lo:lo + chunk], dt[:, lo:lo + chunk]
        bs, cs_ = bm[:, lo:lo + chunk], cm[:, lo:lo + chunk]
        n = xs.shape[1]
        cs = torch.cumsum(dts * a, dim=1)                       # (B, L, H)
        causal = torch.ones(n, n, dtype=torch.bool,
                            device=x.device).tril()[None, :, :, None]
        diff = cs[:, :, None, :] - cs[:, None, :, :]            # (B, t, s, H)
        decay = torch.exp(diff.masked_fill(~causal, -math.inf))
        g = num.einsum("btn,bsn->bts", cs_, bs)
        y = num.einsum("btsh,bshp->bthp", g[..., None] * decay * dts[:, None],
                       xs)
        y = y + num.einsum("btn,bhpn->bthp", cs_, h) \
            * torch.exp(cs)[..., None]
        w = torch.exp(cs[:, -1:] - cs) * dts                    # (B, L, H)
        h = h * torch.exp(cs[:, -1])[:, :, None, None] \
            + num.einsum("bshp,bsn->bhpn", w[..., None] * xs, bs)
        if v.state_bf16:
            h = h.to(torch.bfloat16).float()
        ys.append(y)
    return torch.cat(ys, 1)


def mamba2(h, p, m: dict, v: Variant):
    """The published Mamba2 mixer of h (B, S, d)."""
    b, s, _ = h.shape
    di, n, hd = m["ssm_expand"] * m["d_model"], m["ssm_state"], \
        m["mamba_headdim"]
    num = v.num
    z = num.mm(h, p["in_z"])
    x, bm, cm = (num.mm(h, p[k]) for k in ("in_x", "in_b", "in_c"))
    xbc = F.silu(causal_conv(torch.cat([x, bm, cm], -1), p["conv_w"],
                             p["conv_b"]))
    if v.conv_bc:
        x, bm, cm = xbc.split([di, n, n], -1)
    else:
        x = xbc[..., :di]
    dt = F.softplus(num.mm(h, p["in_dt"]) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xh = x.reshape(b, s, di // hd, hd)
    y = ssd_scan(xh, dt, a, bm, cm, v) + p["D"][:, None] * xh
    y = rmsnorm(y.reshape(b, s, di) * F.silu(z), p["out_norm"],
                m["norm_eps"])
    return num.mm(y, p["out_proj"])


def hidden(params: dict, m: dict, tokens, v: Variant = PLAIN):
    """The final-normed hidden states (B, S, d) of ``tokens`` (B, S)."""
    eps, r = m["norm_eps"], m["residual_multiplier"]
    x = params["embed"].float()[tokens] * m["embedding_multiplier"]
    seen = {"mamba2": 0, "attention": 0}
    for kind in m["layer_types"]:
        j = seen[kind]
        seen[kind] += 1
        if kind == "attention":
            p = layer(params, "attn_blocks/", j)
            x = x + attention(rmsnorm(x, p["ln1"], eps), _sub(p, "attn/"), m,
                              v) * r
        else:
            p = layer(params, "blocks/", j)
            x = x + mamba2(rmsnorm(x, p["ln"], eps), p, m, v) * r
        x = x + mlp(rmsnorm(x, p["ln2"], eps), _sub(p, "mlp/"), v.num) * r
    return rmsnorm(x, params["final_norm"].float(), eps)


def _head(params: dict, m: dict, x, v: Variant):
    """The tied head over ``logits_scaling``."""
    return v.num.mm(x, params["embed"].float().T) / m["logits_scaling"]


def last_logits(params: dict, m: dict, tokens, v: Variant = PLAIN):
    """Logits (B, V) at the last position of ``tokens`` (B, S)."""
    return _head(params, m, hidden(params, m, tokens, v)[:, -1], v)


def logits(params: dict, m: dict, tokens, v: Variant = PLAIN):
    """Logits (B, S, V) at every position of ``tokens`` (B, S)."""
    return _head(params, m, hidden(params, m, tokens, v), v)


def loss(params: dict, m: dict, tokens, v: Variant = PLAIN):
    """Mean next-token cross entropy of ``tokens`` (B, S + 1)."""
    lg = logits(params, m, tokens[:, :-1], v)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           tokens[:, 1:].reshape(-1))
