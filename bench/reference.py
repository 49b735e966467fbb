"""The plain reference: the cells' models written out in plain PyTorch,
independent of the program (it imports nothing of ``repro_torch`` and
takes no tensor the program made), in float32 with TF32 off.

A pre-norm dense decoder (RMSNorm, rotary embeddings on all or part of
each head, causal attention with grouped K/V heads, a SwiGLU MLP, an
untied head):

  * :func:`dense_loss`: the mean next-token cross entropy of (B, S + 1)
    token rows (training);
  * :func:`dense_last_logits`: the logits at the last position of (B, S)
    token rows (the first served token).

Both read the parameters by the leaf paths the benchmark draws them under
(``bench/weights.py``), upcast to float32.

:class:`Numerics` holds the one thing the control changes: with ``fp8``
every product's operands (each projection, the attention products, the
head) are rounded to fp8 with a per-tensor scale, e4m3 forward and e5m2
for the gradients, as an fp8 training or serving path would compute
them; elementwise work stays in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def no_tf32() -> None:
    """float32 products in float32 (TF32 off), for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to fp8 under a per-tensor scale (amax to the format's
    largest value), returned in float32."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = FP8_MAX[dtype] / amax
    return (t.float() * scale).to(dtype).float() / scale


class _FP8Product(torch.autograd.Function):
    """``torch.einsum(eq, a, b)`` on fp8-rounded operands, its backward on
    fp8-rounded (e5m2) gradients."""

    @staticmethod
    def forward(ctx, eq, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        ctx.eq = eq
        return torch.einsum(eq, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        ins, out = ctx.eq.split("->")
        sa, sb = ins.split(",")
        qg = fp8_round(g, torch.float8_e5m2)
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = torch.einsum(f"{out},{sb}->{sa}", qg, qb)
        if ctx.needs_input_grad[2]:
            gb = torch.einsum(f"{sa},{out}->{sb}", qa, qg)
        return None, ga, gb


class Numerics:
    """How the reference computes its products: float32 (``fp8=False``),
    or the fp8 control."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def einsum(self, eq: str, a, b):
        if self.fp8:
            return _FP8Product.apply(eq, a, b)
        return torch.einsum(eq, a, b)

    def mm(self, x, w):
        """x (..., k) @ w (k, n)."""
        if self.fp8:
            lead = x.shape[:-1]
            y = _FP8Product.apply("ik,kn->in", x.reshape(-1, x.shape[-1]), w)
            return y.reshape(*lead, w.shape[-1])
        return x @ w


FP32 = Numerics()


# ------------------------------------------------------------ shared parts

def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope_tables(seq: int, rot: int, theta: float, device):
    half = rot // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / half))
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    ang = pos[:, None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x, cos, sin, rot: int):
    """x (B, S, H, hd): the first ``rot`` dims of each head rotate, as two
    halves (x1, x2) -> (x1 cos − x2 sin, x2 cos + x1 sin)."""
    if rot == 0:
        return x
    half = rot // 2
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)


def attention(x, p, m: dict, cos, sin, num: Numerics, block: int = 2048):
    """Causal multi-head self-attention of x (B, S, d) with the weights
    ``p`` (wq, wk, wv, wo); grouped heads share K and V. The scores are
    formed ``block`` queries at a time, so that long prompts fit."""
    b, s, d = x.shape
    hq = m["n_heads"]
    hkv = m.get("n_kv_heads") or hq
    hd = m.get("head_dim") or d // hq
    rot = int(hd * m.get("rotary_pct", 1.0))
    q = num.mm(x, p["wq"]).reshape(b, s, hq, hd)
    k = num.mm(x, p["wk"]).reshape(b, s, hkv, hd)
    v = num.mm(x, p["wv"]).reshape(b, s, hkv, hd)
    q, k = rope(q, cos, sin, rot), rope(k, cos, sin, rot)
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    outs = []
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        scores = num.einsum("bqhd,bkhd->bhqk", q[:, q0:q1],
                            k[:, :q1]) / math.sqrt(hd)
        causal = torch.ones(q1 - q0, q1, dtype=torch.bool,
                            device=x.device).tril(q0)
        probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), dim=-1)
        outs.append(num.einsum("bhqk,bkhd->bqhd", probs, v[:, :q1]))
    out = torch.cat(outs, dim=1)
    return num.mm(out.reshape(b, s, hq * hd), p["wo"])


def swiglu(x, p, num: Numerics):
    return num.mm(F.silu(num.mm(x, p["w_gate"])) * num.mm(x, p["w_up"]),
                  p["w_down"])


def layer(params: dict, prefix: str, i: int | None) -> dict:
    """{name: tensor} of the leaves under ``prefix`` (the i-th of each
    stacked leaf), float32."""
    out = {}
    for path, t in params.items():
        if path.startswith(prefix):
            out[path[len(prefix):]] = (t if i is None else t[i]).float()
    return out


# ---------------------------------------------------------------- dense LM

def dense_hidden(params: dict, m: dict, inputs, num: Numerics = FP32):
    """The final-normed hidden states (B, S, d) of the dense decoder
    ``params`` ({path: tensor}) over ``inputs`` (B, S)."""
    s = inputs.shape[1]
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    cos, sin = rope_tables(s, int(hd * m.get("rotary_pct", 1.0)),
                           m.get("rope_theta", 1e4), inputs.device)
    eps = m.get("norm_eps", 1e-5)
    x = params["embed"].float()[inputs]
    for i in range(m["n_layers"]):
        lp = layer(params, "blocks/", i)
        h = rmsnorm(x, lp["ln1"], eps)
        x = x + attention(h, {k[5:]: v for k, v in lp.items()
                              if k.startswith("attn/")}, m, cos, sin, num)
        h = rmsnorm(x, lp["ln2"], eps)
        x = x + swiglu(h, {k[4:]: v for k, v in lp.items()
                           if k.startswith("mlp/")}, num)
    return rmsnorm(x, params["final_norm"].float(), eps)


def dense_loss(params: dict, m: dict, tokens, num: Numerics = FP32):
    """Mean next-token cross entropy of ``tokens`` (B, S + 1) under the
    dense decoder ``params``."""
    x = dense_hidden(params, m, tokens[:, :-1], num)
    logits = num.mm(x, params["lm_head"].float())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def dense_last_logits(params: dict, m: dict, tokens, num: Numerics = FP32):
    """Logits (B, V) at the last position of ``tokens`` (B, S) under the
    dense decoder ``params`` (its untied head)."""
    x = dense_hidden(params, m, tokens, num)[:, -1]
    return num.mm(x, params["lm_head"].float())
