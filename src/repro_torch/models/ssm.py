"""Selective-state-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2),
the port of the JAX package's ``models/ssm.py``, and the published Mamba2
mixer (granite-4.0-h: :func:`mamba2_mixer`, :func:`mamba2_mixer_step`),
whose causal conv runs over [x, B, C] where the reference's convolves x
alone.

Both variants lower to one generic scan over a flattened channel axis D:
  mamba1: D = d_inner,             A: (D, N) dense matrix
  mamba2: D = heads × head_dim,    A/Δ: per-head, repeated across head_dim
with the contract (dt, x, a, b, c) -> (y, h_final) of ``ops.selective_scan``,
h_t = exp(Δ_t A) h + (Δ_t x_t)⊗B_t.

Where the scan runs: two routes.
  * Serving (``train=False``, prefill and forward): a scan on the card
    from a zero state is always a CUDA kernel; on the CPU it is the
    plain loop over time. Mamba1 takes ``ops.selective_scan``; Mamba2
    takes ``ops.selective_scan_heads`` with Δ and A per head (the
    tensor-core kernel; its plain version repeats them and runs the same
    loop as before). Every caller on this route passes ``h0=None``; a
    start state on the card raises, since the kernels start from zero.
  * Training (``train=True``, the trainer's forward and backward):
    :func:`selective_scan_chunked`, the reference's chunked
    ``selective_scan_jnp`` as PyTorch code under autograd, on every
    device. The reference's trainer takes that jnp scan too (its Pallas
    kernel is opt-in and has no backward), and so does this one: there is
    no backward kernel.
One-token decode steps are plain PyTorch on every device, as the
reference's are plain jnp. On ``meta`` tensors (the dry run) both routes
are shape-only, their operations counted by formula
(``ops.counting_meta_ops``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv1d, conv1d_step, rmsnorm


DEFAULT_CHUNK = 128


def selective_scan_chunked(dt, x, a, b, c, h0=None,
                           chunk: int = DEFAULT_CHUNK):
    """The training route's scan: the reference's ``selective_scan_jnp``
    with the same contract. dt, x (B, S, D); a (D, N); b, c (B, S, N); h0
    (B, D, N) or None. All math fp32. Returns (y (B, S, D) without the D·x
    skip or the gate, h_final (B, D, N)).

    The sequence runs in chunks with the state carried between them, and
    the decay and drive terms are formed per chunk, so only one
    (B, chunk, D, N) tile lives at a time. Inside a chunk the recurrence
    h_t = decay_t·h_{t−1} + drive_t runs step by step (torch has no
    associative scan; the reference's runs as a tree, so the two round
    differently)."""
    bsz, s, d = dt.shape
    n = b.shape[-1]
    if dt.device.type == "meta" and h0 is None:
        return _MetaScan.apply(dt, x, a, b, c)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq len {s} not divisible by chunk {chunk}")
    dt, x, a = dt.float(), x.float(), a.float()
    b, c = b.float(), c.float()
    h = (torch.zeros((bsz, d, n), dtype=torch.float32, device=dt.device)
         if h0 is None else h0.float())
    ys = []
    for lo in range(0, s, chunk):
        dt_c, x_c = dt[:, lo:lo + chunk], x[:, lo:lo + chunk]
        b_c, c_c = b[:, lo:lo + chunk], c[:, lo:lo + chunk]
        decay = torch.exp(dt_c[..., None] * a)              # (B,chunk,D,N)
        drive = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
        for t in range(chunk):
            h = decay[:, t] * h + drive[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, c_c[:, t]))
    return torch.stack(ys, dim=1), h


class _MetaScan(torch.autograd.Function):
    """The training scan on ``meta`` tensors (the dry run): its outputs'
    shapes, in the autograd graph, with 6·B·S·D·N operations counted
    forward (three FMA-class operations a state and step) and twice that
    backward; a step-by-step loop over S would dispatch S small ops a
    layer."""

    @staticmethod
    def forward(ctx, dt, x, a, b, c):
        bsz, s, d = dt.shape
        n = b.shape[-1]
        ctx.shapes = [(t.shape, t.dtype) for t in (dt, x, a, b, c)]
        ctx.elems = bsz * s * d * n
        ops.count_meta_ops("selective_scan_chunked", 6 * ctx.elems)
        return (torch.empty((bsz, s, d), dtype=torch.float32, device="meta"),
                torch.empty((bsz, d, n), dtype=torch.float32, device="meta"))

    @staticmethod
    def backward(ctx, gy, gh):
        ops.count_meta_ops("selective_scan_chunked", 12 * ctx.elems)
        return tuple(torch.empty(shape, dtype=dtype, device="meta")
                     for shape, dtype in ctx.shapes)


def _scan(dt, x, a, b, c, h0, impl=None, train=False):
    """dt/x (B, S, D), a (D, N), b/c (B, S, N) -> (y, h_final).

    ``train`` takes :func:`selective_scan_chunked`. Otherwise A is passed
    to the kernel as a zero-stride (B, D, N) view, never materialised (and
    keeps a zero stride on N where it has one); x, b and c go in their own
    dtype (the kernel and the plain version upcast, as the reference's
    ``_scan`` does before its kernel)."""
    if train:
        return selective_scan_chunked(dt, x, a, b, c, h0)
    a_g = a.float()[None].expand(dt.shape[0], *a.shape)
    if h0 is None:
        return ops.selective_scan(dt.float(), x, a_g, b, c, impl=impl)
    if dt.device.type == "cuda":
        raise NotImplementedError(
            "a selective scan from a start state h0 on the card: the CUDA "
            "scan starts from zero, and no caller on the path passes h0")
    return ref.selective_scan_ref(dt, x, a_g, b, c, h0=h0)


# =================================================================== mamba1

def _mamba1_xproj(params, cfg: ModelConfig, xc, tp=None):
    """Post-conv activations -> (dt_raw (.., r), B (.., N), C (.., N)).
    Where the rank holds a block of d_inner, ``xp_*`` are row-parallel:
    the three partial products are all-reduced as one (.., r + 2N)
    tensor over ``tp``'s model axis, and so is their gradient (the rank's
    d_inner block consumes the sums)."""
    dt_raw = xc @ params["xp_dt"]                              # (B,S,r)
    b_ssm = xc @ params["xp_b"]                                # (B,S,N)
    c_ssm = xc @ params["xp_c"]                                # (B,S,N)
    if tp is not None and params["xp_dt"].shape[-2] != cfg.d_inner:
        r, n = dt_raw.shape[-1], b_ssm.shape[-1]
        dt_raw, b_ssm, c_ssm = tp.shard_sum(torch.cat(
            [dt_raw, b_ssm, c_ssm], dim=-1)).split([r, n, n], dim=-1)
    return dt_raw, b_ssm, c_ssm


def _out_proj(params, cfg: ModelConfig, y, tp=None):
    """y (.., di) through ``out_proj``; row-parallel where the rank holds a
    block of d_inner (the partial product all-reduced)."""
    out = y @ params["out_proj"]
    if tp is not None and params["out_proj"].shape[-2] != cfg.d_inner:
        out = tp.all_reduce(out)
    return out


def _mamba1_scan_inputs(params, cfg: ModelConfig, xc, tp=None):
    """Post-conv activations -> (dt, a, b, c) of the generic scan."""
    dt_raw, b_ssm, c_ssm = _mamba1_xproj(params, cfg, xc, tp)
    dt = F.softplus((dt_raw.float() @ params["dt_proj"]
                     + params["dt_bias"]).float())
    a = -torch.exp(params["A_log"].float())                    # (di, N)
    return dt, a, b_ssm, c_ssm


def mamba1_inner(params, cfg: ModelConfig, xc, z, h0=None,
                 return_state: bool = False, impl=None, train=False,
                 tp=None):
    """Selective scan after the conv. xc (B,S,di) post-conv+silu, z gate
    (the rank's d_inner block under ``tp``)."""
    dt, a, b_ssm, c_ssm = _mamba1_scan_inputs(params, cfg, xc, tp)
    y, h_final = _scan(dt, xc, a, b_ssm, c_ssm, h0, impl, train)
    y = y + params["D"].float() * xc.float()
    y = (y * F.silu(z.float())).to(xc.dtype)
    out = _out_proj(params, cfg, y, tp)
    return (out, h_final) if return_state else (out, None)


def mamba1_block(params, cfg: ModelConfig, x, impl=None, train=False,
                 tp=None):
    """Full block: norm -> in_proj -> conv -> selective scan -> out_proj.
    Under ``tp`` with d_inner sharded, the normed x enters the
    column-parallel ``in_x``/``in_z``."""
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    if tp is not None and params["in_x"].shape[-1] != cfg.d_inner:
        xn = tp.enter(xn)
    xi = xn @ params["in_x"]                                   # (B,S,di)
    z = xn @ params["in_z"]
    xc = F.silu(causal_conv1d(xi, params["conv_w"], params["conv_b"]))
    out, _ = mamba1_inner(params, cfg, xc, z, impl=impl, train=train, tp=tp)
    return x + out


def mamba1_decode(params, cfg: ModelConfig, x_t, conv_state, ssm_state,
                  tp=None):
    """One-token recurrent step. x_t (B, d). Returns (y, conv', ssm');
    the states are the rank's d_inner block under ``tp``."""
    xn = rmsnorm(x_t, params["ln"], cfg.norm_eps)
    xi = xn @ params["in_x"]
    z = xn @ params["in_z"]
    conv_state, xc = conv1d_step(conv_state, xi, params["conv_w"],
                                 params["conv_b"])
    xc = F.silu(xc)
    dt_raw, b_ssm, c_ssm = _mamba1_xproj(params, cfg, xc, tp)
    dt = F.softplus(dt_raw.float() @ params["dt_proj"]
                    + params["dt_bias"]).float()               # (B,di)
    a = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt[..., None] * a)                       # (B,di,N)
    drive = (dt * xc.float())[..., None] * b_ssm.float()[:, None, :]
    ssm_state = decay * ssm_state + drive
    y = torch.einsum("bdn,bn->bd", ssm_state, c_ssm.float())
    y = y + params["D"].float() * xc.float()
    y = (y * F.silu(z.float())).to(x_t.dtype)
    return x_t + _out_proj(params, cfg, y, tp), conv_state, ssm_state


# =================================================================== mamba2

def _mamba2_split(params, cfg: ModelConfig, xn):
    """Separate projections: z, x, B, C, dt."""
    return (xn @ params["in_z"], xn @ params["in_x"],
            xn @ params["in_b"], xn @ params["in_c"],
            xn @ params["in_dt"])


def _own_heads(params, dt_raw, tp):
    """dt_raw (.., H) -> the rank's heads: ``in_dt`` is replicated, while
    ``dt_bias``, ``A_log`` and ``D`` are sharded over the heads where
    d_inner is (``TPContext`` refuses a split of one without the other)."""
    h = params["dt_bias"].shape[-1]
    if tp is None or h == dt_raw.shape[-1]:
        return dt_raw
    return dt_raw[..., tp.index * h:(tp.index + 1) * h]


def _mamba2_heads(params, dt_raw):
    """Per-head Δ (B, S, H) and A (H,) fp32 from the rank's dt_raw."""
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    return dt, -torch.exp(params["A_log"].float())


def _mamba2_scan_inputs(params, cfg: ModelConfig, dt_raw):
    """Per-head Δ/A repeated across head_dim onto the flat channel axis
    (the training route and a start state's). A (di, N) is a view with
    stride 0 on N, never materialised: the general scan kernel reads that
    stride and computes one decay per channel."""
    hd, n = cfg.mamba_headdim, cfg.ssm_state
    dt, a_h = _mamba2_heads(params, dt_raw)
    dt_e = torch.repeat_interleave(dt, hd, dim=-1)             # (B,S,di)
    a_e = torch.repeat_interleave(a_h, hd)[:, None].expand(-1, n)
    return dt_e, a_e


def mamba2_inner(params, cfg: ModelConfig, xc, z, b_ssm, c_ssm, dt_raw,
                 h0=None, return_state: bool = False, impl=None,
                 train=False, tp=None):
    """xc (B,S,di) post-conv+silu. h0/h_final: (B, H, hd, N). Under ``tp``
    xc, z and the state are the rank's block of d_inner and of the heads;
    the gated norm and ``out_proj`` complete over the model axis. Serving
    from a zero state takes the per-head scan (``ops.selective_scan_heads``);
    training and a start state the repeated Δ/A of the generic scan."""
    bsz, s, di = xc.shape
    hd, n = cfg.mamba_headdim, cfg.ssm_state
    split = tp is not None and di != cfg.d_inner
    dt_raw = _own_heads(params, dt_raw, tp)
    if not train and h0 is None:
        dt_h, a_h = _mamba2_heads(params, dt_raw)
        y, h_final = ops.selective_scan_heads(dt_h, xc, a_h, b_ssm, c_ssm,
                                              impl=impl)
    else:
        dt_e, a_e = _mamba2_scan_inputs(params, cfg, dt_raw)
        h0_flat = None if h0 is None else h0.reshape(bsz, di, n)
        y, h_final = _scan(dt_e, xc, a_e, b_ssm, c_ssm, h0_flat, impl, train)
    y = y + torch.repeat_interleave(params["D"].float(), hd) * xc.float()
    y = (y * F.silu(z.float())).to(xc.dtype)
    y = rmsnorm(y, params["out_norm"], cfg.norm_eps, tp if split else None)
    out = _out_proj(params, cfg, y, tp)
    if return_state:
        return out, h_final.reshape(bsz, -1, hd, n)
    return out, None


def mamba2_block(params, cfg: ModelConfig, x, impl=None, train=False,
                 tp=None):
    """Full block. Under ``tp`` with d_inner and the heads sharded, the
    normed x enters the column-parallel projections, and the whole
    ``in_b``/``in_c``/``in_dt``, whose outputs only the rank's heads
    consume, enter too (their gradients summed over the model axis)."""
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    if tp is not None and params["in_x"].shape[-1] != cfg.d_inner:
        xn = tp.enter(xn)
        params = {**params, **{k: tp.enter(params[k])
                               for k in ("in_b", "in_c", "in_dt")}}
    z, xi, b_ssm, c_ssm, dt_raw = _mamba2_split(params, cfg, xn)
    xc = F.silu(causal_conv1d(xi, params["conv_w"], params["conv_b"]))
    out, _ = mamba2_inner(params, cfg, xc, z, b_ssm, c_ssm, dt_raw,
                          impl=impl, train=train, tp=tp)
    return x + out


def mamba2_decode(params, cfg: ModelConfig, x_t, conv_state, ssm_state,
                  tp=None):
    """x_t (B, d); ssm_state (B, H, hd, N) (the rank's heads under
    ``tp``)."""
    xn = rmsnorm(x_t, params["ln"], cfg.norm_eps)
    z, xi, b_ssm, c_ssm, dt_raw = _mamba2_split(params, cfg, xn)
    conv_state, xc = conv1d_step(conv_state, xi, params["conv_w"],
                                 params["conv_b"])
    xc = F.silu(xc)
    y, ssm_state = _mamba2_step(params, cfg, xc, z, b_ssm, c_ssm, dt_raw,
                                ssm_state, tp)
    return x_t + y, conv_state, ssm_state


def _mamba2_step(params, cfg: ModelConfig, xc, z, b_ssm, c_ssm, dt_raw,
                 ssm_state, tp=None):
    """One token's recurrence after the conv: xc (B, di) post-conv+silu;
    returns (the mixer's output (B, d), ssm_state')."""
    bsz = xc.shape[0]
    hd = cfg.mamba_headdim
    split = tp is not None and xc.shape[-1] != cfg.d_inner
    dt = F.softplus(_own_heads(params, dt_raw, tp).float()
                    + params["dt_bias"])
    a = -torch.exp(params["A_log"].float())
    xh = xc.reshape(bsz, -1, hd).float()
    decay = torch.exp(dt * a)[..., None, None]                 # (B,H,1,1)
    drive = (dt[..., None] * xh)[..., None] \
        * b_ssm.float()[:, None, None, :]
    ssm_state = decay * ssm_state + drive
    y = torch.einsum("bhpn,bn->bhp", ssm_state, c_ssm.float())
    y = y + params["D"].float()[:, None] * xh
    y = y.reshape(bsz, -1)
    y = (y * F.silu(z.float())).to(xc.dtype)
    y = rmsnorm(y, params["out_norm"], cfg.norm_eps, tp if split else None)
    return _out_proj(params, cfg, y, tp), ssm_state


# ========================================================= published mamba2

def _conv_xbc(params, xi, b_ssm, c_ssm):
    """The published causal conv over the concatenation [x, B, C]
    (``conv_w`` (K, di + 2N), ``conv_b`` (di + 2N)), then SiLU: the conv
    is depthwise, so it is one conv of each part with its own columns of
    the taps (the concatenation is never formed), and each part comes out
    contiguous, as the scan takes it."""
    di, n = xi.shape[-1], b_ssm.shape[-1]
    w, bias = params["conv_w"], params["conv_b"]
    return [F.silu(causal_conv1d(t, w[:, lo:lo + t.shape[-1]],
                                 bias[lo:lo + t.shape[-1]]))
            for lo, t in ((0, xi), (di, b_ssm), (di + n, c_ssm))]


def mamba2_mixer(params, cfg: ModelConfig, xn, impl=None, train=False,
                 state: bool = False):
    """The published Mamba2 mixer over a normed sequence xn (B, S, d):
    the projections (z, x, B, C, Δ), the causal conv over [x, B, C], the
    per-head scan with the D skip, the gated RMSNorm of y·silu(z), and
    ``out_proj``; no residual. Returns (out (B, S, d), conv tail, h_final):
    with ``state`` (prefill) the conv's last K − 1 inputs [x, B, C]
    (B, K − 1, di + 2N) and the final state (B, H, hd, N), else None."""
    z, xi, b_ssm, c_ssm, dt_raw = _mamba2_split(params, cfg, xn)
    xc, bc, cc = _conv_xbc(params, xi, b_ssm, c_ssm)
    out, h_final = mamba2_inner(params, cfg, xc, z, bc, cc, dt_raw,
                                return_state=state, impl=impl, train=train)
    if not state:
        return out, None, None
    k1 = cfg.ssm_conv - 1
    tail = torch.cat([xi[:, -k1:], b_ssm[:, -k1:], c_ssm[:, -k1:]], dim=-1)
    return out, tail, h_final


def mamba2_mixer_step(params, cfg: ModelConfig, xn_t, conv_state,
                      ssm_state):
    """One decode token of :func:`mamba2_mixer`: xn_t (B, d) normed;
    conv_state (B, K − 1, di + 2N) holds the last inputs [x, B, C];
    ssm_state (B, H, hd, N). Returns (out (B, d), conv', ssm')."""
    z, xi, b_ssm, c_ssm, dt_raw = _mamba2_split(params, cfg, xn_t)
    conv_state, xbc = conv1d_step(conv_state,
                                  torch.cat([xi, b_ssm, c_ssm], dim=-1),
                                  params["conv_w"], params["conv_b"])
    xc, bc, cc = F.silu(xbc).split(
        [xi.shape[-1], b_ssm.shape[-1], c_ssm.shape[-1]], dim=-1)
    out, ssm_state = _mamba2_step(params, cfg, xc, z, bc, cc, dt_raw,
                                  ssm_state)
    return out, conv_state, ssm_state
