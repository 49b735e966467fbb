"""Selective-state-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2),
the port of the JAX package's ``models/ssm.py``.

Both variants lower to one generic scan over a flattened channel axis D:
  mamba1: D = d_inner,             A: (D, N) dense matrix
  mamba2: D = heads × head_dim,    A/Δ: per-head, repeated across head_dim
with the contract (dt, x, a, b, c) -> (y, h_final) of ``ops.selective_scan``,
h_t = exp(Δ_t A) h + (Δ_t x_t)⊗B_t.

Where the scan runs. The reference defaults to its jnp chunked scan and
reaches its Pallas kernel by ``set_scan_impl("pallas")``. Here a scan on
the card from a zero state is always the CUDA kernel; on the CPU it is the
plain loop over time. Every caller on the prefill/forward path passes
``h0=None``; a start state on the card raises, since the kernel starts
from zero. One-token decode steps are plain PyTorch on every device, as
the reference's are plain jnp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv1d, conv1d_step, rmsnorm


def _scan(dt, x, a, b, c, h0, impl=None):
    """dt/x (B, S, D), a (D, N), b/c (B, S, N) -> (y, h_final). A is passed
    to the kernel as a zero-stride (B, D, N) view, never materialised (and
    keeps a zero stride on N where it has one); x, b and c go in their own
    dtype (the kernel and the plain version upcast, as the reference's
    ``_scan`` does before its kernel)."""
    a_g = a.float()[None].expand(dt.shape[0], *a.shape)
    if h0 is None:
        return ops.selective_scan(dt.float(), x, a_g, b, c, impl=impl)
    if dt.device.type == "cuda":
        raise NotImplementedError(
            "a selective scan from a start state h0 on the card: the CUDA "
            "scan starts from zero, and no caller on the path passes h0")
    return ref.selective_scan_ref(dt, x, a_g, b, c, h0=h0)


# =================================================================== mamba1

def _mamba1_scan_inputs(params, xc):
    """Post-conv activations -> (dt, a, b, c) of the generic scan."""
    dt_raw = xc @ params["xp_dt"]                              # (B,S,r)
    b_ssm = xc @ params["xp_b"]                                # (B,S,N)
    c_ssm = xc @ params["xp_c"]                                # (B,S,N)
    dt = F.softplus((dt_raw.float() @ params["dt_proj"]
                     + params["dt_bias"]).float())
    a = -torch.exp(params["A_log"].float())                    # (di, N)
    return dt, a, b_ssm, c_ssm


def mamba1_inner(params, cfg: ModelConfig, xc, z, h0=None,
                 return_state: bool = False, impl=None):
    """Selective scan after the conv. xc (B,S,di) post-conv+silu, z gate."""
    dt, a, b_ssm, c_ssm = _mamba1_scan_inputs(params, xc)
    y, h_final = _scan(dt, xc, a, b_ssm, c_ssm, h0, impl)
    y = y + params["D"].float() * xc.float()
    y = (y * F.silu(z.float())).to(xc.dtype)
    out = y @ params["out_proj"]
    return (out, h_final) if return_state else (out, None)


def mamba1_block(params, cfg: ModelConfig, x, impl=None):
    """Full block: norm -> in_proj -> conv -> selective scan -> out_proj."""
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    xi = xn @ params["in_x"]                                   # (B,S,di)
    z = xn @ params["in_z"]
    xc = F.silu(causal_conv1d(xi, params["conv_w"], params["conv_b"]))
    out, _ = mamba1_inner(params, cfg, xc, z, impl=impl)
    return x + out


def mamba1_decode(params, cfg: ModelConfig, x_t, conv_state, ssm_state):
    """One-token recurrent step. x_t (B, d). Returns (y, conv', ssm')."""
    xn = rmsnorm(x_t, params["ln"], cfg.norm_eps)
    xi = xn @ params["in_x"]
    z = xn @ params["in_z"]
    conv_state, xc = conv1d_step(conv_state, xi, params["conv_w"],
                                 params["conv_b"])
    xc = F.silu(xc)
    dt_raw = xc @ params["xp_dt"]
    b_ssm = xc @ params["xp_b"]
    c_ssm = xc @ params["xp_c"]
    dt = F.softplus(dt_raw.float() @ params["dt_proj"]
                    + params["dt_bias"]).float()               # (B,di)
    a = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt[..., None] * a)                       # (B,di,N)
    drive = (dt * xc.float())[..., None] * b_ssm.float()[:, None, :]
    ssm_state = decay * ssm_state + drive
    y = torch.einsum("bdn,bn->bd", ssm_state, c_ssm.float())
    y = y + params["D"].float() * xc.float()
    y = (y * F.silu(z.float())).to(x_t.dtype)
    return x_t + y @ params["out_proj"], conv_state, ssm_state


# =================================================================== mamba2

def _mamba2_split(params, cfg: ModelConfig, xn):
    """Separate projections: z, x, B, C, dt."""
    return (xn @ params["in_z"], xn @ params["in_x"],
            xn @ params["in_b"], xn @ params["in_c"],
            xn @ params["in_dt"])


def _mamba2_scan_inputs(params, cfg: ModelConfig, dt_raw):
    """Per-head Δ/A repeated across head_dim onto the flat channel axis.
    A (di, N) is a view with stride 0 on N, never materialised: the scan
    kernel reads that stride and computes one decay per channel."""
    hd, n = cfg.mamba_headdim, cfg.ssm_state
    dt = F.softplus(dt_raw.float() + params["dt_bias"])       # (B,S,H)
    dt_e = torch.repeat_interleave(dt, hd, dim=-1)             # (B,S,di)
    a_h = -torch.exp(params["A_log"].float())                  # (H,)
    a_e = torch.repeat_interleave(a_h, hd)[:, None].expand(-1, n)
    return dt_e, a_e


def mamba2_inner(params, cfg: ModelConfig, xc, z, b_ssm, c_ssm, dt_raw,
                 h0=None, return_state: bool = False, impl=None):
    """xc (B,S,di) post-conv+silu. h0/h_final: (B, H, hd, N)."""
    bsz, s, di = xc.shape
    hn, hd, n = cfg.ssm_heads, cfg.mamba_headdim, cfg.ssm_state
    dt_e, a_e = _mamba2_scan_inputs(params, cfg, dt_raw)
    h0_flat = None if h0 is None else h0.reshape(bsz, di, n)
    y, h_final = _scan(dt_e, xc, a_e, b_ssm, c_ssm, h0_flat, impl)
    y = y + torch.repeat_interleave(params["D"].float(), hd) * xc.float()
    y = (y * F.silu(z.float())).to(xc.dtype)
    y = rmsnorm(y, params["out_norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, h_final.reshape(bsz, hn, hd, n)
    return out, None


def mamba2_block(params, cfg: ModelConfig, x, impl=None):
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    z, xi, b_ssm, c_ssm, dt_raw = _mamba2_split(params, cfg, xn)
    xc = F.silu(causal_conv1d(xi, params["conv_w"], params["conv_b"]))
    out, _ = mamba2_inner(params, cfg, xc, z, b_ssm, c_ssm, dt_raw,
                          impl=impl)
    return x + out


def mamba2_decode(params, cfg: ModelConfig, x_t, conv_state, ssm_state):
    """x_t (B, d); ssm_state (B, H, hd, N)."""
    bsz = x_t.shape[0]
    hn, hd = cfg.ssm_heads, cfg.mamba_headdim
    xn = rmsnorm(x_t, params["ln"], cfg.norm_eps)
    z, xi, b_ssm, c_ssm, dt_raw = _mamba2_split(params, cfg, xn)
    conv_state, xc = conv1d_step(conv_state, xi, params["conv_w"],
                                 params["conv_b"])
    xc = F.silu(xc)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"].float())
    xh = xc.reshape(bsz, hn, hd).float()
    decay = torch.exp(dt * a)[..., None, None]                 # (B,H,1,1)
    drive = (dt[..., None] * xh)[..., None] \
        * b_ssm.float()[:, None, None, :]
    ssm_state = decay * ssm_state + drive
    y = torch.einsum("bhpn,bn->bhp", ssm_state, c_ssm.float())
    y = y + params["D"].float()[:, None] * xh
    y = y.reshape(bsz, -1)
    y = (y * F.silu(z.float())).to(x_t.dtype)
    y = rmsnorm(y, params["out_norm"], cfg.norm_eps)
    return x_t + y @ params["out_proj"], conv_state, ssm_state
