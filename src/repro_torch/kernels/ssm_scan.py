"""Wrapper of the CUDA selective scan in ``csrc/ssm_scan.cu``.

The wrapper checks its operands, allocates y and h_final with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch failed. ``selective_scan.launches`` counts its launches, so a run can
show that it went through the kernel. The library is built and loaded at
the first launch, never on import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_STATE = 128    # N: a block holds 8 states per warp, 16 warps
MAX_GROUPS = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("ssm_scan")
    _L = ctypes.c_longlong
    lib.ssm_scan.argtypes = [_P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _P]
    lib.ssm_scan.restype = _I
    lib.ssm_scan_error_string.argtypes = [_I]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def selective_scan(dt, x, a, b, c):
    """The selective scan on the card: (y (G, S, D) fp32, h_final (G, D, N)
    fp32) from a zero start state, without the D·x skip or the gate.

    dt (G, S, D) fp32; x (G, S, D) fp32 or bf16; a (G, D, N) fp32, any
    stride over G (a zero-stride view, as from ``a2d.expand(G, D, N)``, is
    taken as it is and never materialised), and over (D, N) either a
    contiguous block (Mamba1's dense A: one exponential per state) or a
    zero stride on N (Mamba2's A, constant along N, as from
    ``a_d[:, None].expand(D, N)``: one exponential per channel, applied to
    all N states); b, c (G, S, N), both fp32 or both bf16. dt, x, b and c
    contiguous. bf16 operands are upcast to fp32 inside the kernel.
    """
    name = "selective_scan"
    ops_ = {"dt": dt, "x": x, "a": a, "b": b, "c": c}
    for key, t in ops_.items():
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: the CUDA kernel needs CUDA tensors; "
                               f"{key} is on {t.device}")
        if t.device != dt.device:
            raise ValueError(f"{name}: {key} is on {t.device}, dt on "
                             f"{dt.device}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"{name}: dt and a must be fp32, got {dt.dtype} "
                         f"and {a.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be fp32 or bf16, got {x.dtype}")
    if b.dtype != c.dtype or b.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: b and c must both be fp32 or both bf16, "
                         f"got {b.dtype} and {c.dtype}")
    if dt.dim() != 3 or x.shape != dt.shape or dt.numel() == 0:
        raise ValueError(f"{name}: dt and x must be equal non-empty "
                         f"(G, S, D), got {tuple(dt.shape)} and "
                         f"{tuple(x.shape)}")
    g, s, d = dt.shape
    if b.dim() != 3 or b.shape[:2] != (g, s) or c.shape != b.shape:
        raise ValueError(f"{name}: b and c must be ({g}, {s}, N), got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    n = b.shape[2]
    if a.shape != (g, d, n):
        raise ValueError(f"{name}: a must be ({g}, {d}, {n}), got "
                         f"{tuple(a.shape)}")
    if not 1 <= n <= MAX_STATE or g > MAX_GROUPS:
        raise ValueError(f"{name}: needs 1 <= N <= {MAX_STATE} and G <= "
                         f"{MAX_GROUPS}, got N = {n}, G = {g}")
    if not all(t.is_contiguous() for t in (dt, x, b, c)):
        raise ValueError(f"{name}: dt, x, b and c must be contiguous")
    if a.stride(2) != 0 and not a[0].is_contiguous():
        raise ValueError(f"{name}: each (D, N) block of a must be "
                         "contiguous or have stride 0 on N")
    lib = _lib()
    y = torch.empty((g, s, d), dtype=torch.float32, device=dt.device)
    hfin = torch.empty((g, d, n), dtype=torch.float32, device=dt.device)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        err = lib.ssm_scan(
            dt.data_ptr(), x.data_ptr(), a.data_ptr(), *a.stride(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(), hfin.data_ptr(), g, s,
            d, n, int(x.dtype == torch.bfloat16),
            int(b.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    selective_scan.launches += 1
    return y, hfin


selective_scan.launches = 0
