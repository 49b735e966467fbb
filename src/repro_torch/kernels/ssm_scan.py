"""Wrappers of the CUDA selective scans in ``csrc/ssm_scan.cu``.

``selective_scan`` takes any A (``ssm_scan_kernel``, the recurrence on
the CUDA cores); ``selective_scan_heads`` takes Mamba2's per-head form
(``ssm_scan_kernel_ssd``, chunked products on the tensor cores fed by
TMA). Each wrapper checks its operands, allocates y and h_final with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch failed. ``selective_scan.launches`` and
``selective_scan_heads.launches`` count their scan launches, so a run can
show that it went through the kernel (``split_pieces.launches`` the fp32
operands' splits). The library is built and loaded at the first launch,
never on import.
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
HEADS_WIDTH = 64   # P of the per-head form: one 64-column tile
HEADS_STATE = 128  # N of the per-head form: up to two 64-column tiles


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/ssm_scan.cu`` on ``lib``, a library
    built from it (or from another source of the same interface)."""
    _L = ctypes.c_longlong
    lib.ssm_scan.argtypes = [_P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _P]
    lib.ssm_scan.restype = _I
    lib.ssm_scan_heads.argtypes = [_P, _P, _I, _P, _P, _P, _I, _P, _P, _I,
                                   _I, _I, _I, _I, _P]
    lib.ssm_scan_heads.restype = _I
    lib.ssm_split_bf16.argtypes = [_P, _P, _L, _P]
    lib.ssm_split_bf16.restype = _I
    lib.ssm_scan_error_string.argtypes = [_I]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("ssm_scan"))


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
    _raise_on(lib, err, name)
    selective_scan.launches += 1
    return y, hfin


selective_scan.launches = 0


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.ssm_scan_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def split_pieces(t):
    """An fp32 CUDA tensor as a (3, *shape) bf16 tensor of pieces v0 =
    bf16(t), v1 = bf16(t − v0), v2 = bf16(t − v0 − v1) that add up to t
    exactly, by ``ssm_split_bf16_kernel``: how fp32 x, B and C enter the
    per-head scan's bf16 products."""
    lib = _lib()
    out = torch.empty((3, *t.shape), dtype=torch.bfloat16, device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = lib.ssm_split_bf16(t.data_ptr(), out.data_ptr(), t.numel(),
                                 stream)
    _raise_on(lib, err, "split_pieces")
    split_pieces.launches += 1
    return out


split_pieces.launches = 0


def selective_scan_heads(dt_h, x, a_h, b, c):
    """Mamba2's per-head selective scan on the card: (y (G, S, H·P) fp32,
    h_final (G, H·P, N) fp32) from a zero state, without the D·x skip or
    the gate; what :func:`selective_scan` returns for dt and A repeated
    over each head's P channels.

    dt_h (G, S, H) fp32; x (G, S, H·P) fp32 or bf16; a_h (H,) fp32; b, c
    (G, S, N), both fp32 or both bf16. All contiguous; bf16 operands
    16-byte aligned (TMA reads them). P a multiple of 8 up to 64, N one
    up to 128 (above 64 the kernel carries the state as two 64-column
    tiles, one a consumer warpgroup, and adds their y).
    fp32 x, b and c are cut into three bf16 pieces each
    (:func:`split_pieces`) before the scan."""
    name = "selective_scan_heads"
    ops_ = {"dt_h": dt_h, "x": x, "a_h": a_h, "b": b, "c": c}
    for key, t in ops_.items():
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: the CUDA kernel needs CUDA tensors; "
                               f"{key} is on {t.device}")
        if t.device != dt_h.device:
            raise ValueError(f"{name}: {key} is on {t.device}, dt_h on "
                             f"{dt_h.device}")
    if dt_h.dtype != torch.float32 or a_h.dtype != torch.float32:
        raise ValueError(f"{name}: dt_h and a_h must be fp32, got "
                         f"{dt_h.dtype} and {a_h.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be fp32 or bf16, got {x.dtype}")
    if b.dtype != c.dtype or b.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: b and c must both be fp32 or both bf16, "
                         f"got {b.dtype} and {c.dtype}")
    if dt_h.dim() != 3 or dt_h.numel() == 0:
        raise ValueError(f"{name}: dt_h must be a non-empty (G, S, H), got "
                         f"{tuple(dt_h.shape)}")
    g, s, hn = dt_h.shape
    if (x.dim() != 3 or x.shape[:2] != (g, s) or x.shape[2] % hn
            or x.shape[2] == 0):
        raise ValueError(f"{name}: x must be ({g}, {s}, {hn}·P), got "
                         f"{tuple(x.shape)}")
    if b.dim() != 3 or b.shape[:2] != (g, s) or c.shape != b.shape:
        raise ValueError(f"{name}: b and c must be ({g}, {s}, N), got "
                         f"{tuple(b.shape)} and {tuple(c.shape)}")
    if a_h.shape != (hn,):
        raise ValueError(f"{name}: a_h must be ({hn},), got "
                         f"{tuple(a_h.shape)}")
    p, n = x.shape[2] // hn, b.shape[2]
    for what, v, top in (("head_dim P", p, HEADS_WIDTH),
                         ("state N", n, HEADS_STATE)):
        if v % 8 or not 8 <= v <= top:
            raise ValueError(f"{name}: {what} = {v}; the kernel takes "
                             f"multiples of 8 up to {top}")
    if not all(t.is_contiguous() for t in ops_.values()):
        raise ValueError(f"{name}: dt_h, x, a_h, b and c must be contiguous")
    for key, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: bf16 {key} must be 16-byte aligned "
                             "(TMA)")
    lib = _lib()

    def pieces(t):
        """The bf16 pieces' pointers as a C array, and what holds them."""
        ts = [t] if t.dtype == torch.bfloat16 else list(split_pieces(t))
        return (ctypes.c_void_p * len(ts))(*(u.data_ptr() for u in ts)), ts

    (xp, xs), (bp, bs), (cp, cs) = pieces(x), pieces(b), pieces(c)
    y = torch.empty((g, s, hn * p), dtype=torch.float32, device=x.device)
    hfin = torch.empty((g, hn * p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(dt_h.device):
        stream = torch.cuda.current_stream(dt_h.device).cuda_stream
        err = lib.ssm_scan_heads(
            dt_h.data_ptr(), xp, len(xs), a_h.data_ptr(), bp, cp, len(bs),
            y.data_ptr(), hfin.data_ptr(), g, s, hn, p, n, stream)
    _raise_on(lib, err, name)
    selective_scan_heads.launches += 1
    return y, hfin


selective_scan_heads.launches = 0
