"""Wrapper of the CUDA rotary embedding in ``csrc/rope.cu``.

The wrapper checks its operands, allocates the output with
``torch.empty_like``, launches on PyTorch's current stream and raises if
the launch failed. ``apply_rope.launches`` counts its launches, so a run
can show that it went through the kernel. The library is built and loaded
at the first launch, never on import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_BF16, _VEC = 1, 2   # flags of rope_fwd
PACK = 8             # elements of a vector pack


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/rope.cu`` on ``lib``, a library
    built from it (or from another source of the same interface)."""
    lib.rope_fwd.argtypes = [_P, _P, _P, _P, _L, _L, _I, _I, _I, _L, _L, _L,
                             _L, _I, _P]
    lib.rope_fwd.restype = _I
    lib.rope_error_string.argtypes = [_I]
    lib.rope_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("rope"))


def _table(t, b: int, s: int, key: str, name: str):
    """``t`` broadcast to (b, s, width) (a stride of 0 over any axis it
    has one row on), checked."""
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: {key} must be fp32, got {t.dtype}")
    try:
        e = t.expand(b, s, t.shape[-1])
    except RuntimeError as err:
        raise ValueError(f"{name}: {key} {tuple(t.shape)} does not broadcast "
                         f"to (B, S, width) = ({b}, {s}, .)") from err
    if e.shape[-1] > 1 and e.stride(-1) != 1:
        raise ValueError(f"{name}: {key}'s last axis must be contiguous")
    return e


def apply_rope(x, cos, sin, rotary_pct: float = 1.0):
    """The rotary embedding of x on the card, bit for bit
    ``ref.rope_ref(x, cos, sin, rotary_pct)``.

    x (B, S, H, hd) contiguous, fp32 or bf16; cos/sin fp32 of the same shape,
    (S, W), (1, S, W) or (B, S, W) with W >= rot / 2, their last axis
    contiguous; rot = int(hd * rotary_pct) even and in [2, hd]. Returns a
    new (B, S, H, hd) tensor of x's dtype.
    """
    name = "rope"
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty (B, S, H, hd), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be fp32 or bf16, got {x.dtype}")
    if cos.shape != sin.shape:
        raise ValueError(f"{name}: cos {tuple(cos.shape)} and sin "
                         f"{tuple(sin.shape)} differ")
    b, s, h, hd = x.shape
    rot = int(hd * rotary_pct)
    if rot < 2 or rot > hd or rot % 2:
        raise ValueError(f"{name}: rot = int({hd} * {rotary_pct}) = {rot} "
                         f"must be even and in [2, {hd}]")
    half = rot // 2
    c, sn = (_table(t, b, s, key, name) for key, t in (("cos", cos),
                                                        ("sin", sin)))
    if c.shape[-1] < half:
        raise ValueError(f"{name}: tables of width {c.shape[-1]} for rot/2 "
                         f"= {half}")
    for key, t in (("x", x), ("cos", cos), ("sin", sin)):
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: the CUDA kernel needs CUDA tensors; "
                               f"{key} is on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, x on "
                             f"{x.device}")
    out = torch.empty_like(x)
    vec = (half % PACK == 0 and hd % PACK == 0
           and not any(t.data_ptr() % 16 for t in (x, out, c, sn))
           and not any(st % 4 for t in (c, sn) for st in t.stride()[:2]))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rope_fwd(
            x.data_ptr(), c.data_ptr(), sn.data_ptr(), out.data_ptr(), b, s,
            h, hd, rot, c.stride(0), c.stride(1), sn.stride(0), sn.stride(1),
            (_BF16 if x.dtype == torch.bfloat16 else 0)
            | (_VEC if vec else 0), stream)
    if err != 0:
        msg = lib.rope_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    apply_rope.launches += 1
    return out


apply_rope.launches = 0
