"""Wrapper of the CUDA flash attention in ``csrc/flash_attention.cu``.

The wrapper checks its operands, allocates the output with
``torch.empty_like``, launches on PyTorch's current stream and raises if
the launch failed. ``flash_attention.launches`` counts its launches, so a
run can show that it went through the kernel. The library is built and
loaded at the first launch, never on import.

The kernel is compiled for the head dims in ``HEAD_DIMS``, which hold every
head dim of the repo's configs. Any other hd up to the largest is served by
the next larger instance (:func:`instance_for`): q, k and v are zero-padded
to it and the output is cut back, which is exact (zero columns add nothing
to q·k, and padded V columns fill only output columns that are dropped);
the softmax scale stays 1/√hd of the true hd.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
HEAD_DIMS = (16, 32, 64, 80, 128)   # compiled instances
MAX_ROWS = 65535                # B * Hq: the grid's second dimension


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, ctypes.c_float, _I, _P]
    lib.flash_attention_fwd.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def instance_for(hd: int) -> int:
    """The compiled head dim that serves ``hd``: hd itself, or the next
    larger one, to which the operands are zero-padded. Raises for hd above
    the largest."""
    for inst in HEAD_DIMS:
        if hd <= inst:
            return inst
    raise ValueError(f"flash_attention: head dim {hd} above "
                     f"{HEAD_DIMS[-1]}: no compiled instance takes it "
                     f"(compiled: {HEAD_DIMS})")


def flash_attention(q, k, v, *, window: int = 0):
    """Causal (optionally windowed) self-attention on the card.

    q (B, S, Hq, hd), k/v (B, S, Hkv, hd), all contiguous and all fp32 or
    all bf16 (bf16: on the tensor cores, each operand 16-byte aligned);
    Hq a multiple of Hkv; hd at most ``HEAD_DIMS[-1]`` (zero-padded to
    the next compiled instance where it is not one); ``window`` 0 (full causal)
    or the number of positions a query sees, itself included. Returns
    (B, S, Hq, hd) in q's dtype.
    """
    name = "flash_attention"
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: the CUDA kernel needs CUDA tensors; "
                               f"{key} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must share a dtype, got "
                             f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {key} must be (B, S, H, hd), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: fp32 or bf16 operands, got {q.dtype}")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if (k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != hd
            or q.numel() == 0):
        raise ValueError(f"{name}: need non-empty q (B, S, Hq, hd) and k, v "
                         f"(B, S, Hkv, hd) of the same B, S, hd; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"{name}: Hq = {hq} is not a multiple of Hkv = "
                         f"{hkv}")
    inst = instance_for(hd)
    if b * hq > MAX_ROWS:
        raise ValueError(f"{name}: B * Hq = {b * hq} exceeds {MAX_ROWS}")
    window = int(window)
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    if inst != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, inst - hd))
                   for t in (q, k, v))
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError(f"{name}: bf16 q, k and v must be 16-byte aligned "
                         "(the kernel copies 16-byte chunks)")
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            hq, hkv, inst, window, 1.0 / float(hd) ** 0.5,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
    flash_attention.launches += 1
    return out if inst == hd else out[..., :hd].contiguous()


flash_attention.launches = 0
