"""Wrappers of the CUDA kernels in ``csrc/cada_update.cu``.

Each wrapper checks its operands, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch failed. Each keeps a plain integer count of its launches
(``fused_amsgrad_flat.launches``, ``batched_diff_sq_norm_flat.launches``,
``batched_sq_norm_flat.launches``, ``diff_sq_norm_flat.launches``), so a run
can show that it went through the kernel.

The library is built and loaded at the first launch, never on import.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_F = ctypes.c_float

AMSGRAD_MAX_BLOCKS = 1024   # partials the second pass adds in a fixed order
ROW_CHUNK_ELEMS = 1024      # ~ columns one (row, chunk) block covers
ROW_MAX_CHUNKS = 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("cada_update")
    lib.cada_amsgrad.argtypes = [_P] * 9 + [
        ctypes.c_longlong, ctypes.c_int, _F, _F, _F, _F, _F, _F,
        ctypes.c_int, _P]
    lib.cada_amsgrad.restype = ctypes.c_int
    lib.cada_batched_diff_sq.argtypes = [
        _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P]
    lib.cada_batched_diff_sq.restype = ctypes.c_int
    lib.cada_batched_sq.argtypes = [
        _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, _P]
    lib.cada_batched_sq.restype = ctypes.c_int
    lib.cada_error_string.argtypes = [ctypes.c_int]
    lib.cada_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cada_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _need_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: the CUDA kernel needs a CUDA tensor, "
                           f"got one on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def amsgrad_blocks(n: int) -> int:
    """Blocks of the AMSGrad pass: about one element per thread (256-thread
    blocks), capped so the fixed-order second pass stays one block."""
    return min(_cdiv(n, 256), AMSGRAD_MAX_BLOCKS)


def row_chunks(n: int) -> int:
    """Column chunks per row of the batched norm: a function of n alone, so
    a row's sum never depends on the row count."""
    return min(_cdiv(n, ROW_CHUNK_ELEMS), ROW_MAX_CHUNKS)


def fused_amsgrad_flat(theta, h, vhat, grad, lr, *, b1=0.9, b2=0.999,
                       eps=1e-8):
    """Fused AMSGrad step over (n,) buffers on the card.

    θ and g are fp32; h and v̂ are both fp32 or both bf16 and keep that
    dtype. Returns (θ', h', v̂', Σupd²) with Σupd² a 0-d fp32 tensor.
    """
    name = "fused_amsgrad_flat"
    for t in (theta, h, vhat, grad):
        _need_cuda(name, t)
    if theta.dtype != torch.float32 or grad.dtype != torch.float32:
        raise NotImplementedError(
            f"{name}: θ and g must be fp32 (got {theta.dtype}, {grad.dtype});"
            " bf16 parameters are not ported yet")
    if h.dtype != vhat.dtype or h.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError(f"{name}: h and v̂ must share fp32 or bf16 storage, "
                         f"got {h.dtype} and {vhat.dtype}")
    n = theta.numel()
    if theta.dim() != 1 or n == 0 or any(
            t.shape != theta.shape for t in (h, vhat, grad)):
        raise ValueError(f"{name}: operands must be equal non-empty (n,) "
                         "buffers")
    lib = _lib()
    blocks = amsgrad_blocks(n)
    theta_out = torch.empty_like(theta)
    h_out = torch.empty_like(h)
    vhat_out = torch.empty_like(vhat)
    partials = torch.empty(blocks, dtype=torch.float32, device=theta.device)
    sq = torch.empty((), dtype=torch.float32, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    err = lib.cada_amsgrad(
        theta.data_ptr(), h.data_ptr(), vhat.data_ptr(), grad.data_ptr(),
        theta_out.data_ptr(), h_out.data_ptr(), vhat_out.data_ptr(),
        partials.data_ptr(), sq.data_ptr(), n, blocks, float(lr), b1,
        1.0 - b1, b2, 1.0 - b2, eps, int(h.dtype == torch.bfloat16), stream)
    _check(lib, err, name)
    fused_amsgrad_flat.launches += 1
    return theta_out, h_out, vhat_out, sq


fused_amsgrad_flat.launches = 0


def _need_plane(name: str, t: torch.Tensor) -> None:
    _need_cuda(name, t)
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: planes must be fp32 or bf16, got "
                         f"{t.dtype}")


def _launch_diff_sq(name: str, a, b):
    """(R,) fp32 per-row Σ_j (a_rj − b_rj)² of two (R, n) planes."""
    for t in (a, b):
        _need_plane(name, t)
    if a.dim() != 2 or a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"{name}: need two equal non-empty (R, n) planes, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    rows, n = a.shape
    lib = _lib()
    chunks = row_chunks(n)
    partials = torch.empty((rows, chunks), dtype=torch.float32,
                           device=a.device)
    out = torch.empty(rows, dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.cada_batched_diff_sq(
        a.data_ptr(), b.data_ptr(), partials.data_ptr(), out.data_ptr(),
        rows, n, chunks, int(a.dtype == torch.bfloat16),
        int(b.dtype == torch.bfloat16), stream)
    _check(lib, err, name)
    return out


def batched_diff_sq_norm_flat(a, b):
    """(R,) fp32 per-row Σ_j (a_rj − b_rj)² over two (R, n) planes on the
    card, each fp32 or bf16."""
    out = _launch_diff_sq("batched_diff_sq_norm_flat", a, b)
    batched_diff_sq_norm_flat.launches += 1
    return out


batched_diff_sq_norm_flat.launches = 0


def diff_sq_norm_flat(a, b):
    """Scalar ||a − b||² over two (n,) buffers on the card, as a 0-d fp32
    tensor: the one-row launch of the batched difference norm."""
    name = "diff_sq_norm_flat"
    if a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"{name}: need two equal (n,) buffers, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    out = _launch_diff_sq(name, a.view(1, -1), b.view(1, -1))
    diff_sq_norm_flat.launches += 1
    return out.view(())


diff_sq_norm_flat.launches = 0


def batched_sq_norm_flat(a):
    """(R,) fp32 per-row Σ_j a_rj² over an (R, n) plane on the card, fp32
    or bf16, accumulated in fp32. Same grid and fixed-order second pass as
    the difference norm: a row's value depends neither on R nor on any
    other row."""
    name = "batched_sq_norm_flat"
    _need_plane(name, a)
    if a.dim() != 2 or a.numel() == 0:
        raise ValueError(f"{name}: need a non-empty (R, n) plane, got "
                         f"{tuple(a.shape)}")
    rows, n = a.shape
    lib = _lib()
    chunks = row_chunks(n)
    partials = torch.empty((rows, chunks), dtype=torch.float32,
                           device=a.device)
    out = torch.empty(rows, dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.cada_batched_sq(a.data_ptr(), partials.data_ptr(),
                              out.data_ptr(), rows, n, chunks,
                              int(a.dtype == torch.bfloat16), stream)
    _check(lib, err, name)
    batched_sq_norm_flat.launches += 1
    return out


batched_sq_norm_flat.launches = 0
