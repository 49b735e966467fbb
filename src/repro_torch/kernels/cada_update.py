"""Wrappers of the CUDA kernels in ``csrc/cada_update.cu``.

Each wrapper checks its operands (device, dtype, shape, contiguity; every
operand on one card, else it raises by name), allocates its outputs with
``torch.empty``, launches one kernel on PyTorch's current stream of the
operands' card, with that card current, and raises if the launch
failed. The kernels' partial sums
and ticket counters live in a workspace that is allocated and zeroed once
per (device, stream) and reused (:func:`workspace`); eq. (3)'s row mean
needs none. Each wrapper keeps a plain integer count of its launches
(``fused_amsgrad_flat.launches``, ``batched_diff_sq_norm_flat.launches``,
``batched_sq_norm_flat.launches``, ``diff_sq_norm_flat.launches``,
``eq3_row_mean_flat.launches``), so a run can show that it went through
the kernel.

The launch plan is a function of n alone (:func:`amsgrad_blocks`,
:func:`row_chunks`); the operands' alignment only decides whether a pack
of elements is moved as vectors or as scalars (:func:`vector_ok`), which
changes no result bit.

The library is built and loaded at the first launch, never on import.
"""
from __future__ import annotations

import ctypes
import functools
import operator

import numpy as np
import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
_L = ctypes.c_longlong

THREADS = 256               # threads per block
AMSGRAD_PACK = 4            # elements a thread moves as one pack: AMSGrad
ROW_PACK = 8                # ... and the row norms (csrc/cada_update.cu)
AMSGRAD_MAX_BLOCKS = 1024   # the last block adds <= 4 partials per thread
ROW_MAX_CHUNKS = 256        # the last block of a row adds <= 1 per thread
FLOATS = (torch.float32, torch.bfloat16)

# flags of cada_amsgrad (csrc/cada_update.cu)
_THETA_BF16, _GRAD_BF16, _MOMENTS_BF16, _VEC = 1, 2, 4, 8


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("cada_update")
    lib.cada_amsgrad.argtypes = [_P] * 10 + [_L, _I] + [_F] * 6 + [_I, _P]
    lib.cada_amsgrad.restype = _I
    lib.cada_batched_diff_sq.argtypes = [_P] * 5 + [_L, _L, _I, _I, _I, _I,
                                                    _P]
    lib.cada_batched_diff_sq.restype = _I
    lib.cada_batched_sq.argtypes = [_P] * 4 + [_L, _L, _I, _I, _I, _P]
    lib.cada_batched_sq.restype = _I
    lib.cada_row_mean.argtypes = [_P, _P, _L, _L, _F, _I, _I, _I, _P]
    lib.cada_row_mean.restype = _I
    lib.cada_error_string.argtypes = [_I]
    lib.cada_error_string.restype = ctypes.c_char_p
    return lib


def _stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on CUDA device ``index``
    (PyTorch's own C accessor: one call, no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cada_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _need_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raises unless every tensor is a contiguous CUDA tensor, all on the
    first one's device."""
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"{name}: the CUDA kernel needs a CUDA "
                               f"tensor, got one on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: operands on {tensors[0].device} and "
                             f"{t.device}; they must share one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand must be contiguous")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def amsgrad_blocks(n: int) -> int:
    """Blocks of the AMSGrad pass: one pack of AMSGRAD_PACK elements per
    thread (256-thread blocks) up to AMSGRAD_MAX_BLOCKS, then a grid-stride
    loop. A function of n alone."""
    return min(_cdiv(_cdiv(n, AMSGRAD_PACK), THREADS), AMSGRAD_MAX_BLOCKS)


def row_chunks(n: int) -> int:
    """Column chunks per row of the batched norms: one pack of ROW_PACK
    elements per thread up to ROW_MAX_CHUNKS. A function of n alone, so a
    row's sum never depends on the row count."""
    return min(_cdiv(_cdiv(n, ROW_PACK), THREADS), ROW_MAX_CHUNKS)


def _aligned(ptrs) -> bool:
    return functools.reduce(operator.or_, ptrs, 0) % 16 == 0


def vector_ok(*tensors) -> bool:
    """Whether every operand starts on 16 bytes, so that a pack moves as
    16-byte vectors (any tensor's data_ptr works, on any device)."""
    return _aligned(t.data_ptr() for t in tensors)


def rows_vector_ok(*planes) -> bool:
    """Whether every row of each contiguous (R, n) plane starts on 16
    bytes: the plane does, and so does a row's length in bytes unless
    R = 1."""
    return vector_ok(*planes) and all(
        t.shape[0] == 1 or t.shape[1] * t.element_size() % 16 == 0
        for t in planes)


class _Workspace:
    """Counters (unsigned) and partials (fp32) of one (device, stream), in
    one zeroed int32 buffer that grows to the largest call seen."""

    def __init__(self, device, counters: int, partials: int):
        self.counters, self.partials = counters, partials
        self.buf = torch.zeros(counters + partials, dtype=torch.int32,
                               device=device)
        ptr = self.buf.data_ptr()
        self.pointers = (ptr, ptr + 4 * counters)


_WORKSPACES: dict[tuple[int, int], _Workspace] = {}


def workspace(device: torch.device, stream: int, counters: int,
              partials: int) -> tuple[int, int]:
    """Pointers to ``counters`` zeroed ticket counters and room for
    ``partials`` fp32 partial sums on ``device``, for launches on the raw
    stream handle ``stream``. The buffer is allocated and zeroed once per
    (device, stream) and reused: each launch leaves its counters at 0, and
    launches on one stream never overlap, while two streams never share a
    counter. It is replaced by a larger one only when a call needs more
    room (the old one is freed in stream order)."""
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.counters < counters or ws.partials < partials:
        grow = (max(counters, 64), max(partials, 4096))
        if ws is not None:
            grow = (max(grow[0], ws.counters), max(grow[1], ws.partials))
        ws = _WORKSPACES[key] = _Workspace(device, *grow)
    return ws.pointers


def fused_amsgrad_flat(theta, h, vhat, grad, lr, *, b1=0.9, b2=0.999,
                       eps=1e-8):
    """Fused AMSGrad step over (n,) buffers on the card, one launch.

    θ and g are each fp32 or bf16; θ' keeps θ's dtype. h and v̂ are both
    fp32 or both bf16 and keep that dtype. Returns (θ', h', v̂', Σupd²)
    with Σupd² a 0-d fp32 tensor summed from the fp32 update.
    """
    name = "fused_amsgrad_flat"
    _need_cuda(name, theta, h, vhat, grad)
    if theta.dtype not in FLOATS or grad.dtype not in FLOATS:
        raise ValueError(f"{name}: θ and g must be fp32 or bf16, got "
                         f"{theta.dtype} and {grad.dtype}")
    if h.dtype != vhat.dtype or h.dtype not in FLOATS:
        raise ValueError(f"{name}: h and v̂ must share fp32 or bf16 storage, "
                         f"got {h.dtype} and {vhat.dtype}")
    n, shape = theta.numel(), theta.shape
    if (len(shape) != 1 or n == 0 or h.shape != shape
            or vhat.shape != shape or grad.shape != shape):
        raise ValueError(f"{name}: operands must be equal non-empty (n,) "
                         "buffers")
    dev = theta.device
    lib, stream = _lib(), _stream(dev.index)
    blocks = amsgrad_blocks(n)
    counter, partials = workspace(dev, stream, 1, blocks)
    theta_out = torch.empty_like(theta)
    h_out = torch.empty_like(h)
    vhat_out = torch.empty_like(vhat)
    sq = torch.empty((), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (theta, h, vhat, grad, theta_out, h_out,
                                   vhat_out)]
    bf16 = torch.bfloat16
    flags = ((_THETA_BF16 if theta.dtype == bf16 else 0)
             | (_GRAD_BF16 if grad.dtype == bf16 else 0)
             | (_MOMENTS_BF16 if h.dtype == bf16 else 0)
             | (_VEC if _aligned(ptrs) else 0))
    with torch.cuda.device(dev):
        err = lib.cada_amsgrad(*ptrs, counter, partials, sq.data_ptr(), n,
                               blocks, float(lr), b1, 1.0 - b1, b2,
                               1.0 - b2, eps, flags, stream)
    _check(lib, err, name)
    fused_amsgrad_flat.launches += 1
    return theta_out, h_out, vhat_out, sq


fused_amsgrad_flat.launches = 0


def _need_plane(name: str, *planes: torch.Tensor) -> None:
    _need_cuda(name, *planes)
    for t in planes:
        if t.dtype not in FLOATS:
            raise ValueError(f"{name}: planes must be fp32 or bf16, got "
                             f"{t.dtype}")


def _launch_diff_sq(name: str, a, b):
    """(R,) fp32 per-row Σ_j (a_rj − b_rj)² of two (R, n) planes."""
    _need_plane(name, a, b)
    if a.dim() != 2 or a.shape != b.shape or a.numel() == 0:
        raise ValueError(f"{name}: need two equal non-empty (R, n) planes, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    rows, n = a.shape
    lib, stream = _lib(), _stream(a.device.index)
    chunks = row_chunks(n)
    counters, partials = workspace(a.device, stream, rows, rows * chunks)
    out = torch.empty(rows, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.cada_batched_diff_sq(
            a.data_ptr(), b.data_ptr(), counters, partials, out.data_ptr(),
            rows, n, chunks, a.dtype == torch.bfloat16,
            b.dtype == torch.bfloat16, rows_vector_ok(a, b), stream)
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
    or bf16, accumulated in fp32. The difference norm's kernel with one
    operand: a row's value depends neither on R nor on any other row."""
    name = "batched_sq_norm_flat"
    _need_plane(name, a)
    if a.dim() != 2 or a.numel() == 0:
        raise ValueError(f"{name}: need a non-empty (R, n) plane, got "
                         f"{tuple(a.shape)}")
    rows, n = a.shape
    lib, stream = _lib(), _stream(a.device.index)
    chunks = row_chunks(n)
    counters, partials = workspace(a.device, stream, rows, rows * chunks)
    out = torch.empty(rows, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.cada_batched_sq(a.data_ptr(), counters, partials,
                                  out.data_ptr(), rows, n, chunks,
                                  a.dtype == torch.bfloat16,
                                  rows_vector_ok(a), stream)
    _check(lib, err, name)
    batched_sq_norm_flat.launches += 1
    return out


batched_sq_norm_flat.launches = 0


MEAN_MAX_BLOCKS = 1 << 20   # then a grid-stride loop


def mean_blocks(n: int) -> int:
    """Blocks of eq. (3)'s row mean: one pack of ROW_PACK columns per
    thread. No sum crosses threads, so the grid changes no bit."""
    return min(_cdiv(_cdiv(n, ROW_PACK), THREADS), MEAN_MAX_BLOCKS)


def eq3_row_mean_flat(plane, m_total: int):
    """Eq. (3)'s aggregate increment on the card, one launch: the (n,) fp32
    Σ_rows(plane) · fp32(1)/fp32(m_total) of an (R, n) fp32 or bf16 plane,
    the rows added in descending order from +0.0, bit-equal to
    ``ref.eq3_row_mean_ref``."""
    name = "eq3_row_mean_flat"
    _need_plane(name, plane)
    if plane.dim() != 2 or plane.numel() == 0:
        raise ValueError(f"{name}: need a non-empty (R, n) plane, got "
                         f"{tuple(plane.shape)}")
    if int(m_total) < 1:
        raise ValueError(f"{name}: m_total must be >= 1, got {m_total}")
    rows, n = plane.shape
    rcp = float(np.float32(1.0) / np.float32(m_total))
    lib, stream = _lib(), _stream(plane.device.index)
    out = torch.empty(n, dtype=torch.float32, device=plane.device)
    with torch.cuda.device(plane.device):
        err = lib.cada_row_mean(plane.data_ptr(), out.data_ptr(), rows, n,
                                rcp, mean_blocks(n),
                                plane.dtype == torch.bfloat16,
                                rows_vector_ok(plane) and vector_ok(out),
                                stream)
    _check(lib, err, name)
    eq3_row_mean_flat.launches += 1
    return out


eq3_row_mean_flat.launches = 0
