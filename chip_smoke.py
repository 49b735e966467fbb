"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):
  1. card: the card's name and power limit, torch and CUDA versions;
     compute capability 9.0 is required (the kernels are built for sm_90a).
  2. build: every CUDA kernel, from the sources in this checkout.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (n_flat = 101,776 and (10, 101,776) planes) and
     at the logreg's n_flat = 48, in fp32 and bf16: error, run-to-run
     identity of the sums, row independence, and for kernel and plain
     version the time per call (CUDA events around 50 back-to-back calls,
     median of 5) and the device time (profiler), beside the bound and,
     where one PyTorch call computes the same function, that call's time.
     The AMSGrad step is bit-equal to its plain version for θ and g in fp32
     and bf16 and moments in fp32 and bf16, also on views that start off
     16 bytes (bit-equal to aligned copies); every CADA kernel runs as one
     launch per call (profiler). The server step and the one-operand norm
     are also timed at LM widths (n = 2^28; (10, 2^24)), where bytes bound
     them. The wire compressors (plain PyTorch) must give the CPU's bits.
  4. main path: ``CADAEngine`` on the paper MLP 784→128→10 (M=10, batch 12,
     mnist_like(4096), d_max=10, max_delay=50, c=1.0), each rule at its
     reference defaults on FusedAMSGrad(lr=5e-4): 200 rounds each of always
     and cada2, 50 each of lag, cada1, cinn, laq, topk and avp; and
     lag on SGD(0.05) as the paper runs it, 50 rounds. Every gated rule
     must skip an upload and upload again after it: one that does not at
     c = 1 runs again, 60 rounds, at a c where its gate skips
     (``skip_c``). Every kernel's launch count is read around each run and
     must be exact. Then profiles of 20 rounds each of cada2, laq and topk
     (device-busy share, the kernels that take the time).
  5. plain lockstep: 20 cada2 rounds at c = 1 and 20 each of laq and topk
     at their skipping c, each stepped from the kernel run's state by the
     kernels and by the plain versions (``impl="plain"``); each must see a
     skip.
  6. serving path: zamba2-2.7b at full width and depth (54 Mamba2 layers,
     the shared attention block 9 times, 2,340,715,680 bf16 parameters
     drawn on the card from a seed) through ``repro_torch.launch.serve``:
     prefill of 2 random prompts of 2048 tokens, then 32 greedy decode
     steps. Exactly 54 scan and 9 flash launches per prefill and none per
     decode step; prefill ms, decode tokens/s and peak memory; a profile
     of a warm prefill and of decode steps; full-depth logits finite, and
     prefill(S-1) -> decode(1) against prefill(S). Then the first stage (6
     Mamba2 layers and the shared block, full width) run with the kernels
     and with ``impl="plain"``: last logits, SSM/conv states and KV cache
     within a stated band.
  7. training path: the LM trainer (``repro_torch.distributed.trainer``)
     a. stablelm-1.6b at its published width with 4 of its 24 layers (the
        one cut: the (M, n_flat) fp32 planes of the round do not fit 80 GB
        at full depth), 616,581,120 bf16 parameters drawn on the card,
        remat on; cada2 (c = 1, d_max = 10, max_delay = 50), M = 2, lr
        3e-4, 8 steps of 4 × 2048 tokens from ``make_token_batches``.
        Every loss finite, every state tensor on the card, step 0 uploads
        from both workers, exactly one AMSGrad and one two-operand norm
        launch per step and nothing else; per-step time (CUDA events),
        peak memory, and a profile of 2 more steps. Then on the trainer's
        own operands: AMSGrad on its packed θ, h, v̂ and ∇ (θ', h', v̂'
        bit-equal to ``impl="plain"``, Σupd² within SUM_RTOL) and the
        two-operand norm on the next step's (2, n_flat) fresh and second
        planes (within SUM_RTOL), each timed beside its bound.
     b. every rule kind for 3 steps on stablelm's smoke config, M = 2:
        finite losses and the exact launches per kind (the one-operand
        norm for cinn, laq and topk).
Phase 3 also holds the selective scan and flash attention against their
plain versions at the serving path's shapes, with their times beside
their device times before their redesign, their bounds and, for flash,
the library call's time: the scan in the served form (Mamba2's A, a
stride-0 view on N: one decay per channel; h_final bit-equal to the same
call with A materialised) and untimed with a general A, also at
falcon-mamba-7b's widths (device time printed); flash in bf16 on the
tensor cores, at a GQA shape and with a window, and in fp32 and bf16 at hd
16 and 64 and zero-padded at hd 48 and 96. Then it prints one JSON line
with every kernel, and last the line
``{"ok": true, "device": {...}}``. With no CUDA device, or outside the
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.core import flat  # noqa: E402
from repro_torch.core.comm import strategy_for  # noqa: E402
from repro_torch.core.engine import CADAEngine, make_sampler  # noqa: E402
from repro_torch.core.rules import RULES, CommRule  # noqa: E402
from repro_torch.data import (mnist_like, pad_to_matrix,  # noqa: E402
                              uniform_partition)
from repro_torch.kernels import build, cada_update, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import ssm_scan as scan_kernel  # noqa: E402
from repro_torch.distributed import trainer  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import make_token_batches  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models.config import param_count  # noqa: E402
from repro_torch.models.small import mlp_init, mlp_loss  # noqa: E402
from repro_torch.optim.fused import FusedAMSGrad  # noqa: E402
from repro_torch.optim.sgd import sgd  # noqa: E402

M, BATCH, N_DATA = 10, 12, 4096
DIMS = (784, 128, 10)
# run name: (rule kind, rounds, server optimizer: "fused" or "sgd")
D_MAX, MAX_DELAY = 10, 50
# a rerun at a skipping c outlasts the staleness cap, so a worker that
# stops uploading is made to upload again at the latest in round MAX_DELAY
SKIP_ROUNDS = MAX_DELAY + D_MAX
MAIN_RUNS = {"always": ("always", 200, "fused"),
             "cada2": ("cada2", 200, "fused"),
             "lag": ("lag", 50, "fused"),
             "cada1": ("cada1", 50, "fused"),
             "cinn": ("cinn", 50, "fused"),
             "laq": ("laq", 50, "fused"),
             "topk": ("topk", 50, "fused"),
             "avp": ("avp", 50, "fused"),
             "lag-sgd": ("lag", 50, "sgd")}
DIFF_RULES = ("lag", "cada1", "cada2", "avp")   # gate: batched_diff_sq
SQ_RULES = ("cinn", "laq", "topk")              # gate: batched_sq
LOCKSTEP_ROUNDS = 20
ULP_SCALE = 2.0 ** -20   # elementwise tolerance: 8 ULP at the array's scale
SUM_RTOL = 1e-5          # sums in another order
NORM_RTOL = 1e-6         # the one-operand and scalar norms, ditto
MARGIN_BAND = 1e-5       # gate margin inside which kernel/plain may differ
LIBRARY_NOTE = {
    "amsgrad": "no single PyTorch call computes this step: "
               "torch._fused_adam_ applies bias correction, puts eps outside "
               "the root and returns no sum of squared updates",
    "batched_diff_sq": "no single PyTorch call computes row-wise squared "
                       "distances: pairwise_distance adds eps and takes a "
                       "root, cdist computes every pair of rows",
    "batched_sq": "torch.linalg.vecdot(a, a), timed here",
    "diff_sq": "torch.nn.functional.mse_loss(a, b, reduction='sum'), "
               "timed here",
    "selective_scan": "no single PyTorch call computes a selective scan: "
                      "torch has no linear-recurrence (associative) scan, "
                      "and cumsum/cumprod forms materialise the (G, S, D, "
                      "N) trajectory the kernel exists to avoid",
    "flash_attention": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True) on (B, H, S, hd), timed here",
}
# serving path (phase 6): zamba2-2.7b, full width and depth
SERVE_ARCH, SERVE_BATCH, SERVE_SEQ, SERVE_TOKENS = "zamba2-2.7b", 2, 2048, 32
SCAN_RTOL = 1e-5          # scan kernel vs plain, of each array's scale:
#                           fp32; the N-sum's order (its rounding scales
#                           with the terms, and y_t can cancel to near 0)
FLASH_RTOL_F32 = 1e-5     # flash kernel vs plain, fp32: sum orders
FLASH_RTOL_BF16 = 2.0 ** -8   # bf16 output: one bf16 ULP below |o| = 1;
#   where |o| >= 1 the tensor-core kernel (its scores and P differ from the
#   plain version's at the fp32 level) may round to the other bf16
#   neighbour, so an element outside this band must be a single rounding
#   flip: within one bf16 ULP of the plain result computed in fp32
#   (flash_bf16_gaps; PERF.md §6 has the measured counts)
# the two redesigned kernels' device times at the served shapes before
# their redesign (the per-state scan and the CUDA-core flash kernel;
# PERF.md §6, NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_DEVICE_MS = {"selective_scan": 1.895, "flash_attention": 1.990,
                     # the CADA server step and one-operand norm before
                     # their one-launch redesign (PR 15, run b)
                     "amsgrad": 0.00380, "batched_sq": 0.00455}
LM_N = 2 ** 28           # AMSGrad at an LM width: 7.52 GB moved in fp32
LM_ROW_N = 2 ** 24       # batched_sq (M, 2^24) fp32: 0.671 GB
STAGE_RTOL_F32 = 1e-4     # first stage, fp32, kernels vs plain: the
#                           kernels' ~1e-6 gaps through 7 blocks of fp32
#                           GEMMs and nonlinearities, no rounding to bf16
DECODE_ATOL = DECODE_RTOL = 0.05   # prefill(S-1)+decode vs prefill(S),
#                                    fp32: the reference's test's band
# training path (phase 7): stablelm-1.6b at full width, 4 of 24 layers
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_PARAMS = "stablelm-1.6b", 4, 616_581_120
TRAIN_M, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4, 2048, 8
TRAIN_PROFILE_STEPS = 2
TRAIN_RULE = dict(c=1.0, d_max=10, max_delay=50)   # examples/train_lm_cada.py
TRAIN_LR = 3e-4
SMOKE_TRAIN_STEPS = 3
# kinds of device kernel in a trainer step's profile: a kernel goes to the
# first group whose key its name holds (fp32 GEMMs before the rest), and
# to the last group, PyTorch's other eager kernels, when none does
TRAIN_KERNEL_GROUPS = {"amsgrad_kernel": ("amsgrad_kernel",),
                       "row_sq_kernel": ("row_sq_kernel",),
                       "fp32 GEMMs": ("f32f32_f32", "sgemm"),
                       "other GEMMs": ("gemm", "nvjet", "cutlass"),
                       "softmax": ("softmax", "SoftMax"),
                       "reductions": ("reduce_kernel",),
                       "copies and casts": ("copy_kernel",),
                       "other elementwise": ()}


# ------------------------------------------------------------------ card

SXM_NAME = "H100 80GB HBM3"
SXM_RATES = (3.35e12, 67e12)   # bytes/s, fp32 FLOP/s outside the tensor cores
BF16_TC_FLOPS = 989e12         # dense bf16 on the tensor cores (data sheet)
# special-function unit results (exp) per second: 16 per clock per SM, 132
# SMs, at the H100 SXM's 1,980 MHz boost clock (Hopper architecture paper)
SFU_RATE = 16 * 132 * 1.98e9


def card_rates(name: str) -> tuple[float, float]:
    """The H100 SXM's published peaks (NVIDIA's data sheet); raises on any
    other part, whose bounds would need its own rates."""
    if SXM_NAME not in name:
        raise RuntimeError(f"{name!r}: bounds are stated for the "
                           f"{SXM_NAME} (H100 SXM) only")
    return SXM_RATES


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on "
                         "the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {name}  capability {cap}  count "
          f"{torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}: the kernels are "
                           "built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------- timing

def time_ms(fn, calls: int = 50, repeats: int = 5, warmup: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``calls`` back-to-back
    calls, by CUDA events (warm L2: the main path's operands fit in it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def device_ms(fn, names: tuple[str, ...] | None = None,
              calls: int = 20) -> float | None:
    """Device time of one call, from the profiler; None when it records no
    device time. With ``names``: the median over the launches it recorded
    of the kernels whose names hold one of them (each such call launches
    one; a median holds when the profiler drops or mistimes a launch);
    else every kernel's time summed over the window, per call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    if names is not None:
        durations = [e.time_range.elapsed_us() for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and any(n in e.name for n in names)]
        return statistics.median(durations) / 1e3 if durations else None
    tot = sum(getattr(e, "device_time_total", 0)
              for e in prof.key_averages())
    return tot / calls / 1e3 if tot > 0 else None


def _us(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.3f} us"


def _ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


# ---------------------------------------------------------------- kernels

def _max_rel(a, b):
    return float(((a.double() - b.double()).abs()
                  / b.double().abs().clamp_min(1e-30)).max())


def _bound(nbytes: int, flops: int, rates) -> tuple[float, str]:
    """The least time for the work (ms) and what sets it."""
    t_bytes, t_ops = nbytes / rates[0], flops / rates[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def one_launch(fn, kernel: str, label: str, calls: int = 5) -> None:
    """Raises unless ``calls`` calls of ``fn`` launched ``kernel`` and no
    other CUDA kernel, at most once per call (profiler events, which may
    miss a launch at the profiler's start but never add one): no second
    pass, no per-call zeroing of the workspace."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):    # a window that recorded nothing says nothing
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    if not 1 <= len(names) <= calls or not all(kernel in nm
                                               for nm in names):
        raise RuntimeError(f"{label}: {calls} calls launched {names}")


def _amsgrad_operands(n, theta_dtype, moment_dtype, grad_dtype, gen,
                      offset=0):
    """θ, h, v̂, g of length n; with ``offset`` > 0 each a contiguous view
    that starts that many elements into a larger buffer."""
    def draw(scale, dtype, nonneg=False):
        x = scale * torch.randn(n + offset, generator=gen, device="cuda")
        return (x.abs() if nonneg else x).to(dtype)[offset:]
    return (draw(1.0, theta_dtype), draw(0.1, moment_dtype),
            draw(0.01, moment_dtype, nonneg=True), draw(1.0, grad_dtype))


def _short(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


def check_amsgrad(n: int, moment_dtype, rates, gen, theta_dtype=torch.float32,
                  grad_dtype=torch.float32, offset: int = 0,
                  timed: bool = True, calls: int = 50, operands=None,
                  lr: float = 5e-4) -> dict:
    """The AMSGrad kernel against its plain version: θ', h', v̂' bit for bit,
    Σupd² within SUM_RTOL and the same on two calls, one launch per call.
    The operands are drawn from ``gen``, or are ``operands`` (θ, h, v̂, g,
    whose dtypes the other arguments then name). With ``offset``, the
    operands are views that start off 16 bytes (the scalar loads) and
    Σupd² must also equal, bit for bit, that of aligned copies (the vector
    loads)."""
    theta, h, vhat, grad = operands or _amsgrad_operands(
        n, theta_dtype, moment_dtype, grad_dtype, gen, offset)
    label = (f"amsgrad n={n} theta/g/moments={_short(theta_dtype)}/"
             f"{_short(grad_dtype)}/{_short(moment_dtype)}"
             + (f", views {offset} element(s) off 16 B" if offset else ""))
    k_out = cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)
    k_again = cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)
    p_out = ref.amsgrad_ref(theta, h, vhat, grad, lr)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out, k_again)):
        raise RuntimeError(f"{label}: two identical calls differ")
    for what, kk, pp in zip(("theta", "h", "vhat"), k_out, p_out):
        if kk.dtype != pp.dtype or not torch.equal(kk, pp):
            raise RuntimeError(
                f"{label}: {what}' is not bit-equal to the plain version's "
                f"(max |err| {float((kk.float() - pp.float()).abs().max())})")
    sq_err = abs(float(k_out[3]) - float(p_out[3]))
    if sq_err > SUM_RTOL * float(p_out[3]):
        raise RuntimeError(f"{label}: sum upd^2 {float(k_out[3])} vs plain "
                           f"{float(p_out[3])}")
    note = ""
    if offset:
        copies = tuple(t.clone() for t in (theta, h, vhat, grad))
        if cada_update.vector_ok(theta, h, vhat, grad) or \
                not cada_update.vector_ok(*copies):
            raise RuntimeError(f"{label}: the views' alignment is not as "
                               "set up")
        aligned = cada_update.fused_amsgrad_flat(*copies, lr)
        if not all(torch.equal(a, b) for a, b in zip(k_out, aligned)):
            raise RuntimeError(f"{label}: differs from aligned copies")
        note = ", every output bit-equal to aligned copies' (vector loads)"

    def kernel():
        return cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)

    one_launch(kernel, "amsgrad_kernel", label)
    head = (f"  {label}: theta', h', vhat' bit-equal to plain, sum upd^2 "
            f"{float(k_out[3]):.9g} vs plain {float(p_out[3]):.9g} (rel "
            f"{_max_rel(k_out[3], p_out[3]):.3g}), run-to-run identical, one "
            f"launch per call{note}")
    if not timed:
        print(head)
        return {"max_abs_err": sq_err}
    tsz, msz, gsz = (torch.empty((), dtype=d).element_size()
                     for d in (theta_dtype, moment_dtype, grad_dtype))
    # read θ, h, v̂, g; write θ', h', v̂' and Σupd²
    nbytes = n * (tsz + 2 * msz + gsz) + n * (tsz + 2 * msz) + 4
    # mul/add/max/div/sqrt per element
    bound, bound_by = _bound(nbytes, 14 * n, rates)

    def plain():
        return ref.amsgrad_ref(theta, h, vhat, grad, lr)

    big = calls < 50
    ms = time_ms(kernel, calls=calls, repeats=5 if not big else 3)
    plain_ms = time_ms(plain, calls=calls if not big else 2,
                       repeats=5 if not big else 3, warmup=5 if not big else 1)
    dev = device_ms(kernel, ("amsgrad_kernel",), calls=20 if not big else 5)
    plain_dev = device_ms(plain, calls=20 if not big else 2)
    before = "" if big or theta_dtype != torch.float32 else (
        f"; before the redesign {EARLIER_DEVICE_MS['amsgrad']} ms, PERF.md")
    print(f"{head}; kernel {ms * 1e3:.2f} us/call (device {_us(dev)}"
          f"{before}), plain {plain_ms * 1e3:.2f} us/call (device "
          f"{_us(plain_dev)}), bound {bound * 1e3:.3f} us ({nbytes} B; "
          f"device at {_share(bound, dev)} of it)")
    return {"max_abs_err": sq_err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by}


def _share(bound: float, dev: float | None) -> str:
    return "not measured" if not dev else f"{100 * bound / dev:.1f}%"


def check_batched(rows: int, n: int, a_dtype, b_dtype, rates, gen,
                  planes=None, calls: int = 50) -> dict:
    """The two-operand row norm (the gate of lag, cada1, cada2 and avp)
    against its plain version on two (rows, n) planes drawn from ``gen``,
    or on ``planes``: rows within SUM_RTOL, the same on two calls, each row
    bit-equal in a launch over fewer rows, one launch per call."""
    if planes is None:
        planes = (torch.randn(rows, n, generator=gen,
                              device="cuda").to(a_dtype),
                  torch.randn(rows, n, generator=gen,
                              device="cuda").to(b_dtype))
    a, b = planes
    lo = min(2, rows - 1)
    k = cada_update.batched_diff_sq_norm_flat(a, b)
    k_again = cada_update.batched_diff_sq_norm_flat(a, b)
    part = cada_update.batched_diff_sq_norm_flat(a[lo:lo + 3].contiguous(),
                                                 b[lo:lo + 3].contiguous())
    p = ref.batched_diff_sq_norm_ref(a, b)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"batched ({rows},{n}): two identical calls "
                           "differ")
    if not torch.equal(k[lo:lo + 3], part):
        raise RuntimeError(f"batched ({rows},{n}): rows depend on R")
    err = float((k - p).abs().max())
    rel = _max_rel(k, p)
    if rel > SUM_RTOL:
        raise RuntimeError(f"batched ({rows},{n}): rel err {rel}")
    nbytes = rows * n * (a.element_size() + b.element_size()) + rows * 4
    bound, bound_by = _bound(nbytes, 3 * rows * n, rates)
    def kernel():
        return cada_update.batched_diff_sq_norm_flat(a, b)

    def plain():
        return ref.batched_diff_sq_norm_ref(a, b)

    one_launch(kernel, "row_sq_kernel", f"batched_diff_sq ({rows},{n})")
    reps, dcalls = (5, 20) if calls >= 50 else (3, 5)
    ms = time_ms(kernel, calls=calls, repeats=reps)
    plain_ms = time_ms(plain, calls=calls, repeats=reps)
    dev = device_ms(kernel, ("row_sq_kernel",), calls=dcalls)
    plain_dev = device_ms(plain, calls=dcalls)
    print(f"  batched_diff_sq ({rows},{n}) {str(a_dtype)[6:]}/"
          f"{str(b_dtype)[6:]}: max|err| {err:.3g} (rel {rel:.3g}), "
          f"run-to-run identical, rows independent of R, one launch per "
          f"call; kernel "
          f"{ms * 1e3:.2f} us/call (device {_us(dev)}), plain "
          f"{plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), bound "
          f"{bound * 1e3:.3f} us ({nbytes} B; device at {_share(bound, dev)} "
          "of it)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by}


def check_batched_sq(rows: int, n: int, dtype, rates, gen,
                     calls: int = 50) -> dict:
    """The one-operand row norm (cinn/laq/topk's gate): rows bit-equal in
    an (R, n) and a (1, n) launch, the same on two calls, one launch per
    call."""
    a = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
    k = cada_update.batched_sq_norm_flat(a)
    k_again = cada_update.batched_sq_norm_flat(a)
    part = cada_update.batched_sq_norm_flat(a[2:5].contiguous())
    alone = cada_update.batched_sq_norm_flat(a[3:4].clone())
    p = ref.batched_sq_norm_ref(a)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"batched_sq ({rows},{n}): two identical calls "
                           "differ")
    if not (torch.equal(k[2:5], part) and torch.equal(k[3:4], alone)):
        raise RuntimeError(f"batched_sq ({rows},{n}): rows depend on R")
    err, rel = float((k - p).abs().max()), _max_rel(k, p)
    if rel > NORM_RTOL:
        raise RuntimeError(f"batched_sq ({rows},{n}): rel err {rel}")
    nbytes = rows * n * a.element_size() + rows * 4
    bound, bound_by = _bound(nbytes, 2 * rows * n, rates)

    def kernel():
        return cada_update.batched_sq_norm_flat(a)

    def plain():
        return ref.batched_sq_norm_ref(a)

    def library():
        return torch.linalg.vecdot(a, a)

    one_launch(kernel, "row_sq_kernel", f"batched_sq ({rows},{n})")
    big = calls < 50
    reps, dcalls = (3, 5) if big else (5, 20)
    ms = time_ms(kernel, calls=calls, repeats=reps)
    plain_ms = time_ms(plain, calls=calls, repeats=reps)
    lib_ms = time_ms(library, calls=calls, repeats=reps)
    dev = device_ms(kernel, ("row_sq_kernel",), calls=dcalls)
    plain_dev = device_ms(plain, calls=dcalls)
    lib_dev = device_ms(library, calls=dcalls)
    before = "" if big or dtype != torch.float32 else (
        f"; before the redesign {EARLIER_DEVICE_MS['batched_sq']} ms, "
        "PERF.md")
    print(f"  batched_sq ({rows},{n}) {str(dtype)[6:]}: max|err| {err:.3g} "
          f"(rel {rel:.3g}), run-to-run identical, rows independent of R "
          f"((R, n) vs (1, n)), one launch per call; kernel "
          f"{ms * 1e3:.2f} us/call (device {_us(dev)}{before}), plain "
          f"{plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), "
          f"torch.linalg.vecdot {lib_ms * 1e3:.2f} us/call (device "
          f"{_us(lib_dev)}), bound {bound * 1e3:.3f} us ({nbytes} B; "
          f"device at {_share(bound, dev)} of it)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev}


def check_diff_sq(n: int, dtype, rates, gen) -> dict:
    """The scalar ‖a − b‖² (the R = 1 launch of the difference norm)."""
    a = torch.randn(n, generator=gen, device="cuda").to(dtype)
    b = torch.randn(n, generator=gen, device="cuda").to(dtype)
    k = cada_update.diff_sq_norm_flat(a, b)
    k_again = cada_update.diff_sq_norm_flat(a, b)
    p = ref.diff_sq_norm_ref(a, b)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"diff_sq n={n}: two identical calls differ")
    err, rel = float((k - p).abs()), _max_rel(k, p)
    if rel > NORM_RTOL:
        raise RuntimeError(f"diff_sq n={n}: rel err {rel}")
    nbytes = 2 * n * a.element_size() + 4
    bound, bound_by = _bound(nbytes, 3 * n, rates)

    def kernel():
        return cada_update.diff_sq_norm_flat(a, b)

    def plain():
        return ref.diff_sq_norm_ref(a, b)

    def library():
        return torch.nn.functional.mse_loss(a, b, reduction="sum")

    lib = library()
    lib_rel = _max_rel(lib, p)
    if lib_rel > NORM_RTOL:
        raise RuntimeError(f"diff_sq n={n}: mse_loss(sum) {float(lib)} is "
                           f"not the plain version's {float(p)}")
    one_launch(kernel, "row_sq_kernel", f"diff_sq n={n}")
    ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(library)
    dev = device_ms(kernel, ("row_sq_kernel",))
    plain_dev, lib_dev = device_ms(plain), device_ms(library)
    print(f"  diff_sq n={n} {str(dtype)[6:]}: {float(k):.9g} vs plain "
          f"{float(p):.9g} (rel {rel:.3g}), run-to-run identical, one launch "
          f"per call; kernel "
          f"{ms * 1e3:.2f} us/call (device {_us(dev)}), plain "
          f"{plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), "
          f"mse_loss(sum) {lib_ms * 1e3:.2f} us/call (device {_us(lib_dev)}, "
          f"rel {lib_rel:.3g}), bound {bound * 1e3:.3f} us ({nbytes} B)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev}


def check_wire(layout, gen) -> None:
    """The wire compressors are plain PyTorch: on the card they must give
    the CPU's bits (quantizer at 8 and 16 bits, top-k, the sparse round
    trip) at the main path's (10, n_flat) shape."""
    x = torch.randn(M, layout.n_flat, generator=gen, device="cuda")
    x[:, layout.n:] = 0.0
    outs = {f"quantize{b}": (
        flat.per_worker_quantize_dequantize_flat(layout, x, b),
        flat.per_worker_quantize_dequantize_flat(layout, x.cpu(), b))
        for b in (8, 16)}
    sp = flat.per_worker_topk_sparsify_flat(layout, x, 0.1)
    outs["topk"] = (sp, flat.per_worker_topk_sparsify_flat(layout, x.cpu(),
                                                            0.1))
    vals, idx = flat.per_worker_topk_extract_flat(layout, sp, 0.1)
    outs["sparse round trip"] = (
        flat.sparse_rows_to_dense(idx, vals, layout.n_flat), sp)
    for name, (card, want) in outs.items():
        if not torch.equal(card.cpu().view(torch.int32),
                           want.cpu().view(torch.int32)):
            raise RuntimeError(f"wire {name}: the card's bits differ")
    print(f"  wire compressors on the card: {', '.join(outs)} bit-equal to "
          "the CPU's")


def phase_kernels(rates, layout) -> dict:
    n_flat = layout.n_flat
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    main = {"amsgrad": check_amsgrad(n_flat, f32, rates, gen)}
    check_amsgrad(n_flat, bf16, rates, gen)
    check_amsgrad(n_flat, f32, rates, gen, theta_dtype=bf16, grad_dtype=bf16)
    for moments in (f32, bf16):
        check_amsgrad(n_flat, moments, rates, gen, theta_dtype=bf16,
                      grad_dtype=bf16, timed=False)
        check_amsgrad(n_flat, moments, rates, gen, theta_dtype=bf16,
                      offset=1, timed=False)
        check_amsgrad(n_flat, moments, rates, gen, offset=1, timed=False)
        for theta_dtype in (f32, bf16):
            check_amsgrad(48, moments, rates, gen, theta_dtype=theta_dtype,
                          grad_dtype=theta_dtype, timed=False)
    main["batched_diff_sq"] = check_batched(M, n_flat, f32, f32, rates, gen)
    check_batched(M, n_flat, bf16, bf16, rates, gen)
    check_batched(M, n_flat, f32, bf16, rates, gen)
    check_batched(M, 48, f32, f32, rates, gen)
    main["batched_sq"] = check_batched_sq(M, n_flat, f32, rates, gen)
    check_batched_sq(M, n_flat, bf16, rates, gen)
    check_batched_sq(M, 48, f32, rates, gen)
    main["diff_sq"] = check_diff_sq(n_flat, f32, rates, gen)
    check_diff_sq(48, f32, rates, gen)
    check_wire(layout, gen)
    # the two redesigned kernels at LM widths, where bytes bound them
    print(f"  at LM widths (n = {LM_N}; ({M}, {LM_ROW_N}) planes):")
    main["amsgrad"]["lm_width"] = {
        "fp32": check_amsgrad(LM_N, f32, rates, gen, calls=20),
        "bf16 theta and g": check_amsgrad(LM_N, f32, rates, gen,
                                          theta_dtype=bf16, grad_dtype=bf16,
                                          calls=20)}
    main["batched_sq"]["lm_width"] = check_batched_sq(M, LM_ROW_N, f32, rates,
                                                      gen, calls=20)
    torch.cuda.empty_cache()
    return main


# ------------------------------------------- selective scan, flash attention

def _rel_err(got, want) -> float:
    """max |got − want| / max(1, |want|), in fp64."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def _scale_err(got, want) -> float:
    """max |got − want| / max |want|, in fp64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _scan_a(g: int, d: int, n: int, headdim: int, per_channel: bool, gen):
    """A as the models pass it: Mamba2's (one value per head of
    ``headdim`` channels, a zero-stride view on N) or Mamba1's dense
    (D, N); one block shared by the groups as a zero-stride view over G."""
    dev = "cuda"
    if per_channel:
        heads = -(-d // headdim)
        a_h = -(1.0 + 15.0 * torch.rand(heads, generator=gen, device=dev))
        a2 = torch.repeat_interleave(a_h, headdim)[:d, None].expand(d, n)
    else:
        a2 = -torch.randn(d, n, generator=gen, device=dev).abs()
    return a2.expand(g, d, n)


def check_scan(g: int, s: int, d: int, n: int, headdim: int, rates, gen,
               timed: bool, per_channel: bool) -> dict:
    """The scan kernel against its plain version on the serving path's
    operand types: dt fp32, x/B/C bf16; A per channel (one value per head
    of ``headdim`` channels as a zero-stride view on N, the served Mamba2
    form) or general (dense, Mamba1). The
    per-channel form must also give the h_final of the same call with A
    materialised (the general form) bit for bit, and its y within
    SCAN_RTOL."""
    dev = "cuda"
    dt = (0.1 * torch.randn(g, s, d, generator=gen, device=dev)).abs()
    x = torch.randn(g, s, d, generator=gen, device=dev).bfloat16()
    a = _scan_a(g, d, n, headdim, per_channel, gen)
    b = torch.randn(g, s, n, generator=gen, device=dev).bfloat16()
    c = torch.randn(g, s, n, generator=gen, device=dev).bfloat16()
    form = "per-channel A" if per_channel else "general A"
    shape = (g, s, d, n)
    y, h = scan_kernel.selective_scan(dt, x, a, b, c)
    y2, h2 = scan_kernel.selective_scan(dt, x, a, b, c)
    yp, hp = ref.selective_scan_ref(dt, x, a, b, c)
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise RuntimeError(f"scan {shape} {form}: two identical calls "
                           "differ")
    err = max(_scale_err(y, yp), _scale_err(h, hp))
    if err > SCAN_RTOL:
        raise RuntimeError(f"scan {shape} {form}: error {err} > "
                           f"{SCAN_RTOL}")
    label = f"  selective_scan (G,S,D,N)={shape} {form}, x/B/C bf16"
    note = ""
    am = a[0].contiguous().expand(g, d, n)
    if per_channel:
        ym, hm = scan_kernel.selective_scan(dt, x, am, b, c)
        torch.cuda.synchronize()
        if not torch.equal(h, hm):
            raise RuntimeError(f"scan {shape}: h_final differs from the "
                               "materialised-A call")
        y_gap = _scale_err(y, ym)
        if y_gap > SCAN_RTOL:
            raise RuntimeError(f"scan {shape}: y is {y_gap} from the "
                               "materialised-A call")
        note = (f", h_final bit-equal to the materialised-A call (y "
                f"{'bit-equal' if torch.equal(y, ym) else f'{y_gap:.3g}'})")
    abs_err = float(max((y - yp).abs().max(), (h - hp).abs().max()))
    head = (f"{label}: max err {err:.3g} of the plain arrays' scale, "
            f"run-to-run identical{note}")

    def kernel():
        return scan_kernel.selective_scan(dt, x, a, b, c)

    if not timed:
        dev_ms = device_ms(kernel, ("ssm_scan_kernel",), calls=5)
        print(f"{head}; kernel device {_ms(dev_ms)}")
        return {"max_abs_err": abs_err, "device_ms": dev_ms}
    gsd, gsn, elems = g * s * d, g * s * n, g * s * d * n
    # dt fp32, x bf16, A (one value per channel, or per (channel, state)),
    # B/C bf16; y fp32, h_final fp32
    a_bytes = 4 * d * (1 if per_channel else n)
    nbytes = (4 * gsd + 2 * gsd + a_bytes + 2 * 2 * gsn + 4 * gsd
              + 4 * g * d * n)
    # per (g, t, d, n): decay·h + drive, dx·b, h·c: 3 FMA-class operations
    # (6 flops); one exponential per (g, t, d) or per (g, t, d, n)
    n_exp = gsd if per_channel else elems
    t_bytes, t_flops, t_exp = (nbytes / rates[0], 6 * elems / rates[1],
                               n_exp / SFU_RATE)
    bound = max(t_bytes, t_flops, t_exp) * 1e3
    bound_by = "bytes" if t_bytes >= max(t_flops, t_exp) else "operations"

    def plain():
        return ref.selective_scan_ref(dt, x, a, b, c)

    def materialised():
        return scan_kernel.selective_scan(dt, x, am, b, c)

    ms = time_ms(kernel, calls=10, repeats=3)
    plain_ms = time_ms(plain, calls=1, repeats=3, warmup=1)
    dev_ms = device_ms(kernel, ("ssm_scan_kernel",), calls=5)
    plain_dev = device_ms(plain, calls=1)
    extra = ""
    if per_channel:
        mat_dev = device_ms(materialised, ("ssm_scan_kernel",), calls=5)
        extra = (f"; the same call with A materialised (general form) "
                 f"device {_ms(mat_dev)}")
    print(f"{head}; kernel {ms:.3f} ms/call (device {_ms(dev_ms)}; before "
          f"the redesign {EARLIER_DEVICE_MS['selective_scan']} ms, PERF.md), "
          f"plain "
          f"{plain_ms:.3f} ms/call (device {_ms(plain_dev)}), bound "
          f"{bound:.4f} ms by {bound_by} (bytes {t_bytes * 1e3:.4f}, fp32 "
          f"ops {t_flops * 1e3:.4f}, {n_exp:.3g} exp {t_exp * 1e3:.4f} ms)"
          f"{extra}")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None}


def _live_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal (windowed) attention computes."""
    if not window:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def _bf16_ulps(got, want32):
    """|got − want32| in bf16 ULPs of the fp32 value want32, elementwise;
    the ULP of a want32 of 0 is 2⁻¹³³, bf16's least subnormal (the rule of
    ``tests/test_torch_cuda.py``'s ``_within_bf16_flash``)."""
    _, e = torch.frexp(want32)
    ulp = torch.where(want32 == 0, torch.full_like(want32, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(want32), e - 8))
    return (got.float() - want32).abs() / ulp


def flash_bf16_gaps(out, want, want32) -> tuple[float, int, float]:
    """The bf16 flash check: each element within FLASH_RTOL_BF16 of
    max(1, |plain bf16|) or, where not, a single rounding flip — within
    one bf16 ULP of the plain result computed in fp32 from the same bf16
    inputs (``want32``). Returns (max err of max(1, |plain|), elements
    outside that band, their max distance from ``want32`` in bf16 ULP)."""
    rel = ((out.float() - want.float()).abs()
           / want.float().abs().clamp_min(1.0))
    outside = rel > FLASH_RTOL_BF16
    ulps = _bf16_ulps(out, want32)[outside]
    return (float(rel.max()), int(outside.sum()),
            float(ulps.max()) if ulps.numel() else 0.0)


def check_flash(b: int, s: int, hq: int, hkv: int, hd: int, window: int,
                rates, gen, timed: bool, dtype=torch.bfloat16) -> dict:
    """The flash kernel against its plain version, bf16 (the tensor-core
    instance) or fp32 operands; an hd that is not a compiled instance runs
    zero-padded on the next one. When ``timed``, also its times, its bound
    and the library call's time."""
    dev = "cuda"
    q, k, v = (torch.randn(b, s, h, hd, generator=gen, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    before = fa_kernel.flash_attention.launches
    out = fa_kernel.flash_attention(q, k, v, window=window)
    again = fa_kernel.flash_attention(q, k, v, window=window)
    want = ref.flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    inst = fa_kernel.instance_for(hd)
    label = (f"  flash_attention B={b} S={s} Hq={hq} Hkv={hkv} hd={hd}"
             + ("" if inst == hd else f" (padded to {inst})")
             + f" window={window} {_short(dtype)}")
    if fa_kernel.flash_attention.launches != before + 2:
        raise RuntimeError(f"{label}: the kernel did not launch")
    if out.shape != q.shape or out.dtype != dtype:
        raise RuntimeError(f"{label}: output {tuple(out.shape)} {out.dtype}")
    if not torch.equal(out, again):
        raise RuntimeError(f"{label}: two identical calls differ")
    if dtype == torch.float32:
        err = _rel_err(out, want)
        if err > FLASH_RTOL_F32:
            raise RuntimeError(f"{label}: error {err} of max(1,|plain|) > "
                               f"{FLASH_RTOL_F32}")
        gaps = (f"max err {err:.3g} of max(1,|plain|) (band "
                f"{FLASH_RTOL_F32:.3g})")
    else:
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         window=window)
        err, n_out, ulps = flash_bf16_gaps(out, want, want32)
        gaps = (f"max err {err:.3g} of max(1,|plain|); {n_out} elements "
                f"outside {FLASH_RTOL_BF16:.3g}·max(1,|plain|), at most "
                f"{ulps:.3g} bf16 ULP from the fp32 plain result; "
                f"{int((out != want).sum())} of {out.numel()} elements "
                "differ from the plain bf16 output")
        if ulps > 1.0:
            raise RuntimeError(f"{label}: not only single rounding flips: "
                               f"{gaps}")
    abs_err = float((out.float() - want.float()).abs().max())
    head = f"{label}: {gaps}; run-to-run identical"
    if not timed:
        print(head)
        return {"max_abs_err": abs_err}
    flops = 4 * hd * _live_pairs(s, window) * b * hq
    nbytes = 2 * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    t_bytes, t_ops = nbytes / rates[0], flops / BF16_TC_FLOPS
    bound = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def kernel():
        return fa_kernel.flash_attention(q, k, v, window=window)

    def plain():
        return ref.flash_attention_ref(q, k, v, window=window)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)

    lib_err = _rel_err(library().transpose(1, 2), want)
    ms = time_ms(kernel, calls=10, repeats=3)
    plain_ms = time_ms(plain, calls=2, repeats=3, warmup=1)
    lib_ms = time_ms(library, calls=20, repeats=3)
    dev_ms = device_ms(kernel, ("flash_fwd_kernel",), calls=5)
    plain_dev = device_ms(plain, calls=2)
    lib_dev = device_ms(library, calls=5)
    print(f"{head}; kernel {ms:.3f} ms/call (device {_ms(dev_ms)}; before "
          f"the redesign {EARLIER_DEVICE_MS['flash_attention']} ms, PERF.md), "
          f"plain "
          f"{plain_ms:.3f} ms/call (device {_ms(plain_dev)}), "
          f"scaled_dot_product_attention {lib_ms:.4f} ms/call (device "
          f"{_ms(lib_dev)}, err {lib_err:.3g}), bound {bound:.4f} ms by "
          f"{bound_by} ({flops:.3g} flop at 989 TFLOP/s bf16, {nbytes} B)")
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev}


def phase_lm_kernels(rates) -> dict:
    """The scan and flash kernels at the serving path's shapes (zamba2-2.7b,
    B = 2, S = 2048: scan G = 2, D = 5120, N = 64 with Mamba2's A; flash 32
    heads of 80), then at shapes off that path: the scan with a general A,
    also at falcon-mamba-7b's widths (G = 2, S = 512, D = 8192, N = 16)."""
    cfg = lm_configs.get_config(SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(2)
    hdim = cfg.mamba_headdim
    main = {"selective_scan": check_scan(
        SERVE_BATCH, SERVE_SEQ, cfg.d_inner, cfg.ssm_state, hdim, rates, gen,
        timed=True, per_channel=True)}
    check_scan(3, 333, 520, 16, hdim, rates, gen, timed=False,
               per_channel=False)
    check_scan(3, 333, 520, 16, hdim, rates, gen, timed=False,
               per_channel=True)
    fm = lm_configs.get_config("falcon-mamba-7b")
    check_scan(SERVE_BATCH, 512, fm.d_inner, fm.ssm_state, hdim, rates, gen,
               timed=False, per_channel=False)
    main["flash_attention"] = check_flash(
        SERVE_BATCH, SERVE_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 0,
        rates, gen, timed=True)
    check_flash(SERVE_BATCH, SERVE_SEQ, 32, 8, 128, 0, rates, gen,
                timed=False)
    check_flash(SERVE_BATCH, 512, cfg.n_heads, cfg.n_kv_heads, cfg.hd, 100,
                rates, gen, timed=False)
    check_flash(1, 333, 4, 2, 32, 0, rates, gen, timed=False)
    # the head dims of the configs still to be served (hd 64: stablelm-1.6b,
    # musicgen-medium, granite-moe; hd 16: yi-34b's smoke config), and two
    # that run zero-padded on the next instance
    for hd, window in ((16, 0), (64, 0), (64, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            check_flash(2, 333, 8, 2, hd, window, rates, gen, timed=False,
                        dtype=dtype)
    check_flash(2, 333, 8, 2, 48, 0, rates, gen, timed=False)
    check_flash(1, 333, 4, 4, 96, 100, rates, gen, timed=False,
                dtype=torch.float32)
    return main


# -------------------------------------------------------------- main path

def _eval_loss(params, x, y) -> float:
    return float(mlp_loss(params, (x, y)))


def _tensors(x) -> list:
    """Every tensor in a state: NamedTuples, dicts and tensors, walked."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return []


def _all_cuda(state) -> bool:
    return all(t.device.type == "cuda" for t in _tensors(state))


WRAPPERS = {"amsgrad": cada_update.fused_amsgrad_flat,
            "batched_diff_sq": cada_update.batched_diff_sq_norm_flat,
            "batched_sq": cada_update.batched_sq_norm_flat,
            "diff_sq": cada_update.diff_sq_norm_flat}


def _counts() -> dict:
    return {name: f.launches for name, f in WRAPPERS.items()}


def _reset_counts() -> None:
    for f in WRAPPERS.values():
        f.launches = 0


def setup_main():
    ds = mnist_like(n=N_DATA)
    x = ds.x.reshape(ds.n, -1)
    mtx = pad_to_matrix(uniform_partition(ds.n, M, seed=0))
    sample = make_sampler(x, ds.y, mtx, BATCH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    draws = [sample(gen) for _ in range(max(
        [SKIP_ROUNDS] + [r for _, r, _ in MAIN_RUNS.values()]))]
    batches = tuple(torch.stack(t) for t in zip(*draws))
    params = mlp_init(torch.Generator().manual_seed(0), *DIMS, device="cuda")
    held_out = (torch.as_tensor(x[:1024], device="cuda"),
                torch.as_tensor(ds.y[:1024], device="cuda"))
    return params, batches, held_out


def _engine(kind: str, impl=None, opt: str = "fused",
            c: float = 1.0) -> CADAEngine:
    """The paper MLP's engine for one rule at its reference defaults, on
    FusedAMSGrad(lr=5e-4) or, as the paper runs lag, on SGD(0.05)."""
    optimizer = FusedAMSGrad(lr=5e-4) if opt == "fused" else sgd(0.05)
    return CADAEngine(mlp_loss, optimizer,
                      CommRule(kind=kind, c=c, d_max=D_MAX,
                               max_delay=MAX_DELAY), M,
                      impl=impl)


def expected_launches(kind: str, rounds: int, opt: str) -> dict:
    """Each kernel's launches in ``rounds`` rounds of one run: the server
    step where FusedAMSGrad serves, the rule's gate norm, no diff_sq."""
    return {"amsgrad": rounds if opt == "fused" else 0,
            "batched_diff_sq": rounds if kind in DIFF_RULES else 0,
            "batched_sq": rounds if kind in SQ_RULES else 0,
            "diff_sq": 0}


def skip_c(metrics) -> float:
    """The c at which a c = 1 run's gate would skip about half its
    decisions: the median LHS/RHS over its rounds with a full RHS ring
    (before round d_max the ring's sum is partial and the ratio inflated)."""
    ratio = (metrics["lhs"].double()
             / metrics["rhs"].double()[:, None])[D_MAX:]
    return float(ratio[torch.isfinite(ratio)].median())


def resumes(upload_mask) -> bool:
    """Whether some worker of a (rounds, M) mask uploads in a round after
    one it skipped, so that what a skip carries (the stale worker copy, an
    error-feedback residual) is used again."""
    skipped = (~upload_mask).int().cumsum(0) > 0
    return bool((upload_mask[1:] & skipped[:-1]).any())


def drive(name, kind, rounds, opt, c, card, params, batches, held_out,
          loss0, totals, must_fall: bool = True) -> dict:
    """One run of the main path: exact launch counts, state on the card,
    finite parameters and held-out loss, which must fall where
    ``must_fall``. Returns its metrics."""
    eng = _engine(kind, opt=opt, c=c)
    state = eng.init(params)
    run_batches = tuple(b[:rounds] for b in batches)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    state, metrics = eng.run(state, run_batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got, want = _counts(), expected_launches(kind, rounds, opt)
    if got != want:
        raise RuntimeError(f"{name}: launches {got}, expected {want}")
    for k, v in got.items():
        totals[k] += v
    if not _all_cuda(state):
        raise RuntimeError(f"{name}: state left the card")
    if not bool(torch.isfinite(state.params_flat).all()):
        raise RuntimeError(f"{name}: non-finite parameters")
    loss1 = _eval_loss(state.params, *held_out)
    if not math.isfinite(loss1) or (must_fall and not loss1 < loss0):
        raise RuntimeError(f"{name}: held-out loss {loss0} -> {loss1} "
                           "is not finite or did not fall")
    uploads = int(metrics["uploads"].sum())
    print(f"  {name} (c={c:.6g}): {rounds} rounds, {rounds / secs:.1f} "
          f"rounds/s on {card}; held-out loss {loss0:.5f} -> {loss1:.5f}; "
          f"uploads {uploads} / {rounds * M}, "
          f"{float(metrics['bytes_up'].sum()) / rounds:.0f} B up per round; "
          "launches " + ", ".join(f"{k} {v}" for k, v in got.items()))
    return metrics


def phase_main(card: str, params, batches, held_out) -> tuple[dict, dict]:
    """Every run of MAIN_RUNS at c = 1. Each gated rule must, somewhere on
    the card, skip an upload and upload again after it (:func:`resumes`):
    where its c = 1 run does not, it runs again for SKIP_ROUNDS rounds at
    :func:`skip_c` of that run. avp's gate is ±inf, so its c comes from
    lag's run, whose LHS is avp's energy ‖fresh − stale‖² (at c = 1 both
    upload every round, so the two runs are the same run). Returns the
    launch totals and the c at which each gated rule resumed.

    Only the c = 1 runs, each rule at its reference defaults, must lower
    the held-out loss. A rerun at a skipping c need not: while a worker
    skips, the server keeps stepping on its stale aggregate, and
    AMSGrad's normalized steps can carry the loss uphill."""
    loss0 = _eval_loss(params, *held_out)
    totals = dict.fromkeys(WRAPPERS, 0)
    uploads, bytes_per_round, ratio_c, skipping_c = {}, {}, {}, {}
    for name, (kind, rounds, opt) in MAIN_RUNS.items():
        metrics = drive(name, kind, rounds, opt, 1.0, card, params, batches,
                        held_out, loss0, totals)
        uploads[name] = int(metrics["uploads"].sum())
        bytes_per_round[name] = float(metrics["bytes_up"].sum()) / rounds
        if kind == "always":
            continue
        if kind != "avp":
            ratio_c[name] = skip_c(metrics)
        if resumes(metrics["upload_mask"]):
            skipping_c[name] = 1.0
            continue
        c = ratio_c["lag" if kind == "avp" else name]
        metrics = drive(f"{name}@skip", kind, SKIP_ROUNDS, opt, c, card,
                        params, batches, held_out, loss0, totals,
                        must_fall=False)
        if not resumes(metrics["upload_mask"]):
            raise RuntimeError(f"{name}: at c = {c} no worker uploaded "
                               "after a skip")
        skipping_c[name] = c
    if not uploads["cada2"] < uploads["always"]:
        raise RuntimeError(f"cada2 uploaded {uploads['cada2']}, not fewer "
                           f"than always's {uploads['always']}")
    for name in ("laq", "topk"):
        if not bytes_per_round[name] < bytes_per_round["always"]:
            raise RuntimeError(
                f"{name} sent {bytes_per_round[name]} B per round, not fewer "
                f"than always's {bytes_per_round['always']}")
    return totals, skipping_c


def profile_rounds(kind: str, params, batches, rounds: int = 20) -> None:
    """Where a round's time goes: device-busy share of the wall time over
    ``rounds`` rounds after a warm-up, and the kernels that take most of
    the device time."""
    from torch.profiler import ProfilerActivity, profile
    eng = _engine(kind)
    state, _ = eng.run(eng.init(params), tuple(b[:5] for b in batches))
    run_batches = tuple(b[5:5 + rounds] for b in batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(state, run_batches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(),
                    key=lambda e: -getattr(e, "device_time_total", 0))
    busy = sum(getattr(e, "device_time_total", 0) for e in events) / 1e6
    print(f"  {kind} profile over {rounds} rounds: wall "
          f"{wall * 1e3 / rounds:.3f} ms/round, device busy "
          f"{busy * 1e3 / rounds:.3f} ms/round ({100 * busy / wall:.1f}%, "
          f"idle {100 - 100 * busy / wall:.1f}%),"
          f" {sum(e.count for e in events) / rounds:.0f} kernels/round")
    for e in events[:8]:
        print(f"    {getattr(e, 'device_time_total', 0) / rounds:9.2f} "
              f"us/round  x{e.count / rounds:.0f}  {e.key[:90]}")


def phase_lockstep(kind: str, gate_c: float, params, batches) -> None:
    """``kind`` at ``gate_c`` stepped by the kernels and by the plain versions
    from the same state each round: integer state equal, float state within
    8 ULP at each array's scale, the sums (RHS ring, LHS) within SUM_RTOL.
    At least one gate decision must skip, so the state a skip carries (the
    stale worker copy, an error-feedback residual) is compared too."""
    eng_k = _engine(kind, c=gate_c)
    eng_p = _engine(kind, impl="plain", c=gate_c)
    state = eng_k.init(params)
    flips = skips = 0
    for i in range(LOCKSTEP_ROUNDS):
        b = tuple(t[i] for t in batches)
        before = _counts()
        sp, mp = eng_p.step(state, b)
        if _counts() != before:
            raise RuntimeError("impl='plain' launched a kernel")
        sk, mk = eng_k.step(state, b)
        up_k, up_p = mk["upload_mask"], mp["upload_mask"]
        skips += int((~up_k).sum())
        if not torch.equal(up_k, up_p):
            margin = (mp["lhs"] - mp["rhs"]).abs()
            if bool((margin[up_k != up_p] > MARGIN_BAND * mp["rhs"]).any()):
                raise RuntimeError(f"{kind} round {i}: masks differ outside "
                                   f"the band: {up_k} vs {up_p}")
            flips += 1
            state = sk
            continue
        exact = [("staleness", sk.comm.staleness, sp.comm.staleness)]
        close = [("params_flat", sk.params_flat, sp.params_flat),
                 ("h", sk.opt_state.h, sp.opt_state.h),
                 ("vhat", sk.opt_state.vhat, sp.opt_state.vhat),
                 ("nabla", sk.comm.nabla, sp.comm.nabla),
                 ("worker_grads", sk.comm.worker_grads,
                  sp.comm.worker_grads)]
        for name, v in sk.comm.extras.items():
            if not torch.is_tensor(v):
                continue
            pair = (name, v, sp.comm.extras[name])
            (close if v.is_floating_point() else exact).append(pair)
        for name, a, c in exact:
            if not torch.equal(a, c):
                raise RuntimeError(f"{kind} round {i}: {name} differs")
        for name, a, c in close:
            if float((a - c).abs().max()) > ULP_SCALE * float(
                    c.abs().max()):
                raise RuntimeError(f"{kind} round {i}: {name} differs")
        for name, a, c in (("diff_hist", sk.comm.diff_hist,
                            sp.comm.diff_hist), ("lhs", mk["lhs"],
                                                 mp["lhs"])):
            if _max_rel(a, c) > SUM_RTOL:
                raise RuntimeError(f"{kind} round {i}: {name} differs")
        state = sk
    if flips > 1:
        raise RuntimeError(f"{kind}: {flips} rounds flipped a gate")
    if skips == 0:
        raise RuntimeError(f"{kind} at c = {gate_c}: no gate decision "
                           "skipped")
    print(f"  {kind} (c={gate_c:.6g}) kernel vs impl='plain': "
          f"{LOCKSTEP_ROUNDS} rounds in lockstep, {skips} skipped uploads, "
          f"masks, staleness "
          f"and integer extras equal, float state and extras within 8 ULP, "
          f"{flips} in-band flips")


# ----------------------------------------------------------- serving path

LM_WRAPPERS = {"selective_scan": scan_kernel.selective_scan,
               "flash_attention": fa_kernel.flash_attention}


def _lm_counts() -> dict:
    return {name: f.launches for name, f in LM_WRAPPERS.items()}


def _reset_all_counts() -> None:
    _reset_counts()
    for f in LM_WRAPPERS.values():
        f.launches = 0


def _profile(fn, label: str, per: int = 1, top: int = 8) -> tuple:
    """Wall time, device-busy share and the kernels that take most of the
    device time over one call of ``fn`` (which ends in a synchronise).
    Returns the device-busy ms per ``per`` and the profiler's events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(),
                    key=lambda e: -getattr(e, "device_time_total", 0))
    busy = sum(getattr(e, "device_time_total", 0) for e in events) / 1e6
    print(f"  {label}: wall {wall * 1e3 / per:.3f} ms, device busy "
          f"{busy * 1e3 / per:.3f} ms ({100 * busy / wall:.1f}%, idle "
          f"{100 - 100 * busy / wall:.1f}%), "
          f"{sum(e.count for e in events) / per:.0f} kernels")
    for e in events[:top]:
        print(f"    {getattr(e, 'device_time_total', 0) / 1e3 / per:10.3f} "
              f"ms  x{e.count / per:.0f}  {e.key[:90]}")
    return busy * 1e3 / per, events


def _band(got, want, band: float, what: str) -> float:
    """max |got − want| as a share of max |want|; raises above ``band``."""
    got, want = got.double(), want.double()
    share = float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))
    if share > band:
        raise RuntimeError(f"{what}: max |diff| is {share:.3g} of the "
                           f"plain run's scale, above {band:.3g}")
    return share


def _upcast(tree):
    """A copy of a parameter tree with every tensor in fp32."""
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return tree.float()


def phase_serve(card: str) -> dict:
    """zamba2-2.7b at full width and depth through the serving entry
    point, B = 2 prompts of S = 2048 random tokens, 32 greedy steps. All
    kernel counts are set to 0 just before and read just after: exactly
    54 scans and 9 flash launches (one prefill), nothing else."""
    cfg = lm_configs.get_config(SERVE_ARCH)
    b, s, steps = SERVE_BATCH, SERVE_SEQ, SERVE_TOKENS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    if n_params != param_count(cfg):
        raise RuntimeError(f"{n_params} parameters, not {param_count(cfg)}")
    print(f"  {cfg.name} ({cfg.source}): {n_params:,} parameters in "
          f"{cfg.dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    prompts = serve.random_prompts(cfg, b, s, 1, "cuda")
    n_attn = cfg.n_layers // cfg.attn_every
    want = {"selective_scan": cfg.n_layers, "flash_attention": n_attn}

    torch.cuda.synchronize()
    _reset_all_counts()
    out = serve.generate(cfg, params, prompts, steps)
    torch.cuda.synchronize()
    got = {**_counts(), **_lm_counts()}
    expect = {**dict.fromkeys(WRAPPERS, 0), **want}
    if got != expect:
        raise RuntimeError(f"serving path: launches {got}, expected {expect}")
    peak = torch.cuda.max_memory_allocated()
    logits, toks = out["prefill_logits"], out["tokens"]
    if logits.shape != (b, cfg.vocab) or toks.shape != (b, steps):
        raise RuntimeError(f"shapes {tuple(logits.shape)}, "
                           f"{tuple(toks.shape)}")
    if not (bool(torch.isfinite(logits.float()).all()) and bool(
            torch.isfinite(out["logits"].float()).all())):
        raise RuntimeError("non-finite logits at full depth")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise RuntimeError("decoded token ids out of range")
    print(f"  prefill {b}x{s} (first call): {out['prefill_s'] * 1e3:.2f} ms; "
          f"{steps} greedy decode steps in {out['decode_s'] * 1e3:.2f} ms "
          f"({steps * b / out['decode_s']:.2f} tokens/s); peak memory "
          f"{peak / 2**30:.3f} GiB; launches scan {got['selective_scan']}, "
          f"flash {got['flash_attention']} (others 0) on {card}")
    print(f"  logits finite, |max| {float(logits.float().abs().max()):.4f}; "
          f"tokens[0][:8] {toks[0][:8].tolist()}")

    # warm prefill: events around it, then its profile
    max_seq = s + steps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _, cache = lm.prefill(cfg, params, prompts, max_seq=max_seq)
    end.record()
    end.synchronize()
    print(f"  prefill {b}x{s} (warm, CUDA events): "
          f"{start.elapsed_time(end):.2f} ms")
    _profile(lambda: lm.prefill(cfg, params, prompts, max_seq=max_seq),
             f"prefill {b}x{s} profile")

    def decode4():
        c = cache
        tok = prompts[:, -1]
        for _ in range(4):
            lg, c = lm.decode_step(cfg, params, c, tok)
            tok = torch.argmax(lg, dim=-1)

    _profile(decode4, "decode step profile (4 steps, per step)", per=4)

    # prefill(S-1) -> decode(1) against prefill(S), the reference's check
    # (tests/test_models_smoke.py, on fp32 configs, rtol = atol = 0.05): in
    # fp32 at full width and depth, the bf16 model's weights upcast. Each
    # call launches exactly what the path says. The served bf16 routes are
    # printed beside it, with their distances from the fp32 logits.
    _reset_all_counts()
    _, short = lm.prefill(cfg, params, prompts[:, :-1], max_seq=s)
    per_prefill = _lm_counts()
    last, _ = lm.decode_step(cfg, params, short, prompts[:, -1])
    torch.cuda.synchronize()
    if per_prefill != want or _lm_counts() != want:
        raise RuntimeError(f"a prefill launched {per_prefill}, a decode "
                           f"step then {_lm_counts()}; expected {want} and "
                           "nothing more")
    del short
    cfg32 = cfg.with_(dtype="float32")
    params32 = _upcast(params)
    full32, _ = lm.prefill(cfg32, params32, prompts, max_seq=s)
    _, short32 = lm.prefill(cfg32, params32, prompts[:, :-1], max_seq=s)
    last32, _ = lm.decode_step(cfg32, params32, short32, prompts[:, -1])
    torch.cuda.synchronize()
    del params32, short32
    diff = (last32 - full32).abs()
    if not bool(torch.isfinite(full32).all()) or bool(
            (diff > DECODE_ATOL + DECODE_RTOL * full32.abs()).any()):
        raise RuntimeError(f"fp32 prefill(S-1)+decode vs prefill(S): max "
                           f"|diff| {float(diff.max())} outside atol "
                           f"{DECODE_ATOL} + rtol {DECODE_RTOL}")
    bf16_pair = float((last.float() - logits.float()).abs().max())
    print(f"  fp32, full width and depth: prefill({s - 1}) + decode(1) vs "
          f"prefill({s}): max |diff| {float(diff.max()):.6f} of logits "
          f"|max| {float(full32.abs().max()):.4f} (band atol {DECODE_ATOL} "
          f"+ rtol {DECODE_RTOL}); argmax equal "
          f"{bool(torch.equal(last32.argmax(-1), full32.argmax(-1)))}")
    print(f"  bf16 (served): the same pair max |diff| {bf16_pair:.4f}, "
          f"argmax equal "
          f"{bool(torch.equal(last.argmax(-1), logits.argmax(-1)))}; "
          f"distance from the fp32 prefill({s}) logits: prefill "
          f"{float((logits.float() - full32).abs().max()):.4f}, "
          f"prefill + decode {float((last.float() - full32).abs().max()):.4f}"
          f"; per prefill {per_prefill}, per decode step 0")
    del params, out, cache

    # the first stage at full width: kernels vs plain, in fp32 (the bf16
    # weights upcast) within STAGE_RTOL_F32 of each array's scale; in bf16,
    # the served dtype, no further apart than bf16 itself moves the plain
    # run from the fp32 one (bf16 turns the kernels' fp32-level gaps into
    # whole-ULP flips that grow layer by layer; see PERF.md)
    stage = cfg.with_(n_layers=cfg.attn_every)
    sp = lm.init_params(stage, 3)
    runs = {}
    for tag, c, p_ in (("bf16", stage, sp),
                       ("fp32", stage.with_(dtype="float32"), _upcast(sp))):
        for impl in (None, "plain"):
            lg, kc = lm.prefill(c, p_, prompts, max_seq=max_seq, impl=impl)
            runs[tag, impl] = {"logits": lg, **{
                f: getattr(kc, f) for f in ("k", "v", "conv", "ssm")}}
    torch.cuda.synchronize()
    f32_shares, bf16_shares = {}, {}
    for name in runs["fp32", None]:
        f32_shares[name] = _band(runs["fp32", None][name],
                                 runs["fp32", "plain"][name], STAGE_RTOL_F32,
                                 f"stage fp32 {name}")
        floor = _band(runs["bf16", "plain"][name],
                      runs["fp32", "plain"][name], float("inf"), "")
        bf16_shares[name] = (_band(runs["bf16", None][name],
                                   runs["bf16", "plain"][name], floor,
                                   f"stage bf16 {name} (vs bf16's own "
                                   "distance from fp32)"), floor)
    print(f"  first stage ({stage.n_layers} Mamba2 layers + the shared "
          "block, full width), kernels vs impl='plain', max |diff| as a "
          "share of the plain array's scale: fp32 " + ", ".join(
              f"{k} {v:.3g}" for k, v in f32_shares.items())
          + f" (band {STAGE_RTOL_F32:.3g}); bf16 " + ", ".join(
              f"{k} {v:.3g} (bf16 vs fp32: {fl:.3g})"
              for k, (v, fl) in bf16_shares.items()))
    return {name: got[name] for name in LM_WRAPPERS}


# ---------------------------------------------------------- training path

def _train_counts() -> dict:
    return {**_counts(), **_lm_counts()}


def _train_launches(kind: str, steps: int) -> dict:
    """Each kernel's launches in ``steps`` trainer steps of one rule: the
    server step every step, the rule's gate norm, nothing of serving (the
    training route's attention and scan are plain PyTorch)."""
    return {**expected_launches(kind, steps, "fused"),
            **dict.fromkeys(LM_WRAPPERS, 0)}


def _batch_on_card(tokens) -> dict:
    return trainer.worker_split({"tokens": torch.from_numpy(tokens).to(
        device="cuda", dtype=torch.long)}, TRAIN_M)


def phase_train(card: str, rates) -> tuple[dict, dict]:
    """7a: stablelm-1.6b at full width (4 of 24 layers), cada2, M = 2, 8
    steps of 4 × 2048 tokens; the counts set to 0 just before and read just
    after: exactly one AMSGrad and one two-operand norm launch per step.
    Then the kernels on the trainer's own operands. 7b: every rule kind for
    3 steps at smoke size. Returns the launches of both runs and the
    kernels' times at the trainer's size."""
    cfg = lm_configs.get_config(TRAIN_ARCH).with_(n_layers=TRAIN_LAYERS)
    hp = trainer.TrainHParams(rule=CommRule(kind="cada2", **TRAIN_RULE),
                              lr=TRAIN_LR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init_train_state(cfg, hp, TRAIN_M, 0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(state.params))
    if not n_params == param_count(cfg) == TRAIN_PARAMS:
        raise RuntimeError(f"{n_params} parameters, not {TRAIN_PARAMS}")
    layout = flat.layout_of(state.params)
    print(f"  {cfg.name} ({cfg.source}) at full width, {cfg.n_layers} of "
          f"24 layers: {n_params:,} parameters in {cfg.dtype} (n_flat "
          f"{layout.n_flat:,}), remat {cfg.remat}, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; cada2 {TRAIN_RULE}, M = "
          f"{TRAIN_M}, lr {TRAIN_LR}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens")
    step = trainer.make_train_step(cfg, hp, TRAIN_M)
    tokens = make_token_batches(cfg, global_batch=TRAIN_BATCH,
                                seq=TRAIN_SEQ,
                                steps=TRAIN_STEPS + TRAIN_PROFILE_STEPS + 1)
    torch.cuda.synchronize()
    _reset_all_counts()
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = _batch_on_card(tokens[i])
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, mets = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(mets["loss"]))
        up = mets["upload_mask"]
        print(f"  step {i}: loss {losses[-1]:.6f}, uploads "
              f"{int(mets['uploads'])}/{TRAIN_M} {up.tolist()}, "
              f"{step_ms[-1]:.2f} ms")
        if i == 0 and not bool(up.all()):
            raise RuntimeError("step 0: not every worker uploaded")
    got, want = _train_counts(), _train_launches("cada2", TRAIN_STEPS)
    if got != want:
        raise RuntimeError(f"training path: launches {got}, expected {want}")
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite losses {losses}")
    if not _all_cuda(state):
        raise RuntimeError("the trainer's state left the card")
    steady = statistics.median(step_ms[1:])
    print(f"  {TRAIN_STEPS} steps: losses finite ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f}); step time median {steady:.2f} ms after the "
          f"first ({step_ms[0]:.2f} ms); peak memory {peak / 2**30:.3f} GiB; "
          "launches " + ", ".join(f"{k} {v}" for k, v in got.items())
          + f" on {card}")

    def two_steps():
        nonlocal state
        for i in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_PROFILE_STEPS):
            state, _ = step(state, _batch_on_card(tokens[i]))

    busy, events = _profile(two_steps, f"trainer step profile "
                            f"({TRAIN_PROFILE_STEPS} steps, per step)",
                            per=TRAIN_PROFILE_STEPS, top=10)
    groups = dict.fromkeys(TRAIN_KERNEL_GROUPS, 0.0)
    for e in events:
        group = next((g for g, keys in TRAIN_KERNEL_GROUPS.items()
                      if any(k in e.key for k in keys)),
                     "other elementwise")
        groups[group] += getattr(e, "device_time_total", 0) / 1e3 \
            / TRAIN_PROFILE_STEPS
    print(f"  device busy {busy:.3f} ms per step under the profiler against "
          f"{steady:.2f} ms per step by CUDA events without it "
          f"({100 * busy / steady:.1f}% busy); by kind, ms per step: "
          + ", ".join(f"{g} {v:.3f}" for g, v in groups.items()))

    # the kernels on the trainer's own operands: the next step's planes,
    # then the server step on the state it reached
    print("  the two kernels on the trainer's own operands:")
    vgrad, vgrad_per = trainer.make_vgrads(cfg, hp, TRAIN_M)
    _, fresh, second = flat.eval_two_point(
        strategy_for(hp.rule), layout, state.comm.extras, state.params,
        _batch_on_card(tokens[-1]), TRAIN_M, vgrad=vgrad,
        vgrad_per=vgrad_per, fuse_evals=False)
    sizes = {"batched_diff_sq": check_batched(
        TRAIN_M, layout.n_flat, fresh.dtype, second.dtype, rates, None,
        planes=(fresh, second), calls=8)}
    del fresh, second
    operands = (layout.pack(state.params), state.h, state.vhat,
                flat.nabla_f32(state.comm))
    del state
    torch.cuda.empty_cache()
    sizes["amsgrad"] = check_amsgrad(
        layout.n_flat, operands[1].dtype, rates, None,
        theta_dtype=operands[0].dtype, grad_dtype=operands[3].dtype,
        calls=8, operands=operands, lr=TRAIN_LR)
    del operands
    torch.cuda.empty_cache()

    # 7b: every rule kind at smoke size through the same trainer
    smoke = lm_configs.get_smoke_config(TRAIN_ARCH)
    toks = make_token_batches(smoke, global_batch=TRAIN_BATCH, seq=32,
                              steps=SMOKE_TRAIN_STEPS)
    totals = dict(got)
    per_kind = {}
    for kind in RULES:
        hp_k = trainer.TrainHParams(rule=CommRule(kind=kind, **TRAIN_RULE),
                                    lr=TRAIN_LR)
        st = trainer.init_train_state(smoke, hp_k, TRAIN_M, 0)
        step_k = trainer.make_train_step(smoke, hp_k, TRAIN_M)
        torch.cuda.synchronize()
        _reset_all_counts()
        k_losses = []
        for i in range(SMOKE_TRAIN_STEPS):
            st, mets = step_k(st, _batch_on_card(toks[i]))
            k_losses.append(float(mets["loss"]))
        got_k = _train_counts()
        want_k = _train_launches(kind, SMOKE_TRAIN_STEPS)
        if got_k != want_k:
            raise RuntimeError(f"{kind} at smoke size: launches {got_k}, "
                               f"expected {want_k}")
        if not all(math.isfinite(v) for v in k_losses) or not _all_cuda(st):
            raise RuntimeError(f"{kind} at smoke size: losses {k_losses} "
                               "or the state left the card")
        for k, v in got_k.items():
            totals[k] += v
        per_kind[kind] = got_k
    print(f"  every rule kind, {SMOKE_TRAIN_STEPS} steps at "
          f"{smoke.name} size, M = {TRAIN_M}: losses finite, launches exact "
          "(" + "; ".join(f"{kind} amsgrad {c['amsgrad']}, diff "
                          f"{c['batched_diff_sq']}, sq {c['batched_sq']}"
                          for kind, c in per_kind.items()) + ")")
    return totals, sizes


def main() -> None:
    t_start = time.perf_counter()
    print("[1] card")
    card = phase_card()
    rates = card_rates(torch.cuda.get_device_name(0))
    print(f"    rates for bounds: H100 SXM data sheet, "
          f"{rates[0] / 1e12:.2f} TB/s, {rates[1] / 1e12:.0f} TFLOP/s fp32, "
          f"{BF16_TC_FLOPS / 1e12:.0f} TFLOP/s bf16 tensor cores, "
          f"{SFU_RATE / 1e12:.3f} T exp/s")
    print("[2] build")
    t0 = time.perf_counter()
    sources = ("cada_update", "ssm_scan", "flash_attention")
    build.build_all(sources)
    for name in sources:
        build.load(name)
    print(f"    built and loaded {', '.join(f'{n}.cu' for n in sources)} "
          f"(one nvcc each, in parallel) in {time.perf_counter() - t0:.1f} s")
    params, batches, held_out = setup_main()
    layout = flat.layout_of(params)
    print(f"[3] kernels vs plain (n_flat = {layout.n_flat}; the serving "
          "path's scan and attention)")
    main_shape = phase_kernels(rates, layout)
    main_shape.update(phase_lm_kernels(rates))
    print("[4] main path")
    launches, skipping_c = phase_main(card, params, batches, held_out)
    profile_rounds("cada2", params, batches)
    profile_rounds("laq", params, batches)
    profile_rounds("topk", params, batches)
    print("[5] plain lockstep")
    phase_lockstep("cada2", 1.0, params, batches)
    phase_lockstep("laq", skipping_c["laq"], params, batches)
    phase_lockstep("topk", skipping_c["topk"], params, batches)
    print("[6] serving path")
    launches.update(phase_serve(card))
    print("[7] training path")
    train_launches, train_sizes = phase_train(card, rates)
    for name, v in train_launches.items():
        launches[name] += v
    for name, entry in train_sizes.items():
        main_shape[name]["trainer_size"] = entry
    csrc = "src/repro_torch/kernels/csrc/"
    source = {"amsgrad": "cada_update.cu", "batched_diff_sq": "cada_update.cu",
              "batched_sq": "cada_update.cu", "diff_sq": "cada_update.cu",
              "selective_scan": "ssm_scan.cu",
              "flash_attention": "flash_attention.cu"}
    replaces = {"amsgrad": "src/repro/kernels/cada_update.py:34",
                "batched_diff_sq": "src/repro/kernels/cada_update.py:106",
                "batched_sq": "src/repro/kernels/cada_update.py:144",
                "diff_sq": "src/repro/kernels/cada_update.py:174",
                "selective_scan": "src/repro/kernels/ssm_scan.py:39",
                "flash_attention": "src/repro/kernels/flash_attention.py:33"}
    kernels = [{"name": name, "route": "cuda", "source": csrc + source[name],
                "replaces": replaces[name], "launches": launches[name],
                "library_ms": None, **main_shape[name],
                "library_note": LIBRARY_NOTE[name]}
               for name in (*WRAPPERS, *LM_WRAPPERS)]
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
