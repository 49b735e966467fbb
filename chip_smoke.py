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
     The wire compressors (plain PyTorch) must give the CPU's bits.
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
Then it prints one JSON line with every kernel, and last the line
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

from repro_torch.core import flat  # noqa: E402
from repro_torch.core.engine import CADAEngine, make_sampler  # noqa: E402
from repro_torch.core.rules import CommRule  # noqa: E402
from repro_torch.data import (mnist_like, pad_to_matrix,  # noqa: E402
                              uniform_partition)
from repro_torch.kernels import build, cada_update, ref  # noqa: E402
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
}


# ------------------------------------------------------------------ card

SXM_NAME = "H100 80GB HBM3"
SXM_RATES = (3.35e12, 67e12)   # bytes/s, fp32 FLOP/s outside the tensor cores


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

def time_ms(fn, calls: int = 50, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``calls`` back-to-back
    calls, by CUDA events (warm L2: the main path's operands fit in it)."""
    for _ in range(5):
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


def device_ms(fn, names: tuple[str, ...] | None = None) -> float | None:
    """Device time of one call, summed over the kernels whose names hold
    one of ``names`` (every kernel when None), from the profiler; None when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    calls = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    tot = sum(getattr(e, "device_time_total", 0)
              for e in prof.key_averages()
              if names is None or any(n in e.key for n in names))
    return tot / calls / 1e3 if tot > 0 else None


def _us(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.3f} us"


# ---------------------------------------------------------------- kernels

def _max_rel(a, b):
    return float(((a.double() - b.double()).abs()
                  / b.double().abs().clamp_min(1e-30)).max())


def _bound(nbytes: int, flops: int, rates) -> tuple[float, str]:
    """The least time for the work (ms) and what sets it."""
    t_bytes, t_ops = nbytes / rates[0], flops / rates[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_amsgrad(n: int, moment_dtype, rates, gen) -> dict:
    dev = "cuda"
    theta = torch.randn(n, generator=gen, device=dev)
    h = (0.1 * torch.randn(n, generator=gen, device=dev)).to(moment_dtype)
    vhat = (0.01 * torch.randn(n, generator=gen, device=dev)).abs().to(
        moment_dtype)
    grad = torch.randn(n, generator=gen, device=dev)
    lr = 5e-4
    k_out = cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)
    k_again = cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)
    p_out = ref.amsgrad_ref(theta, h, vhat, grad, lr)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out, k_again)):
        raise RuntimeError(f"amsgrad n={n}: two identical calls differ")
    same = torch.ones(n, dtype=torch.bool, device=dev)
    errs = []
    for label, kk, pp in zip(("h", "vhat"), k_out[1:3], p_out[1:3]):
        kk, pp = kk.float(), pp.float()
        d = (kk - pp).abs()
        errs.append(float(d.max()))
        if moment_dtype == torch.bfloat16:
            flips = d > 0
            if float(flips.float().mean()) > 1e-3 or bool(
                    (d > 2.0 ** -7 * pp.abs()).any()):
                raise RuntimeError(f"amsgrad n={n} bf16 {label} differs "
                                   "beyond one bf16 ULP on 0.1%")
            same &= ~flips
        elif float(d.max()) > ULP_SCALE * float(pp.abs().max()):
            raise RuntimeError(f"amsgrad n={n} {label}: max |err| "
                               f"{float(d.max())}")
    # The plain update from the kernel's own stored h', v̂': where no bf16
    # moment rounded otherwise it is the plain version's update itself.
    # θ' and Σupd² are held against it everywhere, and against the plain
    # version's where the moments agree.
    own = -lr * k_out[1].float() / torch.sqrt(1e-8 + k_out[2].float())
    dt = torch.maximum((k_out[0] - (theta + own)).abs(),
                       (k_out[0] - p_out[0]).abs() * same)
    errs.append(float(dt.max()))
    if float(dt.max()) > ULP_SCALE * float(p_out[0].abs().max()):
        raise RuntimeError(f"amsgrad n={n} theta: max |err| {float(dt.max())}")
    sums = [("from its own moments", float(torch.sum(own * own)))]
    if bool(same.all()):
        sums.append(("of the plain version", float(p_out[3])))
    for label, want in sums:
        sq_err = abs(float(k_out[3]) - want)
        if sq_err > SUM_RTOL * want:
            raise RuntimeError(f"amsgrad n={n} sum upd^2 {float(k_out[3])} "
                               f"vs {want} {label}")
        errs.append(sq_err)
    msz = torch.empty((), dtype=moment_dtype).element_size()
    nbytes = n * (4 + 4 + 2 * msz) + n * (4 + 2 * msz) + 4
    # mul/add/max/div/sqrt per element
    bound, bound_by = _bound(nbytes, 14 * n, rates)
    def kernel():
        return cada_update.fused_amsgrad_flat(theta, h, vhat, grad, lr)

    def plain():
        return ref.amsgrad_ref(theta, h, vhat, grad, lr)

    ms, plain_ms = time_ms(kernel), time_ms(plain)
    dev = device_ms(kernel, ("amsgrad_kernel", "sum_partials"))
    plain_dev = device_ms(plain)
    bit_equal = all(torch.equal(a, b) for a, b in zip(k_out[:3], p_out[:3]))
    print(f"  amsgrad n={n} moments={str(moment_dtype)[6:]}: max|err| "
          f"theta/h/vhat {errs[2]:.3g}/{errs[0]:.3g}/{errs[1]:.3g} "
          f"(bit-equal {bit_equal}), sum upd^2 {float(k_out[3]):.9g} vs "
          f"plain {float(p_out[3]):.9g} "
          f"(rel {_max_rel(k_out[3], p_out[3]):.3g})"
          f", run-to-run identical; kernel {ms * 1e3:.2f} us/call "
          f"(device {_us(dev)}), plain {plain_ms * 1e3:.2f} us/call "
          f"(device {_us(plain_dev)}), bound {bound * 1e3:.3f} us "
          f"({nbytes} B)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by}


def check_batched(rows: int, n: int, a_dtype, b_dtype, rates, gen) -> dict:
    dev = "cuda"
    a = torch.randn(rows, n, generator=gen, device=dev).to(a_dtype)
    b = torch.randn(rows, n, generator=gen, device=dev).to(b_dtype)
    k = cada_update.batched_diff_sq_norm_flat(a, b)
    k_again = cada_update.batched_diff_sq_norm_flat(a, b)
    part = cada_update.batched_diff_sq_norm_flat(a[2:5].contiguous(),
                                                 b[2:5].contiguous())
    p = ref.batched_diff_sq_norm_ref(a, b)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"batched ({rows},{n}): two identical calls "
                           "differ")
    if not torch.equal(k[2:5], part):
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

    ms, plain_ms = time_ms(kernel), time_ms(plain)
    dev = device_ms(kernel, ("batched_diff_sq_kernel", "sum_partials"))
    plain_dev = device_ms(plain)
    print(f"  batched_diff_sq ({rows},{n}) {str(a_dtype)[6:]}/"
          f"{str(b_dtype)[6:]}: max|err| {err:.3g} (rel {rel:.3g}), "
          f"run-to-run identical, rows independent of R; kernel "
          f"{ms * 1e3:.2f} us/call (device {_us(dev)}), plain "
          f"{plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), bound "
          f"{bound * 1e3:.3f} us ({nbytes} B)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "plain_device_ms": plain_dev,
            "bound_ms": bound, "bound_by": bound_by}


def check_batched_sq(rows: int, n: int, dtype, rates, gen) -> dict:
    """The one-operand row norm (cinn/laq/topk's gate)."""
    a = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
    k = cada_update.batched_sq_norm_flat(a)
    k_again = cada_update.batched_sq_norm_flat(a)
    part = cada_update.batched_sq_norm_flat(a[2:5].contiguous())
    p = ref.batched_sq_norm_ref(a)
    torch.cuda.synchronize()
    if not torch.equal(k, k_again):
        raise RuntimeError(f"batched_sq ({rows},{n}): two identical calls "
                           "differ")
    if not torch.equal(k[2:5], part):
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

    ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(library)
    dev = device_ms(kernel, ("batched_sq_kernel", "sum_partials"))
    plain_dev, lib_dev = device_ms(plain), device_ms(library)
    print(f"  batched_sq ({rows},{n}) {str(dtype)[6:]}: max|err| {err:.3g} "
          f"(rel {rel:.3g}), run-to-run identical, rows independent of R; "
          f"kernel {ms * 1e3:.2f} us/call (device {_us(dev)}), plain "
          f"{plain_ms * 1e3:.2f} us/call (device {_us(plain_dev)}), "
          f"torch.linalg.vecdot {lib_ms * 1e3:.2f} us/call (device "
          f"{_us(lib_dev)}), bound {bound * 1e3:.3f} us ({nbytes} B)")
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
    ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), time_ms(library)
    dev = device_ms(kernel, ("batched_diff_sq_kernel", "sum_partials"))
    plain_dev, lib_dev = device_ms(plain), device_ms(library)
    print(f"  diff_sq n={n} {str(dtype)[6:]}: {float(k):.9g} vs plain "
          f"{float(p):.9g} (rel {rel:.3g}), run-to-run identical; kernel "
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
    check_amsgrad(48, f32, rates, gen)
    check_amsgrad(48, bf16, rates, gen)
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


def main() -> None:
    t_start = time.perf_counter()
    print("[1] card")
    card = phase_card()
    rates = card_rates(torch.cuda.get_device_name(0))
    print(f"    rates for bounds: H100 SXM data sheet, "
          f"{rates[0] / 1e12:.2f} TB/s, {rates[1] / 1e12:.0f} TFLOP/s fp32")
    print("[2] build")
    t0 = time.perf_counter()
    build.load("cada_update")
    print(f"    built and loaded cada_update.cu in "
          f"{time.perf_counter() - t0:.1f} s")
    params, batches, held_out = setup_main()
    layout = flat.layout_of(params)
    print(f"[3] kernels vs plain (n_flat = {layout.n_flat})")
    main_shape = phase_kernels(rates, layout)
    print("[4] main path")
    launches, skipping_c = phase_main(card, params, batches, held_out)
    profile_rounds("cada2", params, batches)
    profile_rounds("laq", params, batches)
    profile_rounds("topk", params, batches)
    print("[5] plain lockstep")
    phase_lockstep("cada2", 1.0, params, batches)
    phase_lockstep("laq", skipping_c["laq"], params, batches)
    phase_lockstep("topk", skipping_c["topk"], params, batches)
    src = "src/repro_torch/kernels/csrc/cada_update.cu"
    replaces = {"amsgrad": "src/repro/kernels/cada_update.py:34",
                "batched_diff_sq": "src/repro/kernels/cada_update.py:106",
                "batched_sq": "src/repro/kernels/cada_update.py:144",
                "diff_sq": "src/repro/kernels/cada_update.py:174"}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces[name], "launches": launches[name],
                "library_ms": None, **main_shape[name],
                "library_note": LIBRARY_NOTE[name]}
               for name in WRAPPERS]
    print(f"    total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
