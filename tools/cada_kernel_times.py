"""Time the CADA kernels of one tree of the port on the card.

    PYTHONPATH=<tree>/src python3 tools/cada_kernel_times.py --tag <name>

The fused AMSGrad step, the one-operand row norm, the difference norm and
the scalar ‖a − b‖², at the main path's shapes (n_flat = 101,776; (10,
n_flat) planes) and at LM widths (n = 2^28; (10, 2^24)). For each case: the
time per call (CUDA events around back-to-back calls, median of 3), the
device time per call summed over every kernel the call launched and the
number of those kernels (profiler), and the bound (bytes over 3.35 TB/s,
the H100 SXM's data sheet). The script imports ``repro_torch`` from
PYTHONPATH and uses only the wrappers' public signatures, so it times two
trees in one call on one card: a parent commit unpacked beside the
checkout, and the checkout, in turns (parent, change, change, parent). A
case the tree refuses (bf16 θ before it was ported) prints as refused.
Ends with one JSON line of every number, tagged ``--tag``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import cada_update

HBM_BYTES_PER_S = 3.35e12
N_FLAT, M = 101_776, 10
LM_N, LM_ROW_N = 2 ** 28, 2 ** 24


def call_ms(fn, calls: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / calls)
    return statistics.median(runs)


def device(fn, calls: int) -> tuple[float | None, float, list[str]]:
    """(device ms per call over every kernel, kernels per call, names)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in evs)
    return (total / calls / 1e3 if total else None, len(evs) / calls,
            sorted({e.name.split("(")[0][-60:] for e in evs}))


def amsgrad_case(n, theta_dtype, moment_dtype, gen):
    f = cada_update.fused_amsgrad_flat
    theta = torch.randn(n, generator=gen, device="cuda").to(theta_dtype)
    h = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(moment_dtype)
    vhat = (0.01 * torch.randn(n, generator=gen, device="cuda")).abs().to(
        moment_dtype)
    grad = torch.randn(n, generator=gen, device="cuda").to(theta_dtype)
    sizes = [t.element_size() for t in (theta, h, vhat, grad)]
    nbytes = n * (2 * sizes[0] + 4 * sizes[1] + sizes[3]) + 4
    return (lambda: f(theta, h, vhat, grad, 5e-4)), nbytes


def rows_case(rows, n, dtype, two, gen):
    a = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
    if not two:
        return (lambda: cada_update.batched_sq_norm_flat(a),
                rows * n * a.element_size() + 4 * rows)
    b = torch.randn(rows, n, generator=gen, device="cuda").to(dtype)
    if rows == 1:
        a1, b1 = a[0], b[0]
        return (lambda: cada_update.diff_sq_norm_flat(a1, b1),
                2 * n * a.element_size() + 4)
    return (lambda: cada_update.batched_diff_sq_norm_flat(a, b),
            2 * rows * n * a.element_size() + 4 * rows)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cada_kernel_times: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[{args.tag}] {card}; repro_torch from {cada_update.__file__}")
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "amsgrad n_flat fp32": lambda: amsgrad_case(N_FLAT, f32, f32, gen),
        "amsgrad n_flat bf16 moments": lambda: amsgrad_case(N_FLAT, f32,
                                                            bf16, gen),
        "amsgrad n_flat bf16 theta/g": lambda: amsgrad_case(N_FLAT, bf16,
                                                            f32, gen),
        "batched_sq (10, n_flat) fp32": lambda: rows_case(M, N_FLAT, f32,
                                                          False, gen),
        "batched_sq (10, n_flat) bf16": lambda: rows_case(M, N_FLAT, bf16,
                                                          False, gen),
        "batched_diff_sq (10, n_flat) fp32": lambda: rows_case(
            M, N_FLAT, f32, True, gen),
        "diff_sq n_flat fp32": lambda: rows_case(1, N_FLAT, f32, True, gen),
        "amsgrad 2^28 fp32": lambda: amsgrad_case(LM_N, f32, f32, gen),
        "amsgrad 2^28 bf16 theta/g": lambda: amsgrad_case(LM_N, bf16, f32,
                                                          gen),
        "batched_sq (10, 2^24) fp32": lambda: rows_case(M, LM_ROW_N, f32,
                                                        False, gen),
    }
    out = {}
    for label, make in cases.items():
        fn, nbytes = make()
        big = "2^" in label
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            print(f"  {label}: refused ({type(e).__name__}: {e})")
            out[label] = None
            continue
        ms = call_ms(fn, 20 if big else 200)
        dev, per_call, names = device(fn, 5 if big else 50)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        share = f"{100 * bound / dev:.1f}%" if dev else "not measured"
        print(f"  {label}: call {ms * 1e3:.3f} us, device "
              f"{'not measured' if dev is None else f'{dev * 1e3:.3f} us'} "
              f"in {per_call:g} kernel(s) {names}; bound {bound * 1e3:.3f} "
              f"us ({nbytes} B), device at {share} of it")
        out[label] = {"call_ms": ms, "device_ms": dev,
                      "kernels_per_call": per_call, "bound_ms": bound}
        del fn
        torch.cuda.empty_cache()
    print(json.dumps({"tag": args.tag, "card": card, "cases": out}))


if __name__ == "__main__":
    main()
