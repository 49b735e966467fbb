"""Time variants of ``csrc/cada_update.cu`` against the source as built.

    python3 tools/cada_variants.py

Each variant is the checkout's ``cada_update.cu`` with one design choice
undone by a textual substitution (the script stops if the text is not
found): a larger or smaller pack, one pack in flight per thread, no
streaming cache hints, a fence and a relaxed atomic in place of the
acquire-release ticket, 128-thread blocks, or no grid reduction at all
(each block only stores its partial; a timing floor, its sums are wrong).
All are built in parallel under ``build/variants/`` and timed in one
process on one card, the source as built first and last, at the main
path's shapes and at LM widths, with ``tools/cada_kernel_times.py``'s
cases and clocks. Each variant is also checked against the plain versions
(AMSGrad bit for bit, the row norm within 1e-6) except the timing floor.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, cada_update, ref  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "cada_kernel_times", ROOT / "tools" / "cada_kernel_times.py")
times = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(times)

SOURCE = (build.CSRC / "cada_update.cu").read_text()
OUT = ROOT / "build" / "variants"


def _sub(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"cada_variants: {old!r} not in the source")
        text = text.replace(old, new)
    return text


# name: (source, wrapper constants that must follow it, checked)
VARIANTS = {
    "as built": (SOURCE, {}, True),
    "amsgrad pack 8": (_sub(SOURCE, ("kAmsgradPack = 4;",
                                     "kAmsgradPack = 8;")),
                       {"AMSGRAD_PACK": 8}, True),
    "row pack 4": (_sub(SOURCE, ("kRowPack = 8;", "kRowPack = 4;")),
                   {"ROW_PACK": 4}, True),
    "one pack in flight": (_sub(SOURCE, ("kUnroll = 2;", "kUnroll = 1;")),
                           {}, True),
    "no streaming hints": (_sub(
        SOURCE,
        ("__ldcs(reinterpret_cast<const typename V::type*>(p) + c)",
         "reinterpret_cast<const typename V::type*>(p)[c]"),
        ("__stcs(reinterpret_cast<typename V::type*>(p) + c, raw[c]);",
         "reinterpret_cast<typename V::type*>(p)[c] = raw[c];")), {}, True),
    "fence + relaxed ticket": (_sub(
        SOURCE,
        ("take_ticket(counter) ==",
         "(__threadfence(), atomicAdd(counter, 1u)) =="),
        ("  if (!last) return;\n",
         "  if (!last) return;\n  __threadfence();\n")),
        {}, True),
    "128-thread blocks": (_sub(SOURCE, ("kThreads = 256;", "kThreads = 128;")),
                          {"THREADS": 128}, True),
    "no grid reduction (floor)": (_sub(
        SOURCE, ("  __shared__ bool last;\n",
                 "  if (threadIdx.x == 0) partials[index] = s;\n"
                 "  if (count > 0) return;\n  __shared__ bool last;\n")),
        {}, False),
}
ORDER = list(VARIANTS) + ["as built"]


def _use(name: str) -> None:
    d = OUT / name.replace(" ", "_").replace("(", "").replace(")", "")
    build.CSRC, build.BUILD_DIR = d, d / "lib"
    cada_update._lib.cache_clear()
    cada_update._WORKSPACES.clear()
    for key, value in DEFAULTS.items():
        setattr(cada_update, key, value)
    for key, value in VARIANTS[name][1].items():
        setattr(cada_update, key, value)


DEFAULTS = {k: getattr(cada_update, k)
            for k in ("AMSGRAD_PACK", "ROW_PACK", "THREADS")}


def _checked(gen) -> bool:
    theta = torch.randn(times.N_FLAT + 3, generator=gen, device="cuda")
    ops_ = (theta, 0.1 * theta.flip(0), (0.01 * theta).abs(), theta * 0.5)
    k = cada_update.fused_amsgrad_flat(*ops_, 5e-4)
    p = ref.amsgrad_ref(*ops_, 5e-4)
    plane = torch.randn(10, 1001, generator=gen, device="cuda")
    return (all(torch.equal(a, b) for a, b in zip(k[:3], p[:3]))
            and abs(float(k[3]) - float(p[3])) <= 1e-5 * float(p[3])
            and torch.allclose(cada_update.batched_sq_norm_flat(plane),
                               ref.batched_sq_norm_ref(plane), rtol=1e-6,
                               atol=0))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("cada_variants: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    jobs = []
    for name, (text, _, _) in VARIANTS.items():
        _use(name)
        build.CSRC.mkdir(parents=True, exist_ok=True)
        (build.CSRC / "cada_update.cu").write_text(text)
        jobs.append(build._start("cada_update"))
    for job in jobs:
        if job is not None:
            build._finish(job)
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "amsgrad n_flat fp32": lambda: times.amsgrad_case(
            times.N_FLAT, f32, f32, gen),
        "amsgrad n_flat bf16 theta/g": lambda: times.amsgrad_case(
            times.N_FLAT, bf16, f32, gen),
        "batched_sq (10, n_flat) fp32": lambda: times.rows_case(
            10, times.N_FLAT, f32, False, gen),
        "batched_diff_sq (10, n_flat) fp32": lambda: times.rows_case(
            10, times.N_FLAT, f32, True, gen),
        "amsgrad 2^28 fp32": lambda: times.amsgrad_case(
            times.LM_N, f32, f32, gen),
        "amsgrad 2^28 bf16 theta/g": lambda: times.amsgrad_case(
            times.LM_N, bf16, f32, gen),
        "batched_sq (10, 2^24) fp32": lambda: times.rows_case(
            10, times.LM_ROW_N, f32, False, gen),
    }
    for name in ORDER:
        _use(name)
        ok = _checked(gen) if VARIANTS[name][2] else "not checked"
        cells = []
        for label, make in cases.items():
            fn, nbytes = make()
            big = "2^" in label
            for _ in range(3):
                fn()
            dev, _, _ = times.device(fn, 5 if big else 50)
            bound = nbytes / times.HBM_BYTES_PER_S * 1e3
            cells.append(f"{label} {dev * 1e3:.3f} us "
                         f"({100 * bound / dev:.1f}% of bound)")
            del fn
            torch.cuda.empty_cache()
        print(f"{name} [matches plain: {ok}]: " + "; ".join(cells),
              flush=True)


if __name__ == "__main__":
    main()
