"""Check and time a selective-scan source's per-head kernel on the card at
the main path's shapes.

    python3 tools/scan_kernel_times.py --tag <name> [--source FILE.cu]
        [--shapes served,rank,...] [--no-checks] [--unchecked]

Builds ``FILE.cu`` (default: the checkout's
``src/repro_torch/kernels/csrc/ssm_scan.cu``) with the build's nvcc flags
into ``build/scan_kernel_times/`` and loads it in place of the wrappers'
library. Any source of the same C interface takes that path: an earlier
commit's (``git show REV:src/repro_torch/kernels/csrc/ssm_scan.cu >
build/parent.cu``) or an edited copy under the git-ignored ``build/``, so
two sources are compared in one call on one card, in turns (parent,
change, change, parent).

Each case is ``chip_smoke.check_scan_heads``: the per-head kernel against
its plain version within SCAN_RTOL, two identical calls bit-equal, one
launch a call. First (unless ``--no-checks``) untimed at lengths around
the 64-step chunks, at the smoke config's widths and zamba2-2.7b's, in
bf16 and fp32; then timed at the shapes of ``SHAPES``: the call and device
time, the general kernel's per-channel form on the same operands (the
source's own ``ssm_scan`` entry) and the bound. With ``--unchecked`` only
the per-head kernel's device time at each shape, held to nothing: for a
copy that drops a part of the work on purpose, whose outputs are wrong.
Ends with one JSON line of the timed numbers, tagged ``--tag``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

# name: (G, S, heads, P, N)
SHAPES = {
    "served": (2, 2048, 80, 64, 64),       # zamba2-2.7b prefill, phase 6
    "rank": (2, 2048, 40, 64, 64),         # one of 2 ranks, phase 14a
    "round_613": (4, 613, 80, 64, 64),     # the scheduler's rounds, 12a
    "round_1299": (4, 1299, 80, 64, 64),
    "round_2000": (4, 2000, 80, 64, 64),
    # granite-4.0-h-micro's layer at the serving cell's longest round
    "granite": (32, 7845, 64, 64, 128),
}
CHECKS = [(g, s, hn, p, n, dtype) for s in (1, 63, 65, 333)
          for (g, hn, p, n) in ((2, 9, 32, 16), (1, 4, 64, 64),
                                (1, 4, 64, 128))
          for dtype in (torch.bfloat16, torch.float32)]


def load_source(src: Path) -> Path:
    """Build ``src`` (unless built) and bind the wrappers to it."""
    tag = hashlib.sha1(src.read_bytes()
                       + " ".join(build.NVCC_FLAGS).encode()).hexdigest()
    out = build.BUILD_DIR.parent / "scan_kernel_times" / f"lib-{tag[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    lib = ss.bind(ctypes.CDLL(str(out)))
    ss._lib = lambda: lib
    return out


def unchecked_ms(shape, gen) -> float | None:
    """The per-head kernel's device time (profiler median) on bf16
    operands of ``shape``, its outputs not looked at."""
    g, s, hn, p, n = shape
    dt = (0.1 * torch.randn(g, s, hn, generator=gen, device="cuda")).abs()
    x = torch.randn(g, s, hn * p, generator=gen, device="cuda").bfloat16()
    a = -(1.0 + 15.0 * torch.rand(hn, generator=gen, device="cuda"))
    b, c = (torch.randn(g, s, n, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    return cs.device_ms(lambda: ss.selective_scan_heads(dt, x, a, b, c),
                        ("ssm_scan_kernel_ssd",), calls=10)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--source", type=Path, default=build.CSRC / "ssm_scan.cu")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--no-checks", action="store_true")
    ap.add_argument("--unchecked", action="store_true")
    args = ap.parse_args()
    card = cs.phase_card()
    print(f"source {args.source} -> {load_source(args.source)}", flush=True)
    rates = cs.card_rates(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tag": args.tag, "card": card, "source": str(args.source),
           "shapes": {}}
    if args.unchecked:
        for key in args.shapes.split(","):
            out["shapes"][key] = {"device_ms": unchecked_ms(SHAPES[key], gen)}
            print(f"  {key} {SHAPES[key]}: device "
                  f"{cs._ms(out['shapes'][key]['device_ms'])} (unchecked)",
                  flush=True)
        print(json.dumps(out))
        return
    if not args.no_checks:
        for *shape, dtype in CHECKS:
            cs.check_scan_heads(*shape, rates, gen, timed=False, dtype=dtype)
        print(f"checks: {len(CHECKS)} passed", flush=True)
    for key in args.shapes.split(","):
        res = cs.check_scan_heads(*SHAPES[key], rates, gen, timed=True,
                                  time_plain=False)
        res["share_of_bound"] = (res["bound_ms"] / res["device_ms"]
                                 if res["device_ms"] else None)
        out["shapes"][key] = res
    print(json.dumps(out))


if __name__ == "__main__":
    main()
