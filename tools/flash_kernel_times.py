"""Check and time a flash attention source on the card at the main path's
shapes.

    python3 tools/flash_kernel_times.py --tag <name> [--source FILE.cu]
        [--shapes served,qwen2_vl,...] [--no-checks]

Builds ``FILE.cu`` (default: the checkout's
``src/repro_torch/kernels/csrc/flash_attention.cu``) with the build's nvcc
flags into ``build/flash_kernel_times/`` and loads it in place of the
wrapper's library. Any source of the same C interface takes that path: an
earlier commit's (``git show REV:src/repro_torch/kernels/csrc/
flash_attention.cu > build/parent.cu``) or an edited copy under the
git-ignored ``build/``, so two sources are compared in one call on one
card, in turns (parent, change, change, parent).

Each case is ``chip_smoke.check_flash`` on bf16 operands: the kernel
against its plain version under the bf16 band (``flash_bf16_gaps``), two
identical calls bit-equal, one launch a call. First (unless
``--no-checks``) untimed at lengths and windows around the 128-row work
items and 64-key tiles, then timed at the shapes of ``SHAPES``: the call
and device time, the plain version's, scaled_dot_product_attention's (with
an explicit boolean mask where there is a window) and the bound. Ends with
one JSON line of the timed numbers, tagged ``--tag``.
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# name: (B, S, Hq, Hkv, hd, window)
SHAPES = {
    "served": (2, 2048, 32, 32, 80, 0),            # zamba2-2.7b prefill
    "qwen2_vl": (2, 2048, 12, 2, 128, 0),          # qwen2-vl-2b prefill
    "rank_80": (2, 2048, 16, 16, 80, 0),           # zamba2, one of 2 ranks
    "rank_64": (2, 2048, 8, 4, 64, 0),             # granite-moe, one of 2
    "window_8192": (1, 12288, 16, 8, 128, 8192),   # internlm2, long_500k
}
CHECKS = [(2, s, 8, 2, hd, w) for hd in (64, 80, 128)
          for s in (127, 129, 257) for w in (0, 129)]


def load_source(src: Path) -> Path:
    """Build ``src`` (unless built) and bind the wrapper to it."""
    tag = hashlib.sha1(src.read_bytes()
                       + " ".join(build.NVCC_FLAGS).encode()).hexdigest()
    out = build.BUILD_DIR.parent / "flash_kernel_times" / f"lib-{tag[:12]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        str(src)], check=True)
    lib = fa.bind(ctypes.CDLL(str(out)))
    fa._lib = lambda: lib
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", required=True)
    ap.add_argument("--source", type=Path,
                    default=build.CSRC / "flash_attention.cu")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--no-checks", action="store_true")
    args = ap.parse_args()
    card = cs.phase_card()
    print(f"source {args.source} -> {load_source(args.source)}", flush=True)
    rates = cs.card_rates(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    if not args.no_checks:
        for shape in CHECKS:
            cs.check_flash(*shape, rates, gen, timed=False)
        print(f"checks: {len(CHECKS)} passed", flush=True)
    out = {"tag": args.tag, "card": card, "source": str(args.source),
           "shapes": {}}
    for key in args.shapes.split(","):
        res = cs.check_flash(*SHAPES[key], rates, gen, timed=True)
        res["share_of_bound"] = (res["bound_ms"] / res["device_ms"]
                                 if res["device_ms"] else None)
        out["shapes"][key] = res
    print(json.dumps(out))


if __name__ == "__main__":
    main()
