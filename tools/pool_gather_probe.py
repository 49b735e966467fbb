"""Time the host side of a cohort round's gather and scatter on the card's
host.

    PYTHONPATH=src python3 tools/pool_gather_probe.py

One (M, n_flat) fp32 plane at phase 9b's size (M = 10,000, n_flat =
101,776, 4.07 GB), C = 64 rows a round, gathered with ``index_select``
into a pinned (C, n_flat) slot and scattered back with ``index_copy_``,
as ``WorkerPool`` does. Three planes: zeros written up front
(``torch.zeros``, what the pool holds), zeros whose pages are committed
only when touched (numpy's calloc), and a plane whose rows were written
before. For each: the first gather of 12 rounds of fresh rows, their
median, and the scatter. Prints the card's name and power limit first
and ends with one JSON line of every number.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

M, N_FLAT, C, ROUNDS = 10_000, 101_776, 64, 12


def _rounds(fn, plane, buf) -> list[float]:
    """ms of ``fn(plane, idx, buf)`` for ROUNDS draws of C sorted rows."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(ROUNDS):
        idx = torch.as_tensor(np.sort(rng.choice(M, C, replace=False)))
        t0 = time.perf_counter()
        fn(plane, idx, buf)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def gather(plane, idx, buf):
    torch.index_select(plane, 0, idx, out=buf)


def scatter(plane, idx, buf):
    plane.index_copy_(0, idx, buf)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pool_gather_probe: no CUDA device (pinned memory "
                         "needs one)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    buf = torch.empty((C, N_FLAT), dtype=torch.float32, pin_memory=True)
    buf.fill_(1.0)
    results = {}
    planes = {
        "zeros written up front": torch.zeros((M, N_FLAT)),
        "zeros committed on touch (calloc)": torch.from_numpy(
            np.zeros((M, N_FLAT), np.float32)),
    }
    for name in list(planes):
        plane = planes.pop(name)
        g = _rounds(gather, plane, buf)
        s = _rounds(scatter, plane, buf)
        # the same draws again: those rows now hold written pages
        g2 = _rounds(gather, plane, buf)
        results[name] = {"gather_first_ms": g[0],
                         "gather_median_ms": statistics.median(g),
                         "scatter_median_ms": statistics.median(s),
                         "gather_again_median_ms": statistics.median(g2)}
        print(f"{name}: gather of {C} x {N_FLAT} fp32 rows "
              f"({C * N_FLAT * 4:,} B) into a pinned slot, first "
              f"{g[0]:.3f} ms, median {statistics.median(g):.3f} ms; "
              f"scatter median {statistics.median(s):.3f} ms; the same "
              f"rows gathered again, median {statistics.median(g2):.3f} "
              f"ms (host of {card})")
        del plane
    print(json.dumps({"card": card, "rows_bytes": C * N_FLAT * 4,
                      "results": results}))


if __name__ == "__main__":
    main()
