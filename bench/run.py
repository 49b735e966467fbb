"""Run one cell of the port's benchmark once, on the card this process
runs on.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell is ``BENCHMARK.json``'s; its
configuration, traffic mix, limits and per-layer readers are files found
by name (``bench/cell.py``), and its loop is ``bench/<kind>.py`` of the
mix's ``kind``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0``
the cell's end-to-end metrics; with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.

Without a CUDA card, with fewer cards than the cell asks for, or on a
card the peaks table has no row for, it exits with 2 and prints no
result; likewise if, once the window has closed, ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded in this process.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from bench.cell import ROOT, load_cell, reader  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    """The forbidden top-level names among the module ``names``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def fail(msg: str) -> None:
    print(f"bench.run: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(2)


def parse(argv):
    p = argparse.ArgumentParser(prog="bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(cell, rec, trace: bool, kind: str) -> dict:
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": rec.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": rec.notes["memory_peak_bytes"]}
    out = {"correct": rec.correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(),
                            "idle_gaps": rec.trace.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in rec.checks.items()}
    return out


def main(argv=None) -> None:
    args = parse(argv)
    cell = load_cell(args.workload)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    # one host thread: the host's cores are shared, and idle worker threads
    # only take time from the thread that launches the work (set-up 23-27
    # s with the default pool, 13-16 s with one thread, on one H100)
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(1)

    from bench.flops import PEAKS
    if not torch.cuda.is_available():
        fail("no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{torch.cuda.device_count()} cards; {args.workload} needs "
             f"{cell.chips}")
    kind = torch.cuda.get_device_name(0)
    if kind not in PEAKS:
        fail(f"{kind!r} is not a card of the peaks table {sorted(PEAKS)}")
    loop = importlib.import_module(f"bench.{cell.traffic['kind']}")
    rec = loop.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T0, PEAKS[kind])
    found = forbidden_modules(list(sys.modules))
    if found:
        fail(f"the process loaded {found}; the benchmark measures the port "
             "alone")
    print(f"{args.workload}: {rec.attempted} "
          f"{'steps' if rec.kind == 'train' else 'requests'} in "
          f"{rec.window_s:.3f} s, {len(rec.rounds)} rounds; set-up "
          f"{json.dumps(rec.notes.get('setup', {}))}; readings "
          f"{json.dumps(rec.notes.get('readings', {}))[:4000]}", flush=True)
    out = result(cell, rec, bool(args.trace), kind)
    for k, (v, lim) in rec.checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
