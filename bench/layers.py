"""A cell's device and host time by the program's layer, on the card this
process runs on:

    python3 -m bench.layers --workload <cell> --seed <n> [--seconds 10] \\
        [--pairs 4]

from the root of a checkout. It sets the cell up as ``bench.run`` does
(``bench/train.py``, ``bench/serve.py``), then runs, one after the
other:

  1. a timed window of ``--seconds``, tracing off;
  2. ``--pairs`` pairs of sub-windows of the mix's ``trace_steps`` or
     ``trace_rounds`` units each, the program's tracer off, then on and
     no profiler (the spans-only sub-windows): the cost of tracing on, a
     unit, against the pair's own untraced units and against the timed
     window's; the first spans-only sub-window gives the host-time
     readings (``Tracer.aggregate``), free of the profiler's slowdown;
  3. a profiled sub-window of as many units, with the harness's spans
     (``batch``, ``step``; ``run_round``) and the program's
     (``bench/progtrace.py``): device time by the span that launched it,
     idle time by the span open across it, the host's waits by span.

The last line of standard output is one JSON object: ``metrics`` (the
per-layer readings of the program's spans), ``coverage`` (the share of
the sub-window's device time launched inside the program's layer spans,
the harness's feed left out), ``idle`` (the share of the idle time inside
the harness's unit spans that falls in a program span below the unit's
own), ``kernels`` ({port kernel: {span: launches}}), ``notes``
(``clock_skew_us``, ``clock_wander_us`` and how the program's spans were
placed: ``bench/progtrace.py``), ``device_ms_by_span``,
``top_ops_ms_by_span``, ``idle_ms_by_span`` (the device's idle time
under each span), ``host_ms_by_span`` and ``waits_ms_by_span`` (the
calls that held the host: {call: [calls, ms]}) a unit, ``idle_gaps``,
``cost`` and ``device``; of a serving cell also ``sched`` (the
scheduler's counters and round arguments over the first spans-only
sub-window: ``pad_share`` from ``sched.padded_tokens`` and
``sched.prompt_tokens``, beside ``pad_share.serve``'s reading of the
harness's records of the same rounds, and the requests, slots and padded
length a round from ``sched.round``'s arguments). Without a CUDA card it
exits with 2.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

from bench.cell import ROOT, Record, load_cell, reader  # noqa: E402

# the program's spans that should launch all of a cell's device work
LAYERS = {"train": ("train.grads", "cada.*"),
          "serve": ("prefill.*", "sched.*")}
# the harness's span around a unit, and the program's own outermost one
UNIT = {"train": ("step", "train.step"), "serve": ("run_round", "sched.round")}
# each port kernel's launches belong to this span
KERNEL_SPANS = {"train": {"amsgrad_kernel": "cada.server",
                          "row_sq_kernel": "cada.lhs",
                          "row_mean_kernel": "cada.eq3"},
                "serve": {"flash_fwd_kernel_wgmma": "prefill.attn"}}


def metrics(kind: str, trace, host: dict, units: int) -> dict:
    """The per-layer readings of the program's spans: device ms a unit
    launched inside a layer's spans (the profiled sub-window), host ms a
    unit of a span (``host``: the spans-only sub-window's
    ``Tracer.aggregate``, over ``units``)."""
    def dev(*names):
        return trace.launched_in(*names) * 1e3 / units

    def host_ms(name):
        return host[name]["total_s"] * 1e3 / units if name in host else None
    if kind == "train":
        return {"grads_device_ms_per_step.train": dev("train.grads"),
                "cada_device_ms_per_step.train": dev("cada.*"),
                "host_ms_per_step.train": host_ms("train.step")}
    return {"attn_device_ms_per_round.serve": dev("prefill.attn"),
            "mlp_device_ms_per_round.serve": dev("prefill.mlp"),
            "sched_host_ms_per_round.serve": host_ms("sched.batch")}


def summary(kind: str, trace, host: dict, units: int) -> dict:
    """What the profiled sub-window (``trace``) and the spans-only one
    (``host``) say, a unit."""
    total = sum(d for _, _, d in trace.ops) / 1e6
    fed = trace.launched_in("batch")
    parent, bare = UNIT[kind]
    covered, idle = trace.idle_split((parent,), (bare,))
    top: dict = {}
    for (name, _, d), who in zip(trace.ops, trace.owners):
        per = top.setdefault(who, {})
        per[name[:64]] = per.get(name[:64], 0.0) + d / 1e3 / units
    return {
        "metrics": metrics(kind, trace, host, units),
        "coverage": trace.launched_in(*LAYERS[kind]) / (total - fed),
        "idle": {"in_child_share": covered / idle if idle else None,
                 "idle_ms": idle * 1e3 / units},
        "kernels": {k: trace.kernel_owners(k) for k in KERNEL_SPANS[kind]},
        "notes": trace.notes,
        "device_ms_by_span": {k: v * 1e3 / units for k, v in
                              sorted(trace.by_owner().items(),
                                     key=lambda kv: -kv[1])},
        "top_ops_ms_by_span": {k: dict(sorted(v.items(),
                                              key=lambda kv: -kv[1])[:4])
                               for k, v in top.items()},
        "idle_ms_by_span": {k: v * 1e3 / units for k, v in
                            sorted(trace.idle_by_span().items(),
                                   key=lambda kv: -kv[1])},
        "host_ms_by_span": {k: v["total_s"] * 1e3 / units
                            for k, v in host.items()},
        "waits_ms_by_span": {k: {c: [n / units, t * 1e3 / units]
                                 for c, (n, t) in v.items()}
                             for k, v in trace.waits_by_span().items()},
        "busy_ms": trace.busy_s * 1e3 / units,
        "window_ms": trace.window_s * 1e3 / units,
        "idle_gaps": trace.idle_gaps(),
    }


def sched_reading(tracer, rounds: list) -> dict:
    """The scheduler's own account of the rounds ``tracer`` recorded: the
    padding share from its counters, beside ``pad_share.serve``'s reading
    of the harness's records of the same ``rounds`` (slots, padded,
    [lengths]); and from each ``sched.round``'s arguments the requests,
    slots and padded length a round."""
    sums: dict = {}
    for e in tracer.events:
        if e[0] == "C":
            sums[e[1]] = sums.get(e[1], 0.0) + e[6][e[1]]
    args = [e[6] for e in tracer.spans("sched") if e[1] == "sched.round"]
    filled, useful = sums["sched.padded_tokens"], sums["sched.prompt_tokens"]
    return {"pad_share": 100.0 * (filled - useful) / filled,
            "pad_share_harness": reader("pad_share.serve")(
                Record(kind="serve", model={}, traffic={}, peak={},
                       rounds=rounds)),
            "prompt_tokens": useful, "padded_tokens": filled,
            "rounds": len(args),
            "requests_per_round": statistics.mean(len(a["uids"])
                                                  for a in args),
            "slots": sorted({a["slots"] for a in args}),
            "padded_mean": statistics.mean(a["padded"] for a in args),
            "args_fill_padded_tokens": sum(a["slots"] * a["padded"]
                                           for a in args) == filled}


def cost(window_ms: float, off: list, on: list) -> dict:
    """Tracing on against off, ms a unit: each pair's two sub-windows, and
    the first spans-only sub-window against the timed window."""
    return {"window_ms": window_ms, "off_ms": off, "on_ms": on,
            "paired": statistics.median(b / a - 1 for a, b in zip(off, on)),
            "vs_window": on[0] / window_ms - 1}


# ---------------------------------------------------------------- train

def run_train(cell, seed: int, seconds: float, pairs: int, device) -> dict:
    import torch
    from bench import progtrace, train, weights
    from repro_torch.models.config import ModelConfig
    from repro_torch.obs import Tracer
    tr = cell.traffic
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    theta0 = weights.draw(weights.program_shapes(ModelConfig(
        **cell.config["model"])), cell.config["init"], seed, device)
    prog = train.Program(cell, device, theta0)
    del theta0
    feed = train.feeder(cell, seed, device)
    nxt = iter(range(10 ** 9))

    def step(trace=None):
        prog.state, _ = prog.step_fn(prog.state, {"tokens": feed(next(nxt))},
                                     trace=trace)

    for _ in range(tr["first_steps"]):
        step()
    sync()
    n = tr["trace_steps"]

    def block(trace=None) -> float:
        """``n`` steps; ms a step."""
        t = time.perf_counter()
        for _ in range(n):
            step(trace)
        sync()
        return (time.perf_counter() - t) * 1e3 / n

    steps, t = 0, time.perf_counter()
    while time.perf_counter() - t < seconds:
        step()
        steps += 1
    sync()
    window_ms = (time.perf_counter() - t) * 1e3 / steps
    off, on, host = [], [], None
    for _ in range(pairs):
        off.append(block())
        tracer = Tracer()
        on.append(block(tracer))
        host = host or tracer.aggregate()

    def traced(span, tracer):
        for _ in range(n):
            with span("batch"):
                batch = {"tokens": feed(next(nxt))}
            with span("step"):
                prog.state, _ = prog.step_fn(prog.state, batch,
                                             trace=tracer)
    trace = progtrace.capture(traced)
    out = summary("train", trace, host, n)
    out["cost"] = cost(window_ms, off, on)
    out["window_units"] = steps
    return out


# ---------------------------------------------------------------- serve

class Traced:
    """The scheduler as ``serve.Loop`` drives it, each round handed the
    program's tracer ``trace`` (None: off)."""

    def __init__(self, sched):
        self.sched, self.trace = sched, None

    def __getattr__(self, name):
        return getattr(self.sched, name)

    def run_round(self):
        return self.sched.run_round(trace=self.trace)


def run_serve(cell, seed: int, seconds: float, pairs: int, device) -> dict:
    import numpy as np
    import torch
    from bench import progtrace, serve, traffic, weights
    from repro_torch.distributed.scheduler import DecodeScheduler, Request
    from repro_torch.models.config import ModelConfig
    from repro_torch.obs import Tracer
    tr = cell.traffic
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    cfg = ModelConfig(**cell.config["model"])
    theta = weights.draw(weights.program_shapes(cfg), cell.config["init"],
                         seed, device)
    sched = DecodeScheduler(cfg, weights.unflatten(dict(theta)),
                            n_slots=tr["n_slots"], max_seq=tr["max_seq"])
    del theta
    warm = np.random.default_rng([int(seed), 9])
    for group in traffic.rounds(tr):
        for n in group:
            prompt = traffic.zipf_tokens(warm, (n,), cfg.vocab)
            sched.submit(Request(uid=-1, prompt=prompt.astype(np.int32),
                                 max_new=tr["max_new"]))
        sched.run_round()
    sched.finished.clear()
    sync()
    traced_sched = Traced(sched)
    loop = serve.Loop(cell, seed, traced_sched, Request)
    n = tr["trace_rounds"]

    def block(trace=None) -> float:
        """``n`` rounds of every client, the last sending nothing after
        it; ms a round."""
        traced_sched.trace = trace
        t = time.perf_counter()
        for c in range(tr["clients"]):
            loop.submit(c, time.perf_counter())
        for j in range(n):
            loop.round(math.inf if j < n - 1 else -math.inf)
        traced_sched.trace = None
        return (time.perf_counter() - t) * 1e3 / n

    start = time.perf_counter()
    for c in range(tr["clients"]):
        loop.submit(c, start)
    end, done = start, 0
    while loop.sched.queue:
        end = loop.round(start + seconds)
        done += 1
    window_ms = (end - start) * 1e3 / done
    off, on, first = [], [], None
    for _ in range(pairs):
        off.append(block())
        tracer, seen = Tracer(), len(loop.rounds)
        on.append(block(tracer))
        first = first or (tracer, loop.rounds[seen:])

    def traced(span, tracer):
        traced_sched.trace = tracer
        for c in range(tr["clients"]):
            loop.submit(c, time.perf_counter())
        for j in range(n):
            with span("run_round"):
                loop.round(math.inf if j < n - 1 else -math.inf)
        traced_sched.trace = None
    trace = progtrace.capture(traced)
    out = summary("serve", trace, first[0].aggregate(), n)
    out["sched"] = sched_reading(*first)
    out["cost"] = cost(window_ms, off, on)
    out["window_units"] = done
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bench.layers")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--pairs", type=int, default=4)
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["OMP_NUM_THREADS"] = "1"
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("bench.layers: no CUDA card", file=sys.stderr)
        raise SystemExit(2)
    device = torch.device("cuda", 0)
    run = run_train if cell.traffic["kind"] == "train" else run_serve
    out = run(cell, args.seed, args.seconds, args.pairs, device)
    out["device"] = {"kind": torch.cuda.get_device_name(0),
                     "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    out["cell"], out["seed"] = args.workload, args.seed
    out["process_s"] = time.perf_counter() - T0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
