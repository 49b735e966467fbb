"""``bench/layers.py`` on the CPU at the small cells' sizes, its profiled
sub-window stood in for by a trace of one kernel launched in the middle of
each of the program's spans: the three sub-windows run, the tracer reaches
the program, and the summary holds every reading, the scheduler's
counters and round arguments among them."""
from __future__ import annotations

import math
import time

import pytest

from bench import devtrace, layers, progtrace
from bench.conftest import small_serve_cell, small_train_cell


def fake_capture(fn):
    """``progtrace.capture`` without a profiler: a marker, then a kernel
    launched in the middle of each program span, running 1 µs."""
    from repro_torch.obs import Tracer
    spans = devtrace.Spans()
    tracer = Tracer(epoch=spans.t0)
    fn(spans, tracer)
    window_s = time.perf_counter() - spans.t0
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 0.0, "args": {"correlation": 0}},
              {"ph": "X", "cat": "kernel", "name": "marker", "ts": 1.0,
               "dur": 1.0, "args": {"correlation": 0}}]
    for i, e in enumerate(tracer.spans(), 1):
        at = (e[4] + e[5] / 2) * 1e6
        events += [{"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "ts": at,
                    "args": {"correlation": i}},
                   {"ph": "X", "cat": "kernel", "name": f"k_{e[1]}",
                    "ts": at + 1.0, "dur": 1.0, "args": {"correlation": i}}]
    program = [(e[1], e[2], e[4], e[5]) for e in tracer.spans()]
    return progtrace.parse(events, spans.spans, program, window_s)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_the_runner_reads_every_layer(monkeypatch, cpu, kind):
    monkeypatch.setattr(progtrace, "capture", fake_capture)
    if kind == "train":
        out = layers.run_train(small_train_cell(), 3, 0.2, 2, cpu)
        want = {"train.step", "train.grads", "cada.lhs", "cada.server"}
    else:
        out = layers.run_serve(small_serve_cell(), 3, 0.2, 2, cpu)
        want = {"sched.round", "sched.batch", "prefill.attn", "prefill.mlp"}
    assert len(out["metrics"]) == 3
    assert all(math.isfinite(v) and v >= 0 for v in out["metrics"].values())
    assert 0 < out["coverage"] <= 1
    assert want <= set(out["host_ms_by_span"])
    assert want - {"train.step", "sched.round"} <= set(
        out["device_ms_by_span"])
    assert len(out["cost"]["off_ms"]) == len(out["cost"]["on_ms"]) == 2
    if kind == "serve":
        sched = out["sched"]
        assert sched["pad_share"] == sched["pad_share_harness"]
        assert 0 <= sched["pad_share"] < 100 and sched["rounds"] > 0
        assert sched["args_fill_padded_tokens"]
        assert 0 < sched["requests_per_round"] <= sched["slots"][-1]
