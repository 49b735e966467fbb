"""The traced sub-window: ``torch.profiler`` over a fixed amount of work,
read back from its Chrome trace.

  * The device's busy time is the union of the intervals in which an
    operation (a kernel, a copy, a fill) ran, clipped to the window: two
    operations that overlap count once.
  * The window runs on the host's clock from a marker launch to the
    synchronise that ends it; the profiler records the device alone.
  * Idle gaps are named by the harness's innermost span (recorded on the
    host around its calls into the program) open at the gap's start.

A window in which the profiler recorded no device operation raises: an
empty trace never reads as zero.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's hand-written kernels (``src/repro_torch/kernels/csrc``)
PORT_KERNELS = ("amsgrad_kernel", "row_sq_kernel", "row_mean_kernel",
                "ssm_scan_kernel", "ssm_split_bf16_kernel",
                "flash_fwd_kernel")
# matrix products of cuBLAS, cuBLASLt and CUTLASS, by kernel name
GEMM_NEEDLES = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def is_gemm(name: str) -> bool:
    low = name.lower()
    return not is_port_kernel(name) and any(k in low for k in GEMM_NEEDLES)


def is_eager(name: str) -> bool:
    """A kernel of the eager PyTorch work: neither a matrix product, nor a
    port kernel, nor a copy or fill between memories."""
    return not (is_gemm(name) or is_port_kernel(name)
                or name.startswith(("Memcpy", "Memset")))


class EmptyTrace(RuntimeError):
    pass


@dataclass
class Trace:
    ops: list                    # (name, start_us, dur_us) device operations
    spans: list                  # (name, start_us, dur_us) harness spans
    start_us: float
    end_us: float
    units: dict = field(default_factory=dict)   # what the window held

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def kernels(self, *needles: str) -> list:
        """The device operations whose name contains any of ``needles``."""
        return [o for o in self.ops if any(n in o[0] for n in needles)]

    def merged(self) -> list:
        """Union of the device intervals inside the window, in order."""
        out = []
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(s, self.start_us), min(s + d, self.end_us)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) / 1e6

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for name, _, d in self.ops:
            total[name] = total.get(name, 0.0) + d / 1e6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest idle gaps as [host span open at the gap's
        start, seconds]."""
        edges = [self.start_us]
        for a, b in self.merged():
            edges += [a, b]
        edges.append(self.end_us)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.span_at(a), (b - a) / 1e6] for a, b in gaps[:n]]

    def span_at(self, t: float) -> str:
        inner = None
        for name, s, d in self.spans:
            if s <= t < s + d and (inner is None or d < inner[2]):
                inner = (name, s, d)
        return inner[0] if inner else "window"


def parse(events: list, spans: list, window_s: float) -> Trace:
    """A :class:`Trace` of a device-only Chrome trace's events. The host's
    clock is tied to the trace's at the launch of the window's first
    device operation (the marker): ``spans`` (name, start, end) in host
    seconds from the window's start move onto the trace's clock."""
    ops, calls, first = [], {}, None
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in DEVICE_CATS:
            op = (e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
            ops.append(op)
            if first is None or op[1] < first[0]:
                first = (op[1], e.get("args", {}).get("correlation"))
        elif e.get("cat") == "cuda_runtime":
            calls[e.get("args", {}).get("correlation")] = float(e["ts"])
    if not ops or not calls:
        raise EmptyTrace("the profiler recorded no device operation in the "
                         "window")
    start = calls.get(first[1], min(calls.values()))
    return Trace(ops=ops, spans=[(n, start + a * 1e6, (b - a) * 1e6)
                                 for n, a, b in spans],
                 start_us=start, end_us=start + window_s * 1e6)


class Spans:
    """The harness's host spans of a traced window, on the host clock."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.spans: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        a = time.perf_counter() - self.t0
        try:
            yield
        finally:
            self.spans.append((name, a, time.perf_counter() - self.t0))


def capture(fn) -> Trace:
    """Run ``fn(span)`` once with the profiler tracing the device alone
    (host-side recording would slow the host and read as idle device
    time), from a marker launch to the synchronise that ends the window;
    ``span(name)`` is a context manager recording one harness span. The
    trace goes to a file in ``TMPDIR``, read back and deleted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spans = Spans()
        torch.zeros(1, device="cuda")          # the window's marker launch
        fn(spans)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - spans.t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events, spans.spans, window_s)
