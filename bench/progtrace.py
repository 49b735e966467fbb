"""The program's own spans on the device trace: which layer of the program
launched each device operation, and which span was open while the card
sat idle.

The program records host spans at its layers' boundaries when it is
handed a tracer (``repro_torch.obs``: ``train.*``, ``cada.*``,
``sched.*``, ``prefill.*``). :func:`capture` hands it one counted from
the traced window's epoch, beside the harness's spans
(``devtrace.Spans``), and reads the profiler's Chrome trace as
``devtrace.capture`` does. :func:`parse` puts both kinds of span on the
trace's clock and ties each device operation to the call that launched
it (the ``cuda_runtime`` or ``cuda_driver`` event of the same
``correlation``):

  * the program's spans are placed by marks: :class:`Marked` makes a
    ``cudaStreamQuery`` call (no device work) as each span opens and as
    it closes, which the profiler records on its own clock, so an edge
    lands where it is among the launches. Carried over from the host's
    clock by an anchor, an edge lands 50-120 microseconds late within a
    window on an H100 (``notes["clock_wander_us"]``: the least and most
    of each opening mark less its host reading carried over), though
    the window's two ends agree to within about 50, while a span's first
    launch can come 15 microseconds after its opening. Where the marks
    do not pair off with the spans, the host's clock places them
    (``notes["placed_by"]``);
  * the harness's spans ride the anchor: a ``cudaDeviceSynchronize``
    call at the host's reading taken just before it, the window's
    opening one (on an idle device, after a first one that pays for the
    profiler's first call) or its closing one, whichever puts the host's
    clock earlier, since a call comes after its reading, never before
    (the marker's launch call, ``devtrace``'s anchor, comes after an
    allocation and a dispatch, tens of microseconds after its reading);
  * an operation belongs to the innermost program span open at its
    launch call, else to the innermost harness span, else to ``window``;
  * an idle gap is named by the innermost span of either kind open at
    its start;
  * ``notes["clock_skew_us"]``: the window's closing
    ``cudaDeviceSynchronize`` (the first after the last launch) on
    the trace's clock, less the host's reading taken just before it
    carried over by the opening one: how far the two anchors disagree;
  * ``waits``: the runtime calls that held the host for
    ``WAIT_US`` or more (a synchronise, a copy to or from pageable
    memory, an allocation, a launch into a full queue), each in the span
    it was made from: where the host waited for the device.

This module imports nothing of the port: the program's tracer is made in
:func:`capture`, and :func:`parse` takes its spans as tuples.
"""
from __future__ import annotations

import bisect
import fnmatch
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

from bench import devtrace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARK = "cudaStreamQuery"
WAIT_US = 100.0


class Marked:
    """The program's tracer in a profiled window: ``tracer``'s spans, each
    edge also marked by ``mark()`` (a ``cudaStreamQuery`` on the current
    stream). ``edges[k]`` holds the indices of the marks of the k-th span
    ``tracer`` records (they record as they close)."""

    def __init__(self, tracer, mark):
        self.tracer, self.mark = tracer, mark
        self.marks, self.edges = 0, []

    def __bool__(self) -> bool:
        return True

    def __getattr__(self, name):
        return getattr(self.tracer, name)

    def span(self, name, track="main", cat="", args=None):
        return _MarkedSpan(self, self.tracer.span(name, track, cat, args))


class _MarkedSpan:
    __slots__ = ("_owner", "_span", "_open")

    def __init__(self, owner, span):
        self._owner, self._span = owner, span

    def __enter__(self):
        owner = self._owner
        owner.mark()
        self._open = owner.marks
        owner.marks += 1
        return self._span.__enter__()

    def __exit__(self, *exc):
        out = self._span.__exit__(*exc)
        owner = self._owner
        owner.mark()
        owner.edges.append((self._open, owner.marks))
        owner.marks += 1
        return out


def innermost(spans, t: float):
    """The shortest of ``spans`` (name, start, duration, ...) open at
    ``t``, or None."""
    inner = None
    for sp in spans:
        if sp[1] <= t < sp[1] + sp[2] and (inner is None
                                           or sp[2] < inner[2]):
            inner = sp
    return inner


def merge(intervals) -> list:
    """The union of ``intervals`` (start, end), in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def overlap(a: float, b: float, union: list) -> float:
    """The length of [a, b) inside the sorted disjoint ``union``."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


@dataclass
class ProgramTrace(devtrace.Trace):
    # (name, start_us, dur_us, track): the program's spans
    program: list = field(default_factory=list)
    owners: list = field(default_factory=list)   # per op: who launched it
    waits: list = field(default_factory=list)    # (call, start_us, dur_us)
    notes: dict = field(default_factory=dict)

    def owner_at(self, t) -> str:
        """The span a launch call at ``t`` (trace clock) belongs to."""
        if t is None:
            return "window"
        inner = innermost(self.program, t) or innermost(self.spans, t)
        return inner[0] if inner else "window"

    def span_at(self, t: float) -> str:
        inner = innermost(self.program + self.spans, t)
        return inner[0] if inner else "window"

    def by_owner(self) -> dict:
        """{owner: device seconds of the operations it launched}."""
        out: dict = {}
        for (_, _, d), who in zip(self.ops, self.owners):
            out[who] = out.get(who, 0.0) + d / 1e6
        return out

    def launched_in(self, *patterns: str) -> float:
        """Device seconds of the operations launched inside a span whose
        name matches one of ``patterns`` (``fnmatch``: ``"cada.*"``)."""
        return sum(s for who, s in self.by_owner().items()
                   if any(fnmatch.fnmatchcase(who, p) for p in patterns))

    def waits_by_span(self) -> dict:
        """{span: {call: [calls, seconds]}} of the host's waits."""
        out: dict = {}
        for name, t, d in self.waits:
            per = out.setdefault(self.owner_at(t), {}).setdefault(name,
                                                                  [0, 0.0])
            per[0] += 1
            per[1] += d / 1e6
        return out

    def kernel_owners(self, needle: str) -> dict:
        """{owner: launches} of the operations whose name holds
        ``needle``."""
        out: dict = {}
        for (name, _, _), who in zip(self.ops, self.owners):
            if needle in name:
                out[who] = out.get(who, 0) + 1
        return out

    def idle(self) -> list:
        """The window's idle stretches (start, end), in order."""
        edges = [self.start_us]
        for a, b in self.merged():
            edges += [a, b]
        edges.append(self.end_us)
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_by_span(self) -> dict:
        """{span: idle seconds}: each idle stretch cut at the spans' edges,
        each piece named by the innermost span of either kind open across
        it."""
        every = self.program + self.spans
        cuts = sorted({t for sp in every for t in (sp[1], sp[1] + sp[2])})
        out: dict = {}
        for a, b in self.idle():
            pts = ([a] + cuts[bisect.bisect_right(cuts, a):
                              bisect.bisect_left(cuts, b)] + [b])
            for x, y in zip(pts, pts[1:]):
                who = self.span_at((x + y) / 2)
                out[who] = out.get(who, 0.0) + (y - x) / 1e6
        return out

    def idle_split(self, parents, bare) -> tuple:
        """(idle seconds inside the harness spans named ``parents`` that
        fall inside a program span not named in ``bare``, all the idle
        seconds inside those harness spans)."""
        outer = merge((s, s + d) for n, s, d in self.spans if n in parents)
        child = merge((s, s + d) for n, s, d, _ in self.program
                      if n not in bare)
        total = covered = 0.0
        for a, b in self.idle():
            for x, y in outer:
                lo, hi = max(a, x), min(b, y)
                if hi > lo:
                    total += hi - lo
                    covered += overlap(lo, hi, child)
        return covered / 1e6, total / 1e6


def parse(events: list, spans: list, program: list, window_s: float,
          anchor_s: float | None = None, sync_s: float | None = None,
          edges: list | None = None) -> ProgramTrace:
    """A :class:`ProgramTrace` of a device-only Chrome trace's events.
    ``spans`` (name, start, end) are the harness's and ``program`` (name,
    track, start, duration) the program's, in host seconds from the
    window's start; ``anchor_s`` and ``sync_s`` the host's readings just
    before the window's opening and closing synchronise; ``edges`` the
    program spans' marks (:class:`Marked`). Without ``anchor_s`` (or its
    call) the marker's launch is the anchor, as in ``devtrace.parse``."""
    base = devtrace.parse(events, [], window_s)
    calls, corr, waits, marks, syncs = {}, [], [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in devtrace.DEVICE_CATS:
            corr.append(c)
        elif e.get("cat") in LAUNCH_CATS:
            calls[c] = float(e["ts"])
            if e.get("name") == MARK:
                marks.append(float(e["ts"]))
            elif e.get("name") == "cudaDeviceSynchronize":
                syncs.append(float(e["ts"]))
            if float(e.get("dur", 0.0)) >= WAIT_US:
                waits.append((e["name"], float(e["ts"]), float(e["dur"])))
    syncs.sort()
    opening = [t for t in syncs if t < base.start_us]
    anchored = anchor_s is not None and bool(opening)
    start = opening[-1] - anchor_s * 1e6 if anchored else base.start_us
    # the closing synchronise: the first after the last launch and mark
    # (the profiler makes one of its own as it stops)
    last = max([calls[c] for c in corr if c in calls] + marks,
               default=start)
    closing = [t for t in syncs if t >= last]
    skew = None
    if closing and sync_s is not None:
        skew = closing[0] - (start + sync_s * 1e6)
        if anchored:
            start += min(skew, 0.0)
    placed = [(n, start + a * 1e6, d * 1e6, track)
              for n, track, a, d in program]
    notes = {} if skew is None else {"clock_skew_us": skew}
    marks.sort()
    if edges is not None and len(marks) == 2 * len(edges) == 2 * len(
            program):
        wander = [marks[i] - s for (i, _), (_, s, _, _) in zip(edges,
                                                               placed)]
        notes["clock_wander_us"] = [min(wander, default=0.0),
                                    max(wander, default=0.0)]
        placed = [(n, marks[i], marks[j] - marks[i], track)
                  for (i, j), (n, _, _, track) in zip(edges, placed)]
        notes["placed_by"] = "marks"
    else:
        notes["placed_by"] = "clock"
    tr = ProgramTrace(ops=base.ops,
                      spans=[(n, start + a * 1e6, (b - a) * 1e6)
                             for n, a, b in spans],
                      start_us=start, end_us=start + window_s * 1e6,
                      program=placed, waits=waits, notes=notes)
    tr.owners = [tr.owner_at(calls.get(c)) for c in corr]
    return tr


def capture(fn) -> ProgramTrace:
    """Run ``fn(span, tracer)`` once under the profiler, as
    ``devtrace.capture`` runs ``fn(span)``: ``tracer`` is the program's
    (a ``repro_torch.obs.Tracer`` counted from the window's epoch, so its
    spans and the harness's share one clock), each span marked
    (:class:`Marked`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import Tracer
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spans = devtrace.Spans()
        tracer = Tracer(epoch=spans.t0)
        marked = Marked(tracer, torch.cuda.current_stream().query)
        torch.cuda.synchronize()     # the first call under the profiler
        anchor_s = time.perf_counter() - spans.t0
        torch.cuda.synchronize()     # the anchor, the device idle
        torch.zeros(1, device="cuda")          # the window's marker launch
        fn(spans, marked)
        sync_s = time.perf_counter() - spans.t0
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
    program = [(e[1], e[2], e[4], e[5]) for e in tracer.spans()]
    return parse(events, spans.spans, program, window_s, anchor_s, sync_s,
                 marked.edges)
