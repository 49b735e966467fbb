"""Lightweight span/event recorder with a strict no-op fast path (a copy
of the JAX package's ``obs/trace.py``).

A :class:`Tracer` records *complete spans* (name, track, start, duration),
*instant events*, and *counter samples* into plain Python lists — no
torch, no I/O, no threads. Timestamps are plain float seconds on whichever clock
the caller uses:

- real runs open spans with :meth:`Tracer.span` (``time.perf_counter``);
- the discrete-event sim records spans on the *simulated* clock with
  :meth:`Tracer.add_span` — the export layer treats both identically, so
  a real pipelined run and a simulated WAN run open in the same timeline
  viewer (chrome://tracing / Perfetto via :mod:`repro_torch.obs.export`).

Tracks
------
A *track* is a named horizontal lane in the timeline (one per simulated
worker, one for the server, one for the cohort pipeline, ...). Tracks are
created on first use and keep insertion order in the exported view.

Disabled path
-------------
``NULL`` is a module-level :class:`NullTracer` singleton: every method is
a no-op, ``bool(NULL)`` is ``False`` (so ``if tracer:`` guards skip
argument construction entirely), and ``NULL.span(...)`` returns one
reusable null context manager — no allocation, no clock read. Hot loops
take ``trace=None`` and normalize via :func:`as_tracer`.
"""

from __future__ import annotations

import time

__all__ = ["Tracer", "NullTracer", "NULL", "as_tracer"]


class _NullSpan:
    """Reusable no-op context manager returned by ``NULL.span(...)``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every method is a no-op, truthiness is False."""

    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        return False

    def span(self, name, track="main", cat="", args=None):
        return _NULL_SPAN

    def add_span(self, name, start_s, dur_s, *, track="main", cat="", args=None):
        pass

    def instant(self, name, t_s=None, *, track="main", args=None):
        pass

    def counter(self, name, t_s, value, *, track="counters"):
        pass

    def aggregate(self, track=None):
        return {}


NULL = NullTracer()


def as_tracer(trace) -> "Tracer | NullTracer":
    """Normalize a ``trace=`` argument: None -> the NULL singleton."""
    return NULL if trace is None else trace


class _Span:
    """Context manager recording one wall-clock span on exit."""

    __slots__ = ("_tr", "name", "track", "cat", "args", "_t0")

    def __init__(self, tr, name, track, cat, args):
        self._tr = tr
        self.name = name
        self.track = track
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tr
        tr._events.append(("X", self.name, self.track, self.cat,
                           self._t0 - tr._epoch, t1 - self._t0, self.args))
        return False


class Tracer:
    """Records spans/instants/counters into memory; export later.

    Events are stored as tuples ``(ph, name, track, cat, t_s, dur_s, args)``
    with ``ph`` one of ``"X"`` (complete span), ``"i"`` (instant),
    ``"C"`` (counter sample, ``args`` is a ``{series: value}`` dict).
    All times are float seconds relative to the tracer's epoch (for
    wall-clock spans) or the caller's clock (for :meth:`add_span`).
    """

    enabled = True

    def __init__(self, epoch: float | None = None) -> None:
        # ``epoch``: a ``time.perf_counter`` reading to count the spans
        # from, so that they share another recorder's clock
        self._epoch = time.perf_counter() if epoch is None else epoch
        self._events: list[tuple] = []
        self._tracks: list[str] = []
        self._track_set: set[str] = set()

    def __bool__(self) -> bool:
        return True

    def __len__(self) -> int:
        return len(self._events)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, track: str = "main", cat: str = "",
             args: dict | None = None) -> _Span:
        """Open a wall-clock span (``with tracer.span("step"): ...``)."""
        self._touch(track)
        return _Span(self, name, track, cat, args)

    def add_span(self, name: str, start_s: float, dur_s: float, *,
                 track: str = "main", cat: str = "",
                 args: dict | None = None) -> None:
        """Record a complete span with explicit times (e.g. sim clock)."""
        self._touch(track)
        self._events.append(("X", name, track, cat, float(start_s),
                             float(dur_s), args))

    def instant(self, name: str, t_s: float | None = None, *,
                track: str = "main", args: dict | None = None) -> None:
        """Record a zero-duration marker (gate decisions, errors, ...)."""
        if t_s is None:
            t_s = time.perf_counter() - self._epoch
        self._touch(track)
        self._events.append(("i", name, track, "", float(t_s), 0.0, args))

    def counter(self, name: str, t_s: float | None, value: float, *,
                track: str = "counters") -> None:
        """Record one sample of a counter series (pool bytes, queue depth);
        ``t_s`` None is now on the wall clock."""
        if t_s is None:
            t_s = time.perf_counter() - self._epoch
        self._touch(track)
        self._events.append(("C", name, track, "", float(t_s), 0.0,
                             {name: float(value)}))

    # -- reading -----------------------------------------------------------

    @property
    def tracks(self) -> list[str]:
        return list(self._tracks)

    @property
    def events(self) -> list[tuple]:
        return self._events

    def spans(self, track: str | None = None) -> list[tuple]:
        """All complete spans, optionally restricted to one track."""
        return [e for e in self._events
                if e[0] == "X" and (track is None or e[2] == track)]

    def aggregate(self, track: str | None = None) -> dict[str, dict]:
        """Per-name span aggregates: ``{name: {count, total_s, max_s}}``:
        the host time of each phase (the benchmark's host-time readings
        of the program's spans, ``bench/layers.py``)."""
        out: dict[str, dict] = {}
        for e in self._events:
            if e[0] != "X" or (track is not None and e[2] != track):
                continue
            agg = out.setdefault(e[1], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += e[5]
            if e[5] > agg["max_s"]:
                agg["max_s"] = e[5]
        return out

    def _touch(self, track: str) -> None:
        if track not in self._track_set:
            self._track_set.add(track)
            self._tracks.append(track)
