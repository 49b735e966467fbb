"""Chrome-trace/Perfetto JSON export for :class:`repro_torch.obs.trace.Tracer`
(a copy of the JAX package's ``obs/export.py``).

Emits the Trace Event Format's *JSON Object Format*::

    {"traceEvents": [...], "displayTimeUnit": "ms"}

Every tracer track becomes one thread (``tid``) under a single process,
named via ``"M"`` metadata events and ordered by first use
(``thread_sort_index``). Complete spans become ``"X"`` events with
``ts``/``dur`` in microseconds — simulated seconds map directly onto the
timeline's microsecond axis, so a 30 s simulated WAN round and a 30 ms
real pipelined round both render with correct relative proportions.

:func:`validate_chrome_trace` is a dependency-free structural validator
(``python -m repro_torch.obs.export --validate out.json`` runs it on a
file); it checks exactly the invariants the viewer relies on, and is
itself pinned by tests/test_torch_obs.py.
"""

from __future__ import annotations

import json
from typing import Any

__all__ = ["to_chrome_trace", "write_chrome_trace", "validate_chrome_trace"]

_PID = 1
# Phases this exporter emits (+ those a hand-edited trace may contain).
_KNOWN_PHASES = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t", "f"}


def to_chrome_trace(tracer, *, meta: dict | None = None) -> dict:
    """Convert a Tracer's events into a Chrome-trace JSON object."""
    events: list[dict] = []
    tids = {name: i for i, name in enumerate(tracer.tracks)}

    events.append({"ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
                   "args": {"name": "repro"}})
    for name, tid in tids.items():
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_sort_index", "args": {"sort_index": tid}})

    for ph, name, track, cat, t_s, dur_s, args in tracer.events:
        ev: dict[str, Any] = {
            "ph": ph,
            "name": name,
            "pid": _PID,
            "tid": tids[track],
            "ts": round(t_s * 1e6, 3),
        }
        if cat:
            ev["cat"] = cat
        if ph == "X":
            ev["dur"] = round(dur_s * 1e6, 3)
        elif ph == "i":
            ev["s"] = "t"  # thread-scoped instant
        if args is not None:
            ev["args"] = args
        events.append(ev)

    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = meta
    return out


def write_chrome_trace(tracer, path: str, *, meta: dict | None = None) -> dict:
    """Export ``tracer`` to ``path`` as Chrome-trace JSON; returns the dict."""
    obj = to_chrome_trace(tracer, meta=meta)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def _fail(path: str, msg: str) -> None:
    raise ValueError(f"invalid chrome trace at {path}: {msg}")


def validate_chrome_trace(obj: Any) -> int:
    """Structurally validate a Chrome-trace JSON object.

    Checks the JSON Object Format invariants the trace viewer depends on:
    a ``traceEvents`` list of dicts; every event has a known ``ph``, a
    string ``name``, integer ``pid``/``tid``, and a finite numeric ``ts``;
    ``"X"`` events carry a non-negative numeric ``dur``; ``"M"`` and
    ``"C"`` events carry a dict ``args``. Returns the event count;
    raises ``ValueError`` (with a JSON-path-ish locator) on violation.
    """
    if not isinstance(obj, dict):
        _fail("$", f"top level must be an object, got {type(obj).__name__}")
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        _fail("$.traceEvents", "missing or not a list")
    for i, ev in enumerate(evs):
        loc = f"$.traceEvents[{i}]"
        if not isinstance(ev, dict):
            _fail(loc, "event is not an object")
        ph = ev.get("ph")
        if ph not in _KNOWN_PHASES:
            _fail(loc + ".ph", f"unknown phase {ph!r}")
        if not isinstance(ev.get("name"), str):
            _fail(loc + ".name", "missing or not a string")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                _fail(loc + f".{k}", "missing or not an integer")
        if ph == "M":
            if not isinstance(ev.get("args"), dict):
                _fail(loc + ".args", "metadata event needs an args object")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts != ts:
            _fail(loc + ".ts", f"missing or non-finite: {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or not dur >= 0:
                _fail(loc + ".dur", f"missing or negative: {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                _fail(loc + ".args", "counter event needs a non-empty args object")
            for k, v in args.items():
                if not isinstance(v, (int, float)):
                    _fail(loc + f".args.{k}", "counter value not numeric")
    return len(evs)


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Validate a Chrome-trace JSON file against the schema.")
    p.add_argument("--validate", metavar="FILE", required=True,
                   help="path to a Chrome-trace JSON file")
    args = p.parse_args(argv)
    with open(args.validate) as f:
        obj = json.load(f)
    try:
        n = validate_chrome_trace(obj)
    except ValueError as e:
        import sys
        print(e, file=sys.stderr)
        return 1
    tracks = sum(1 for e in obj["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "thread_name")
    spans = sum(1 for e in obj["traceEvents"] if e.get("ph") == "X")
    print(f"{args.validate}: OK ({n} events, {spans} spans, {tracks} tracks)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
