"""Counter/gauge/histogram registry and per-rule communication ledgers (a
copy of the JAX package's ``obs/metrics.py``).

Two layers:

- :class:`MetricsRegistry` — a small named-metric registry (counter,
  gauge, histogram) with JSONL and Prometheus-textfile sinks. Pure
  host-side Python/numpy; callers accumulate *device-side* (the cohort
  driver buffers round metrics on the device and fetches every
  ``metrics_every`` rounds — see ``flat.run_cohort_rounds``) and feed the
  fetched host values here.
- :class:`CommLedger` — the per-rule communication ledger: uploads,
  bytes up/down split by wire format (dense/quantized/sparse), LHS-vs-RHS
  gate margins, staleness histogram, stale-ring occupancy, ``WorkerPool``
  resident-vs-mapped bytes, and async pending-writeback depth. Byte
  accounting reuses the strategy's property-pinned ``bytes_per_upload``
  numbers verbatim (it sums the round metrics' ``bytes_up`` values in
  order), so ledger totals are bit-equal to the engine's own accounting —
  pinned per rule in tests/test_torch_obs.py.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "CommLedger", "write_jsonl"]


# --------------------------------------------------------------- registry

class Counter:
    """Monotonically increasing value."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def snapshot(self):
        return self.value


class Gauge:
    """Last-set value (pool residency, queue depth, ...)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative ``le`` export).

    ``bounds`` are the inclusive upper bin edges; one overflow bucket
    (``+Inf``) is implicit. ``observe`` takes scalars or arrays.
    """

    __slots__ = ("bounds", "counts", "total", "count")
    kind = "histogram"

    def __init__(self, bounds) -> None:
        self.bounds = np.asarray(sorted(bounds), dtype=np.float64)
        self.counts = np.zeros(len(self.bounds) + 1, dtype=np.int64)
        self.total = 0.0
        self.count = 0

    def observe(self, values) -> None:
        x = np.atleast_1d(np.asarray(values, dtype=np.float64)).ravel()
        if x.size == 0:
            return
        idx = np.searchsorted(self.bounds, x, side="left")
        self.counts += np.bincount(idx, minlength=self.counts.size)
        self.total += float(x.sum())
        self.count += int(x.size)

    def snapshot(self):
        return {
            "bounds": self.bounds.tolist(),
            "counts": self.counts.tolist(),
            "sum": self.total,
            "count": self.count,
        }


class MetricsRegistry:
    """Create-or-get named metrics; snapshot to JSON / Prometheus text."""

    def __init__(self) -> None:
        self._metrics: dict[str, Any] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(*args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds=(1, 2, 4, 8, 16, 32, 64)) -> Histogram:
        return self._get(name, Histogram, bounds)

    def snapshot(self) -> dict:
        return {name: m.snapshot() for name, m in self._metrics.items()}

    # -- sinks -------------------------------------------------------------

    def write_jsonl(self, path: str, extra: dict | None = None) -> None:
        """Append one JSON line with every metric's snapshot."""
        row = dict(extra or {})
        row.update(self.snapshot())
        write_jsonl(path, row)

    def write_prom(self, path: str, *, prefix: str = "repro") -> None:
        """Write a Prometheus textfile-collector snapshot (overwrites)."""
        lines: list[str] = []
        for name, m in sorted(self._metrics.items()):
            full = f"{prefix}_{name}".replace(".", "_").replace("-", "_")
            lines.append(f"# TYPE {full} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for bound, c in zip(m.bounds, m.counts):
                    cum += int(c)
                    lines.append(f'{full}_bucket{{le="{bound:g}"}} {cum}')
                lines.append(f'{full}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{full}_sum {m.total:g}")
                lines.append(f"{full}_count {m.count}")
            else:
                lines.append(f"{full} {m.snapshot():g}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def write_jsonl(path: str, row: dict) -> None:
    """Append one JSON object as a line to ``path``."""
    with open(path, "a") as f:
        f.write(json.dumps(row, default=_json_default) + "\n")


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


# ----------------------------------------------------------------- ledger

_WIRE_FORMATS = ("dense", "quantized", "sparse")


class CommLedger:
    """Per-rule communication ledger fed from fetched round metrics.

    Construct with :meth:`for_strategy` (reads the strategy's
    ``wire_format``) or directly. Feed per-round host metric dicts via
    :meth:`observe_round` — or a whole stacked run (leading steps axis,
    as returned by ``CADAEngine.run``) via :meth:`observe_run`. Bytes are
    taken from the metrics' ``bytes_up`` entry (itself
    ``uploads * strategy.bytes_per_upload(n)``), summed in round order,
    so totals stay bit-equal to the engine's accounting.
    """

    def __init__(self, rule: str = "", wire_format: str = "dense") -> None:
        if wire_format not in _WIRE_FORMATS:
            raise ValueError(f"wire_format must be one of {_WIRE_FORMATS}, "
                             f"got {wire_format!r}")
        self.rule = rule
        self.wire_format = wire_format
        self.rounds = 0
        self.uploads = 0
        self.grad_evals = 0
        self.bytes_up = 0.0
        self.bytes_down = 0.0
        self._stale_counts = np.zeros(1, dtype=np.int64)
        self._margins: list[np.ndarray] = []
        self.ring_occupancy: int | None = None
        self.ring_capacity: int | None = None
        self.pool_nbytes: int | None = None
        self.pool_resident_nbytes: int | None = None
        self.pool_mapped_nbytes: int | None = None
        self.async_pending_max: int | None = None

    @classmethod
    def for_strategy(cls, strategy) -> "CommLedger":
        return cls(rule=strategy.kind, wire_format=strategy.wire_format)

    # -- feeding -----------------------------------------------------------

    def observe_round(self, met: dict, participation=None) -> None:
        """Fold one round's (host-fetched) metric dict into the ledger."""
        self.rounds += 1
        self.uploads += int(met["uploads"])
        self.bytes_up += float(met["bytes_up"])
        if "grad_evals" in met:
            self.grad_evals += int(met["grad_evals"])
        if "staleness" in met:
            self.observe_staleness(met["staleness"])
        if "lhs" in met and "rhs" in met:
            self.observe_margin(met["lhs"], met["rhs"], mask=participation)

    def observe_run(self, mets: dict, participation=None) -> None:
        """Fold a stacked run (leading steps axis on every entry)."""
        host = {k: np.asarray(v) for k, v in mets.items()}
        part = None if participation is None else np.asarray(participation)
        steps = int(host["uploads"].shape[0])
        for i in range(steps):
            row = {k: v[i] for k, v in host.items()}
            p = None if part is None else part[i]
            self.observe_round(row, participation=p)

    def observe_margin(self, lhs, rhs, mask=None) -> None:
        """Record finite LHS−RHS gate margins (>0 ⇒ the gate said upload)."""
        lhs = np.atleast_1d(np.asarray(lhs, dtype=np.float64)).ravel()
        rhs = float(np.asarray(rhs).ravel()[0]) if np.ndim(rhs) else float(rhs)
        margin = lhs - rhs
        keep = np.isfinite(margin)
        if mask is not None:
            keep &= np.atleast_1d(np.asarray(mask, dtype=bool)).ravel()
        if keep.any():
            self._margins.append(margin[keep])

    def observe_staleness(self, values) -> None:
        x = np.atleast_1d(np.asarray(values, dtype=np.int64)).ravel()
        if x.size == 0:
            return
        hi = int(x.max()) + 1
        if hi > self._stale_counts.size:
            grown = np.zeros(hi, dtype=np.int64)
            grown[: self._stale_counts.size] = self._stale_counts
            self._stale_counts = grown
        self._stale_counts += np.bincount(
            np.clip(x, 0, None), minlength=self._stale_counts.size)

    def observe_ring(self, slot, capacity: int | None = None) -> None:
        """Record stale-ring occupancy from the (M,) slot-assignment map."""
        slot = np.asarray(slot).ravel()
        self.ring_occupancy = int(np.unique(slot).size)
        if capacity is not None:
            self.ring_capacity = int(capacity)

    def observe_pool(self, pool) -> None:
        """Record WorkerPool residency gauges (nbytes/resident/mapped)."""
        self.pool_nbytes = int(pool.nbytes)
        self.pool_resident_nbytes = int(pool.resident_nbytes)
        self.pool_mapped_nbytes = int(pool.mapped_nbytes)

    def observe_pending(self, depth: int) -> None:
        """Track the max async pending-writeback depth seen."""
        d = int(depth)
        if self.async_pending_max is None or d > self.async_pending_max:
            self.async_pending_max = d

    def add_bytes_down(self, nbytes: float) -> None:
        self.bytes_down += float(nbytes)

    # -- reading -----------------------------------------------------------

    @property
    def staleness_hist(self) -> dict[int, int]:
        return {int(k): int(c) for k, c in enumerate(self._stale_counts) if c}

    def margin_quantiles(self, qs=(0.1, 0.5, 0.9)) -> dict[str, float] | None:
        if not self._margins:
            return None
        m = np.concatenate(self._margins)
        return {f"q{int(q * 100)}": float(np.quantile(m, q)) for q in qs}

    def summary(self) -> dict:
        """JSON-ready ledger summary; bytes split lands in the bucket
        matching this rule's wire format, other buckets stay 0."""
        split = {f"mbytes_up_{wf}": 0.0 for wf in _WIRE_FORMATS}
        split[f"mbytes_up_{self.wire_format}"] = self.bytes_up / 1e6
        out = {
            "rule": self.rule,
            "wire_format": self.wire_format,
            "rounds": self.rounds,
            "uploads": self.uploads,
            "bytes_up": self.bytes_up,
            "mbytes_up": self.bytes_up / 1e6,
            **split,
            "staleness_hist": {str(k): v for k, v in self.staleness_hist.items()},
        }
        if self.grad_evals:
            out["grad_evals"] = self.grad_evals
        if self.bytes_down:
            out["mbytes_down"] = self.bytes_down / 1e6
        mq = self.margin_quantiles()
        if mq is not None:
            out["gate_margin"] = mq
        if self.ring_occupancy is not None:
            out["ring_occupancy"] = self.ring_occupancy
            if self.ring_capacity is not None:
                out["ring_capacity"] = self.ring_capacity
        if self.pool_nbytes is not None:
            out["pool_nbytes"] = self.pool_nbytes
            out["pool_resident_nbytes"] = self.pool_resident_nbytes
            out["pool_mapped_nbytes"] = self.pool_mapped_nbytes
        if self.async_pending_max is not None:
            out["async_pending_max"] = self.async_pending_max
        return out
