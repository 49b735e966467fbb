"""Telemetry: tracing, metrics and timeline export (a copy of the JAX
package's ``obs``, which imports no JAX; this one imports no torch).

- :mod:`repro_torch.obs.trace`   — span/event recorder (``Tracer``) with a
  strict no-op fast path (``NULL``) when tracing is disabled.
- :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry plus the
  per-rule communication ledger (``CommLedger``) with JSONL and
  Prometheus-textfile sinks.
- :mod:`repro_torch.obs.export`  — Chrome-trace/Perfetto JSON export and a
  dependency-free schema validator
  (``python -m repro_torch.obs.export --validate FILE``).

The cohort driver (``core.flat.run_cohort_rounds``) records its per-round
gather/patch/step/scatter spans on the ``"pipeline"`` track; those spans
time the host, not the device.
"""

from .trace import NULL, NullTracer, Tracer, as_tracer
from .metrics import CommLedger, MetricsRegistry, write_jsonl
from .export import to_chrome_trace, validate_chrome_trace, write_chrome_trace

__all__ = [
    "NULL",
    "NullTracer",
    "Tracer",
    "as_tracer",
    "CommLedger",
    "MetricsRegistry",
    "write_jsonl",
    "to_chrome_trace",
    "validate_chrome_trace",
    "write_chrome_trace",
]
