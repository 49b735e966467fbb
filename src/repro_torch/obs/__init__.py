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

The program records host spans at its layers' boundaries when handed a
tracer (``trace=``; None records nothing), on these tracks:

- ``"train"``: ``train.step`` around a trainer step
  (``distributed.trainer.make_train_step``), ``train.grads`` around each
  evaluation of the workers' gradients;
- ``"cada"``: the CADA round on the flat planes (``core.flat``):
  ``cada.pack``, ``cada.points``, ``cada.lhs``, ``cada.wire``,
  ``cada.eq3`` and the server step ``cada.server``;
- ``"sched"``: ``sched.round`` around a ``DecodeScheduler`` round (its
  requests' uids in ``args``), ``sched.batch``, ``sched.prefill``,
  ``sched.first_token``, and the counters ``sched.prompt_tokens`` and
  ``sched.padded_tokens``;
- ``"prefill"``: ``prefill.embed``, ``prefill.cache``, ``prefill.attn``,
  ``prefill.mlp``, ``prefill.ssm`` and ``prefill.head`` inside
  ``models.model.prefill``;
- ``"pipeline"``: the cohort driver's (``core.flat.run_cohort_rounds``)
  gather/patch/step/scatter spans.

Spans time the host's dispatch, not the device: a device trace ties the
work to them by each operation's launch call (``bench/progtrace.py``).
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
