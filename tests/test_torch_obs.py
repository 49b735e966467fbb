"""The port's telemetry (``repro_torch.obs``, a copy of ``repro.obs``),
mirroring the JAX package's ``tests/test_obs.py`` without its sim parts
(the sim runtime is not ported yet).

  * the no-op fast path: ``NULL`` is falsy and allocation-free, every
    method a no-op;
  * the tracer, the Chrome-trace export and its validator (and the
    ``python -m repro_torch.obs.export`` CLI), the registry sinks; the
    port's exports equal the reference's for the same events;
  * ledger parity: for every rule kind, the sparse top-k wire and both
    delta-payload rules, :class:`CommLedger` totals equal the sum of the
    port's own round ``bytes_up`` (the same fp32 values in the same
    order);
  * the cohort driver's ``"pipeline"`` spans for both values of
    ``pipeline``, and ``metrics_out`` keeping every completed round when
    the run raises.
"""
import json

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro_torch.core.comm import strategy_for
from repro_torch.core.engine import CADAEngine, sample_cohorts
from repro_torch.core.flat import cohort_overlap_schedule
from repro_torch.core.rules import CommRule
from repro_torch.models.small import logreg_loss
from repro_torch.obs import (NULL, CommLedger, MetricsRegistry, NullTracer,
                             Tracer, as_tracer, to_chrome_trace,
                             validate_chrome_trace, write_chrome_trace)
from repro_torch.optim.fused import FusedAMSGrad

from test_torch_cohort_pipeline import (ARMS, C, M, STEPS, _problem,
                                        cohort_batches, cohort_run)

torch.set_num_threads(1)


def test_null_tracer_is_falsy_noop():
    """``if tracer:`` guards must skip work; every NULL method no-ops and
    the span context manager is one reusable object (no allocation)."""
    assert not NULL
    assert NULL.enabled is False
    assert isinstance(NULL, NullTracer)
    s1 = NULL.span("a", track="t", args={"k": 1})
    s2 = NULL.span("b")
    assert s1 is s2                       # reusable singleton, no alloc
    with s1:
        pass
    NULL.add_span("x", 0.0, 1.0, track="t")
    NULL.instant("x", 0.5)
    NULL.counter("x", 0.5, 3.0)
    assert NULL.aggregate() == {}
    assert NULL.aggregate("t") == {}


def test_as_tracer_normalizes():
    assert as_tracer(None) is NULL
    tr = Tracer()
    assert as_tracer(tr) is tr
    assert bool(tr) and tr.enabled


def test_null_span_swallows_nothing():
    """The null span must not suppress exceptions."""
    with pytest.raises(RuntimeError):
        with NULL.span("boom"):
            raise RuntimeError


# ------------------------------------------------------ tracer recording

def test_tracer_records_spans_instants_counters():
    tr = Tracer()
    with tr.span("work", track="main", cat="compute", args={"i": 0}):
        pass
    tr.add_span("transfer", 1.0, 0.25, track="worker 0", cat="transfer")
    tr.instant("gate", 1.25, track="worker 0", args={"upload": True})
    tr.counter("pool_bytes", 2.0, 123.0)
    assert len(tr) == 4
    assert tr.tracks == ["main", "worker 0", "counters"]  # insertion order
    phs = [e[0] for e in tr.events]
    assert phs == ["X", "X", "i", "C"]
    (ph, name, track, cat, t0, dur, args) = tr.events[1]
    assert (name, track, cat, t0, dur) == ("transfer", "worker 0",
                                           "transfer", 1.0, 0.25)
    spans = tr.spans("worker 0")
    assert [s[1] for s in spans] == ["transfer"]


def test_tracer_aggregate_per_track():
    """aggregate() is the one home for phase timing — count/total/max per
    span name, restricted to a track (what the bench reads)."""
    tr = Tracer()
    for dur in (0.1, 0.3, 0.2):
        tr.add_span("step", 0.0, dur, track="pipeline")
    tr.add_span("step", 0.0, 9.0, track="other")
    agg = tr.aggregate("pipeline")
    assert agg["step"]["count"] == 3
    np.testing.assert_allclose(agg["step"]["total_s"], 0.6)
    np.testing.assert_allclose(agg["step"]["max_s"], 0.3)
    assert tr.aggregate()["step"]["count"] == 4


# -------------------------------------------------- chrome-trace export

def test_chrome_trace_export_shape():
    tr = Tracer()
    tr.add_span("compute", 0.5, 1.5, track="worker 0", cat="compute",
                args={"round": 0})
    tr.instant("gate", 2.0, track="worker 0")
    tr.counter("depth", 2.5, 4.0)
    obj = to_chrome_trace(tr, meta={"rule": "cada2"})
    assert obj["otherData"] == {"rule": "cada2"}
    evs = obj["traceEvents"]
    # process name + 2 metadata records per track (name + sort index)
    metas = [e for e in evs if e["ph"] == "M"]
    assert {m["name"] for m in metas} == {"process_name", "thread_name",
                                          "thread_sort_index"}
    x = next(e for e in evs if e["ph"] == "X")
    assert x["ts"] == 0.5e6 and x["dur"] == 1.5e6     # seconds -> µs
    assert x["cat"] == "compute" and x["args"] == {"round": 0}
    inst = next(e for e in evs if e["ph"] == "i")
    assert inst["s"] == "t"
    assert validate_chrome_trace(obj) == len(evs)


def test_chrome_trace_validator_rejects_garbage():
    with pytest.raises(ValueError):
        validate_chrome_trace({"notTraceEvents": []})
    with pytest.raises(ValueError):
        validate_chrome_trace({"traceEvents": [{"ph": "X"}]})  # no name/ts
    with pytest.raises(ValueError):
        validate_chrome_trace(
            {"traceEvents": [{"ph": "?", "name": "a", "ts": 0.0,
                              "pid": 1, "tid": 1}]})


def test_export_cli_roundtrip(tmp_path):
    from repro_torch.obs.export import main
    tr = Tracer()
    tr.add_span("round", 0.0, 1.0, track="server")
    path = tmp_path / "trace.json"
    write_chrome_trace(tr, str(path), meta={"runtime": "sim"})
    assert main(["--validate", str(path)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    assert main(["--validate", str(bad)]) != 0


# -------------------------------------------------------- registry sinks

def test_metrics_registry_sinks(tmp_path):
    reg = MetricsRegistry()
    reg.counter("uploads").inc(3)
    reg.gauge("pool.resident-bytes").set(512)
    reg.histogram("staleness", bounds=(1, 2, 4)).observe([0, 1, 3, 9])
    with pytest.raises(TypeError):
        reg.gauge("uploads")              # kind mismatch
    jl = tmp_path / "metrics.jsonl"
    reg.write_jsonl(str(jl), extra={"step": 7})
    reg.write_jsonl(str(jl), extra={"step": 8})
    rows = [json.loads(l) for l in jl.read_text().splitlines()]
    assert [r["step"] for r in rows] == [7, 8]
    assert rows[0]["uploads"] == 3.0
    assert rows[0]["staleness"]["count"] == 4
    prom = tmp_path / "metrics.prom"
    reg.write_prom(str(prom))
    text = prom.read_text()
    assert "repro_uploads 3" in text
    assert "repro_pool_resident_bytes 512" in text
    assert 'repro_staleness_bucket{le="+Inf"} 4' in text
    assert "repro_staleness_count 4" in text


# --------------------------------------------------------- ledger parity

@pytest.mark.parametrize("kind", ARMS)
def test_ledger_parity_all_rules(kind):
    """Acceptance gate: for every grad rule and both delta rules, the
    ledger's uploads/bytes totals are BIT-EQUAL to summing the engine's
    own round metrics (which are property-pinned ``bytes_per_upload``
    numbers) — the ledger introduces no second accounting."""
    cohorts = sample_cohorts(M, C, STEPS, seed=3)
    st, pool, mets, eng = cohort_run(kind, cohorts, pipeline=True)

    led = CommLedger.for_strategy(eng.strategy)
    for met in mets:
        led.observe_round(met)

    exp_uploads, exp_bytes = 0, 0.0
    for met in mets:
        exp_uploads += int(np.asarray(met["uploads"]))
        exp_bytes += float(np.asarray(met["bytes_up"]))
    assert led.rounds == STEPS
    assert led.uploads == exp_uploads
    assert led.bytes_up == exp_bytes      # bit-equal: same values, same order
    # and the metrics themselves are uploads × the pinned per-upload bytes
    # (priced on the UNPADDED flat length — padding never hits the wire)
    spb = eng.strategy.bytes_per_upload(eng._layout.n)
    assert led.bytes_up == exp_uploads * spb
    # wire-format split: everything lands in this rule's bucket
    s = led.summary()
    wf = eng.strategy.wire_format
    assert s["wire_format"] == wf
    np.testing.assert_allclose(s[f"mbytes_up_{wf}"], led.bytes_up / 1e6)
    for other in {"dense", "quantized", "sparse"} - {wf}:
        assert s[f"mbytes_up_{other}"] == 0.0
    assert sum(s["staleness_hist"].values()) == STEPS * C
    # the pool's residency gauges, read from the port's WorkerPool
    led.observe_pool(pool)
    s = led.summary()
    assert s["pool_nbytes"] == pool.nbytes > 0
    assert s["pool_resident_nbytes"] == pool.resident_nbytes
    assert s["pool_mapped_nbytes"] == 0


def test_wire_format_property():
    as_strat = strategy_for(CommRule(kind="always", c=0.6, d_max=4,
                                     max_delay=10))
    assert as_strat.wire_format == "dense"
    laq = strategy_for(CommRule(kind="laq", c=0.6, d_max=4, max_delay=10))
    assert laq.wire_format == "quantized"
    topk = strategy_for(CommRule(kind="topk", c=0.6, d_max=4, max_delay=10,
                                 topk_frac=0.5, sparse_wire=True))
    assert topk.wire_format == "sparse"


def test_ledger_margin_and_staleness():
    led = CommLedger(rule="cada2")
    led.observe_margin([1.0, -2.0, np.inf, np.nan], 0.5)
    q = led.margin_quantiles()
    assert q["q50"] == pytest.approx((0.5 + (-2.5)) / 2)   # finite only
    led.observe_staleness([0, 0, 3])
    assert led.staleness_hist == {0: 2, 3: 1}
    led.observe_ring(np.array([0, 1, 1, 2]), capacity=5)
    assert led.ring_occupancy == 3 and led.ring_capacity == 5
    led.observe_pending(2)
    led.observe_pending(1)
    assert led.async_pending_max == 2
    with pytest.raises(ValueError):
        CommLedger(wire_format="carrier-pigeon")


def test_export_equals_reference():
    """The copy exports the reference's JSON for the same events."""
    trs = []
    for mod in (jax_obs, None):
        tr = (mod.Tracer() if mod else Tracer())
        tr.add_span("compute", 0.5, 1.5, track="worker 0", cat="compute",
                    args={"round": 0})
        tr.instant("gate", 2.0, track="worker 0")
        tr.counter("depth", 2.5, 4.0)
        trs.append(tr)
    assert (jax_obs.to_chrome_trace(trs[0], meta={"m": 1})
            == to_chrome_trace(trs[1], meta={"m": 1}))


# ------------------------------------------------- cohort pipeline spans

@pytest.mark.parametrize("pipeline", (False, True))
def test_run_cohort_rounds_pipeline_spans(pipeline):
    """Each cohort round records one gather, step and scatter span (and a
    patch span in each pipelined round that forwards rows) on the
    "pipeline" track; the trace exports valid."""
    cohorts = sample_cohorts(M, C, STEPS, seed=4)
    params, (bx, by) = _problem(STEPS)
    eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                     CommRule(kind="cada2", c=5.0, d_max=4, max_delay=6), M,
                     device="cpu")
    st, pool = eng.init_cohort({k: torch.from_numpy(v)
                                for k, v in params.items()})
    tr = Tracer()
    st, mets = eng.run_cohort(st, pool,
                              cohort_batches("cada2", cohorts, bx, by),
                              cohorts, pipeline=pipeline, trace=tr)
    agg = tr.aggregate("pipeline")
    for phase in ("gather", "step", "scatter"):
        assert agg[phase]["count"] == STEPS, (phase, agg)
        assert agg[phase]["total_s"] >= 0.0
    n_overlap = int((cohort_overlap_schedule(cohorts) >= 0)
                    .any(axis=1).sum())
    assert agg.get("patch", {}).get("count", 0) == (n_overlap if pipeline
                                                    else 0)
    validate_chrome_trace(to_chrome_trace(tr))


def test_metrics_out_survives_error():
    """An exception mid-run loses no fetched metrics: ``metrics_out``
    holds every completed round (the drivers fetch in a finally), equal
    to the serial oracle's."""
    j = 9
    cohorts = sample_cohorts(M, C, STEPS, seed=5)
    _, (bx, by) = _problem(STEPS)
    batches = cohort_batches("cada2", cohorts, bx, by)
    _, _, mets_s, _ = cohort_run("cada2", cohorts, pipeline=False)

    class Boom(RuntimeError):
        pass

    def exploding(i, cohort):
        if i == j:
            raise Boom
        return batches[i]

    for pipeline in (False, True):
        out: list = []
        params, _ = _problem(1)
        eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                         CommRule(kind="cada2", c=5.0, d_max=4,
                                  max_delay=6), M, device="cpu")
        st, pool = eng.init_cohort({k: torch.from_numpy(v)
                                    for k, v in params.items()})
        with pytest.raises(Boom):
            eng.run_cohort(st, pool, exploding, cohorts, pipeline=pipeline,
                           metrics_every=4, metrics_out=out)
        assert len(out) == j, (pipeline, len(out))
        for i, met in enumerate(out):
            for key in met:
                np.testing.assert_array_equal(
                    met[key], mets_s[i][key],
                    err_msg=f"pipeline={pipeline}: metrics_out[{i}][{key}]")
