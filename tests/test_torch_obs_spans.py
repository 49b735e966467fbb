"""The program's own spans (``repro_torch.obs`` tracks ``train``, ``cada``,
``sched``, ``prefill``): a trainer step, a scheduler round and a prefill
traced give the same bits as untraced, record the documented spans with
the documented counts, nested in their parents, and the scheduler's two
counters give the benchmark's padding share (``bench/metrics/
pad_share.serve.py``); the disabled path reads no clock.
"""
import json
import types

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from bench.cell import Record, reader
from repro_torch.core.rules import CommRule
from repro_torch.distributed.scheduler import DecodeScheduler, Request
from repro_torch.distributed.trainer import (TrainHParams, init_train_state,
                                             make_train_step, worker_split)
from repro_torch.launch import train as train_cli
from repro_torch.models.model import init_params, prefill
from repro_torch.obs import Tracer, to_chrome_trace, validate_chrome_trace
from repro_torch.obs import trace as trace_mod

torch.set_num_threads(1)

CFG = TC.get_smoke_config("stablelm-1.6b")
M = 2
STEPS = 2
# spans a step records, by name, on the flat plane
CADA2_STEP = {"train.step": 1, "train.grads": 2, "cada.pack": 3,
              "cada.points": 1, "cada.lhs": 1, "cada.wire": 2, "cada.eq3": 1,
              "cada.server": 1}
ALWAYS_STEP = {"train.step": 1, "train.grads": 1, "cada.pack": 2,
               "cada.eq3": 1, "cada.server": 1}
PYTREE_STEP = {"train.step": 1}
CASES = {"cada2": ("cada2", True, CADA2_STEP),
         "always": ("always", True, ALWAYS_STEP),
         "cada2-pytree": ("cada2", False, PYTREE_STEP)}


def _steps(kind, fused, trace):
    hp = TrainHParams(rule=CommRule(kind=kind, c=1.0, d_max=4, max_delay=10),
                      lr=1e-3, fused=fused)
    step = make_train_step(CFG, hp, M)
    st = init_train_state(CFG, hp, M, 7, "cpu")
    rng = np.random.default_rng(3)
    mets = []
    for _ in range(STEPS):
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, CFG.vocab, (4, 17))).long()}
        st, met = step(st, worker_split(batch, M), trace=trace)
        mets.append(met)
    return st, mets


def _equal_trees(a, b):
    """Every tensor of two nests of tuples, lists and dicts bit-equal."""
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert a == b


def _counts(tr, track=None):
    return {k: v["count"] for k, v in tr.aggregate(track).items()}


def _inside(child, parent):
    return (parent[4] <= child[4]
            and child[4] + child[5] <= parent[4] + parent[5])


@pytest.mark.parametrize("case", CASES)
def test_a_traced_step_is_the_untraced_step(case):
    kind, fused, _ = CASES[case]
    tr = Tracer()
    st_t, met_t = _steps(kind, fused, tr)
    st_u, met_u = _steps(kind, fused, None)
    _equal_trees(st_t, st_u)
    _equal_trees(met_t, met_u)
    assert len(tr) > 0


@pytest.mark.parametrize("case", CASES)
def test_a_step_records_its_spans(case):
    kind, fused, per_step = CASES[case]
    tr = Tracer()
    _steps(kind, fused, tr)
    assert _counts(tr) == {k: v * STEPS for k, v in per_step.items()}
    steps = tr.spans("train")
    outer = [e for e in steps if e[1] == "train.step"]
    assert [e[6] for e in outer] == [{"step": k} for k in range(STEPS)]
    for e in tr.spans():
        if e[1] != "train.step":
            assert sum(_inside(e, o) for o in outer) == 1, e
    assert set(tr.tracks) <= {"train", "cada"}
    validate_chrome_trace(json.loads(json.dumps(to_chrome_trace(tr))))


def test_the_disabled_path_reads_no_clock(monkeypatch):
    """With ``trace=None`` a step, a round and a prefill never reach the
    tracer's clock."""
    def no_clock():
        raise AssertionError("the disabled path read the clock")
    monkeypatch.setattr(trace_mod, "time",
                        types.SimpleNamespace(perf_counter=no_clock))
    _steps("cada2", True, None)
    cfg, params = _serving("internlm2-1.8b")
    sched = DecodeScheduler(cfg, params, n_slots=2, max_seq=24)
    for r in _requests(cfg, [5, 9, 3]):
        sched.submit(r)
    sched.run()


# ----------------------------------------------------------- serving

def _serving(arch):
    cfg = TC.get_smoke_config(arch)
    return cfg, init_params(cfg, 0, "cpu")


def _requests(cfg, lengths, max_new=1, uid0=0):
    rng = np.random.default_rng(11)
    return [Request(uid=uid0 + i, prompt=rng.integers(
        0, cfg.vocab, n, dtype=np.int32), max_new=max_new)
        for i, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b"])
def test_a_traced_prefill_is_the_untraced_prefill(arch):
    cfg, params = _serving(arch)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12))).long()
    tr = Tracer()
    got = prefill(cfg, params, toks, max_seq=20, trace=tr)
    want = prefill(cfg, params, toks, max_seq=20)
    _equal_trees(got, want)
    n_attn = (cfg.n_layers if cfg.block in ("dense", "moe")
              else cfg.n_layers // cfg.attn_every)
    want_counts = {"prefill.embed": 2, "prefill.cache": 2,
                   "prefill.attn": n_attn, "prefill.mlp": n_attn,
                   "prefill.head": 1}
    if cfg.block in ("mamba1", "mamba2"):
        want_counts["prefill.ssm"] = cfg.n_layers
    assert _counts(tr) == want_counts
    assert tr.tracks == ["prefill"]


@pytest.mark.parametrize("max_new", [1, 4])
def test_a_traced_round_is_the_untraced_round(max_new):
    cfg, params = _serving("internlm2-1.8b")
    outs = []
    for trace in (Tracer(), None):
        sched = DecodeScheduler(cfg, params, n_slots=3, max_seq=24)
        for r in _requests(cfg, [7, 12, 4, 9, 5], max_new=max_new):
            sched.submit(r)
        while sched.queue:
            sched.run_round(trace=trace)
        outs.append([(r.uid, r.out, r.done) for r in sched.finished])
    assert outs[0] == outs[1]
    assert all(len(out) == max_new for _, out, _ in outs[0])


def test_a_round_records_its_spans_once_and_a_layer_each():
    cfg, params = _serving("internlm2-1.8b")
    sched = DecodeScheduler(cfg, params, n_slots=3, max_seq=24)
    lengths = [7, 12, 4, 9, 5]
    for r in _requests(cfg, lengths):
        sched.submit(r)
    tr = Tracer()
    assert sched.run_round(trace=tr)
    assert sched.run_round(trace=tr)
    assert sched.run_round(trace=tr) == []          # an empty queue
    rounds = 2
    assert _counts(tr) == {
        "sched.round": rounds, "sched.batch": rounds,
        "sched.prefill": rounds, "sched.first_token": rounds,
        "prefill.embed": 2 * rounds, "prefill.cache": 2 * rounds,
        "prefill.attn": cfg.n_layers * rounds,
        "prefill.mlp": cfg.n_layers * rounds, "prefill.head": rounds}
    outer = [e for e in tr.spans("sched") if e[1] == "sched.round"]
    assert [e[6] for e in outer] == [
        {"uids": [0, 1, 2], "slots": 3, "padded": 12},
        {"uids": [3, 4], "slots": 3, "padded": 9}]
    prefills = [e for e in tr.spans("sched") if e[1] == "sched.prefill"]
    for e in tr.spans("prefill"):
        assert sum(_inside(e, p) for p in prefills) == 1, e
    for e in tr.spans("sched"):
        if e[1] != "sched.round":
            assert sum(_inside(e, o) for o in outer) == 1, e


def test_the_counters_give_the_padding_share():
    """``sched.prompt_tokens`` and ``sched.padded_tokens`` summed over the
    rounds give what ``pad_share.serve`` reads from the harness's round
    records (rounds of mixed lengths, one short of the slots)."""
    cfg, params = _serving("internlm2-1.8b")
    lengths = [7, 12, 4, 9, 5, 16, 2, 11]
    sched = DecodeScheduler(cfg, params, n_slots=3, max_seq=24)
    for r in _requests(cfg, lengths):
        sched.submit(r)
    tr, rec = Tracer(), Record(kind="serve", model={}, traffic={}, peak={})
    while sched.queue:
        reqs = sched.run_round(trace=tr)
        rec.rounds.append((sched.n_slots, max(len(r.prompt) for r in reqs),
                           [len(r.prompt) for r in reqs]))
    sums = {}
    for e in tr.events:
        if e[0] == "C":
            assert e[2] == "sched"
            sums[e[1]] = sums.get(e[1], 0.0) + e[6][e[1]]
    assert sums["sched.prompt_tokens"] == sum(lengths)
    filled, useful = sums["sched.padded_tokens"], sums["sched.prompt_tokens"]
    assert (100.0 * (filled - useful) / filled
            == reader("pad_share.serve")(rec))


def test_the_cli_traces_the_step_phases(tmp_path):
    """The one-process CLI's ``--trace`` holds the step's own spans, each
    step under its one ``train.step`` span; the launcher opens no span of
    its own around it."""
    out = tmp_path / "trace.json"
    train_cli.main(["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
                    "--workers", "2", "--steps", "2", "--global-batch", "4",
                    "--seq", "16", "--rule", "cada2", "--trace", str(out)])
    trace = json.loads(out.read_text())
    validate_chrome_trace(trace)
    names = [e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"]
    for name, n in CADA2_STEP.items():
        assert names.count(name) == n * 2, name
    assert names.count("train_step") == 0
    steps = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == [0, 1]


# ------------------------------------------------- a per-layer pattern

def _pattern_counts(cfg, rounds=1):
    """Spans a prefill of a pattern records: each Mamba2 mixer in
    ``prefill.ssm``, each attention mixer in ``prefill.attn``, every MLP in
    ``prefill.mlp`` (granite-4.0-h-micro: 36, 4 and 40); the embedding's
    lookup alone (no rotary tables), the cache twice, the head once."""
    n_attn = cfg.layer_types.count("attention")
    return {"prefill.embed": rounds, "prefill.cache": 2 * rounds,
            "prefill.ssm": (cfg.n_layers - n_attn) * rounds,
            "prefill.attn": n_attn * rounds,
            "prefill.mlp": cfg.n_layers * rounds, "prefill.head": rounds}


def test_the_published_pattern_scales_to_36_4_40():
    full = TC.get_config("granite-4.0-h-micro")
    counts = _pattern_counts(full)
    assert (counts["prefill.ssm"], counts["prefill.attn"],
            counts["prefill.mlp"]) == (36, 4, 40)


def test_a_traced_pattern_prefill_is_the_untraced_one():
    cfg, params = _serving("granite-4.0-h-micro")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12))).long()
    tr = Tracer()
    got = prefill(cfg, params, toks, max_seq=20, trace=tr)
    want = prefill(cfg, params, toks, max_seq=20)
    _equal_trees(got, want)
    assert _counts(tr) == _pattern_counts(cfg)
    assert tr.tracks == ["prefill"]


@pytest.mark.parametrize("arch", ["granite-4.0-h-micro", "internlm2-1.8b",
                                  "zamba2-2.7b"])
def test_the_cache_counters_are_the_caches_bytes(arch):
    """``sched.kv_bytes`` and ``sched.state_bytes``, once a round, are the
    bytes of ``init_cache``'s K/V and of its conv tails and SSM states at
    the scheduler's slots and ``max_seq``."""
    from repro_torch.models.model import init_cache
    cfg, params = _serving(arch)
    sched = DecodeScheduler(cfg, params, n_slots=3, max_seq=24)
    for r in _requests(cfg, [7, 12, 4, 9]):
        sched.submit(r)
    tr = Tracer()
    while sched.queue:
        sched.run_round(trace=tr)
    cache = init_cache(cfg, 3, 24, device="cpu")
    want = {"sched.kv_bytes": sum(t.nbytes for t in (cache.k, cache.v)
                                  if t is not None),
            "sched.state_bytes": sum(t.nbytes for t in (cache.conv,
                                                        cache.ssm)
                                     if t is not None)}
    got: dict = {}
    for e in tr.events:
        if e[0] == "C" and e[1] in want:
            assert e[2] == "sched"
            got.setdefault(e[1], []).append(e[6][e[1]])
    assert got == {k: [float(v)] * 2 for k, v in want.items()}
    if arch == "granite-4.0-h-micro":
        assert cache.k.shape[0] == 1 and cache.ssm.shape[0] == 1
        assert cache.conv.shape[-1] == cfg.d_inner + 2 * cfg.ssm_state
        assert cache.ssm.dtype == torch.float32 and want["sched.kv_bytes"]
    if arch == "internlm2-1.8b":
        assert want["sched.state_bytes"] == 0
    counts = _counts(tr, "prefill")
    if arch == "granite-4.0-h-micro":
        assert counts == _pattern_counts(cfg, rounds=2)
