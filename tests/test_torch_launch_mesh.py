"""The port's training launcher on ``--runtime mesh`` against the JAX
package's CLI (``repro.launch.train``), on the CPU.

Both launchers train stablelm-1.6b's smoke config with avp at
``--period-min 2 --period-max 8``, M = 2, 6 steps of the reference's token
stream, saving ``state.params`` every 2 steps and at the end under
``--ckpt-dir`` with ``history.json``, and writing ``--trace``,
``--metrics-out`` and ``--metrics-prom``. The port's launcher starts from
the reference's initial state (its ``init_train_state`` is swapped for the
reference's, converted), so both runs take the same trajectory.

Contract: the same checkpoint directories, manifests (paths, shapes,
dtypes, step) and history rows (steps, keys, uploads and skip rate
exact); parameters and losses within TOL of their scale (the trainers'
lockstep band over 6 steps: ``tests/test_torch_trainer_lockstep.py``);
the ledger's totals (rounds, uploads, bytes up, gradient evaluations, the
staleness histogram) exact; the Prometheus file with the same metric
names; one span per step in a valid Chrome trace (the reference's
``train_step``, the port's own ``train.step``).
"""
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core.rules import CommRule as JaxRule
from repro.distributed import trainer as JT
from repro.launch import train as jtrain
from repro_torch import convert
from repro_torch.launch import train as ttrain
from repro_torch.obs import validate_chrome_trace

torch.set_num_threads(1)

TOL = 1e-5
STEPS = 6
ARGS = ["--arch", "stablelm-1.6b", "--smoke", "--workers", "2", "--steps",
        str(STEPS), "--global-batch", "4", "--seq", "16", "--rule", "avp",
        "--period-min", "2", "--period-max", "8", "--ckpt-every", "2",
        "--log-every", "1", "--metrics-every", "4", "--lr", "1e-3"]


def _outputs(d):
    return ["--ckpt-dir", str(d / "ckpt"), "--metrics-out",
            str(d / "metrics.jsonl"), "--metrics-prom", str(d / "m.prom"),
            "--trace", str(d / "trace.json")]


def _reference_init(cfg, hp, m, seed=0, device=None):
    """The reference launcher's initial state, converted to the port's."""
    jhp = JT.TrainHParams(rule=JaxRule(**dataclasses.asdict(hp.rule)),
                          lr=hp.lr, microbatches=hp.microbatches,
                          moments_dtype=hp.moments_dtype)
    jcfg = JC.get_smoke_config("stablelm-1.6b")
    assert cfg.name == jcfg.name
    state = JT.init_train_state(jcfg, jhp, m, jax.random.PRNGKey(0))
    return convert.train_state_from_numpy(jax.tree.map(np.asarray, state),
                                          device)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref, port = (tmp_path_factory.mktemp(n) for n in ("ref", "port"))
    argv = sys.argv
    sys.argv = ["train"] + ARGS + _outputs(ref)
    try:
        jtrain.main()
    finally:
        sys.argv = argv
    init = ttrain.init_train_state
    ttrain.init_train_state = _reference_init
    try:
        history = ttrain.main(ARGS + _outputs(port) + ["--device", "cpu"])
    finally:
        ttrain.init_train_state = init
    return ref, port, history


def _ckpt(d, step):
    path = d / "ckpt" / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    arrays = np.load(path / "arrays.npz")
    return manifest, [arrays[f"leaf_{i}"] for i in range(len(arrays.files))]


def test_checkpoints_match_the_reference(runs):
    ref, port, _ = runs
    dirs = sorted(p.name for p in (ref / "ckpt").iterdir() if p.is_dir())
    assert dirs == ["step_2", "step_4", f"step_{STEPS}"]
    assert sorted(p.name for p in (port / "ckpt").iterdir()
                  if p.is_dir()) == dirs
    for name in dirs:
        step = int(name.split("_")[1])
        (jm, ja), (tm, ta) = _ckpt(ref, step), _ckpt(port, step)
        assert tm == jm and tm["step"] == step
        for a, b in zip(ja, ta):
            scale = max(float(np.abs(a).max()), 1e-30)
            assert float(np.abs(b - a).max()) <= TOL * scale, name


def test_history_json_matches_the_reference(runs):
    ref, port, history = runs
    want = json.loads((ref / "ckpt" / "history.json").read_text())
    got = json.loads((port / "ckpt" / "history.json").read_text())
    assert got == json.loads(json.dumps(history))
    assert [r["step"] for r in got] == list(range(STEPS))
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w)
        assert (g["uploads"], g["skip_rate"]) == (w["uploads"],
                                                  w["skip_rate"])
        assert abs(g["loss"] - w["loss"]) <= TOL * abs(w["loss"])
    assert sum(r["skip_rate"] for r in got) > 0, "avp never skipped"


def test_the_ledger_totals_match_the_reference(runs):
    ref, port, _ = runs
    (want,) = [json.loads(x) for x in
               (ref / "metrics.jsonl").read_text().splitlines()]
    (got,) = [json.loads(x) for x in
              (port / "metrics.jsonl").read_text().splitlines()]
    assert sorted(got) == sorted(want)
    assert got["runtime"] == "mesh" and got["steps"] == STEPS
    for key in ("rounds", "uploads", "bytes_up", "grad_evals", "rule",
                "staleness_hist", "wire_format"):
        assert got[key] == want[key], key
    assert got["rounds"] == STEPS
    assert abs(got["final_loss"] - want["final_loss"]) <= TOL * abs(
        want["final_loss"])

    def names(path):
        return sorted(line.split()[0] for line in path.read_text()
                      .splitlines() if line and not line.startswith("#"))
    assert names(port / "m.prom") == names(ref / "m.prom")


def test_the_trace_has_a_span_per_step(runs):
    """The reference's launcher spans each step ``train_step``; the port's
    on one process hands the step its tracer, whose own ``train.step``
    spans it."""
    ref, port, _ = runs
    for d, name in ((ref, "train_step"), (port, "train.step")):
        trace = json.loads((d / "trace.json").read_text())
        validate_chrome_trace(trace)
        spans = [e for e in trace["traceEvents"]
                 if e.get("ph") == "X" and e.get("name") == name]
        assert [e["args"]["step"] for e in spans] == list(range(STEPS))


def test_avp_period_bounds_reach_the_rule(monkeypatch):
    """--period-min/--period-max land in the trainer's CommRule."""
    seen = {}
    make = ttrain.make_train_step

    def spy(cfg, hp, m, **kw):
        seen["rule"] = hp.rule
        return make(cfg, hp, m, **kw)

    monkeypatch.setattr(ttrain, "make_train_step", spy)
    ttrain.main(["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
                 "--rule", "avp", "--period-min", "3", "--period-max", "5",
                 "--steps", "1", "--global-batch", "2", "--seq", "8"])
    assert (seen["rule"].period_min, seen["rule"].period_max) == (3, 5)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_embedding_input_configs_are_refused_by_name(arch):
    with pytest.raises(SystemExit, match="repro_torch.launch.serve"):
        ttrain.main(["--arch", arch, "--smoke", "--device", "cpu"])
