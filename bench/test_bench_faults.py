"""The comparison that decides ``correct``, shown to fail: the harness's
loops run on the CPU at a small size (the look for a card skipped),
with the timed path broken underneath, once for each fault a cell can
have, and the fp8 control put in the program's place. The cells' own
limits judge the training runs; the cell-size readings are in PERF.md."""
from __future__ import annotations

import time

import pytest
import torch

from bench import judge, reference, serve, train, weights
from bench.conftest import small_serve_cell, small_train_cell

PEAK = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}


def run_train(cell, seed=11):
    return train.run(cell, seed, 0.2, False, torch.device("cpu"),
                     time.perf_counter(), PEAK)


def run_serve(cell, seed=11):
    return serve.run(cell, seed, 0.2, False, torch.device("cpu"),
                     time.perf_counter(), PEAK)


def broken_step(monkeypatch, wrap):
    from repro_torch.distributed import trainer
    real = trainer.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)
        return lambda state, batch: wrap(step, state, batch)
    monkeypatch.setattr(trainer, "make_train_step", make)


@pytest.mark.parametrize("name", ["train.stablelm-1.6b-l4.s512"])
def test_a_sound_training_run_is_correct(name):
    rec = run_train(small_train_cell(name))
    assert rec.correct, rec.checks


@pytest.mark.parametrize("name", ["train.stablelm-1.6b-l4.s512"])
def test_a_step_that_returns_its_state_unchanged_fails(monkeypatch, name):
    broken_step(monkeypatch, lambda step, state, batch:
                (state, step(state, batch)[1]))
    rec = run_train(small_train_cell(name))
    assert not rec.correct
    assert rec.checks["change_gap"][0] == pytest.approx(1.0)


def _half(tokens):
    """Half of each worker's batch: its first rows, or the first half of
    its one row's tokens."""
    if tokens.shape[1] > 1:
        return tokens[:, : tokens.shape[1] // 2]
    return tokens[:, :, : tokens.shape[2] // 2 + 1]


@pytest.mark.parametrize("name", ["train.stablelm-1.6b-l4.s512"])
def test_half_of_the_batch_left_out_fails(monkeypatch, name):
    broken_step(monkeypatch, lambda step, state, batch:
                step(state, {"tokens": _half(batch["tokens"])}))
    rec = run_train(small_train_cell(name))
    assert not rec.correct, rec.checks


def test_the_fp8_control_fails_the_training_limits(cpu):
    cell = small_train_cell()
    from repro_torch.models.config import ModelConfig
    for seed in (1, 2, 3):
        theta0 = weights.draw(
            weights.program_shapes(ModelConfig(**cell.config["model"])),
            cell.config["init"], seed, cpu)
        feed = train.feeder(cell, seed, cpu)
        want = train.reference_steps(cell, theta0, feed, 3, reference.FP32)
        ctl = train.reference_steps(cell, theta0, feed, 3,
                                    reference.Numerics(fp8=True))
        ok, checks = judge.verdict(judge.train_numbers(ctl, want),
                                   cell.limits)
        assert not ok, checks


def test_a_sound_serving_run_is_correct():
    rec = run_serve(small_serve_cell())
    assert rec.correct, rec.checks
    assert rec.attempted == len(rec.requests) and rec.failed == 0


def test_a_token_altered_where_it_is_produced_fails(monkeypatch):
    from repro_torch.distributed import scheduler
    monkeypatch.setattr(scheduler, "greedy", lambda logits, gen: (
        torch.argmax(logits, dim=-1) + 1) % logits.shape[-1])
    rec = run_serve(small_serve_cell())
    assert not rec.correct, rec.checks


def test_the_fp8_control_moves_the_served_logits(cpu):
    """At this size fp8 moves the logits too little to flip the served
    tokens, so the cell's limit (set at the cell's size on the card,
    PERF.md) is not reached here; what holds is that the control's logits
    at the served positions lie several times further from the
    reference's than the program's bf16 logits do."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import prefill
    cell = small_serve_cell()
    model = cell.config["model"]
    rec = run_serve(cell, seed=5)
    theta = weights.draw(weights.program_shapes(ModelConfig(**model)),
                         cell.config["init"], 5, cpu)
    checked = rec.notes["readings"]["checked"]
    ref = serve.reference_logits(cell, theta, 5, checked, cpu,
                                 reference.FP32)
    ctl = serve.reference_logits(cell, theta, 5, checked, cpu,
                                 reference.Numerics(fp8=True))
    rel_ctl = rel_prog = 0.0
    for (c, i, n, padded, _), r, q in zip(checked, ref, ctl):
        toks = serve.padded_prompt(cell.traffic, model["vocab"], 5, c, i, n,
                                   padded, cpu)[None]
        prog = prefill(ModelConfig(**model), weights.unflatten(theta),
                       toks)[0][0].float()
        rel_prog += float((prog - r).norm() / r.norm())
        rel_ctl += float((q - r).norm() / r.norm())
    assert rel_ctl > 3 * rel_prog > 0
