"""The fp8 control at the cells' own sizes, on the card: put in the
program's place on three seeds, it has to come out not correct against
each cell's limits. Skips without a card; on the card:

    python3 -m pytest -m cuda bench/test_bench_card.py
"""
from __future__ import annotations

import time

import pytest

from bench import judge, reference, serve, train, weights
from bench.cell import load_cell

pytestmark = pytest.mark.cuda

FP8 = reference.Numerics(fp8=True)


def free_card() -> None:
    """Return the cached blocks of the last test or seed: the serving
    cell fills most of the card, and a cache fragmented by an earlier
    cell's tensors leaves it too little."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the controls run at the cells' own sizes, on the card")
    reference.no_tf32()
    free_card()
    yield torch.device("cuda", 0)
    free_card()


@pytest.mark.parametrize("name", ["train.stablelm-1.6b-l4.s512"])
def test_the_fp8_control_fails_a_training_cell(card, name):
    from repro_torch.models.config import ModelConfig
    cell = load_cell(name)
    shapes = weights.program_shapes(ModelConfig(**cell.config["model"]))
    for seed in (101, 102, 103):
        theta0 = weights.draw(shapes, cell.config["init"], seed, card)
        feed = train.feeder(cell, seed, card)
        want = train.reference_steps(cell, theta0, feed, 3, reference.FP32)
        ctl = train.reference_steps(cell, theta0, feed, 3, FP8)
        ok, checks = judge.verdict(judge.train_numbers(ctl, want),
                                   cell.limits)
        assert not ok, (seed, checks)


def test_the_fp8_control_fails_the_serving_cell(card):
    """The control serves, at each sampled request's position, the token
    it puts first; its widest gap below the reference's best has to pass
    the cell's limit."""
    from bench.flops import PEAKS
    from repro_torch.models.config import ModelConfig
    cell = load_cell("serve.internlm2-1.8b.prefill")
    shapes = weights.program_shapes(ModelConfig(**cell.config["model"]))
    peak = PEAKS["NVIDIA H100 80GB HBM3"]
    for seed in (501, 502, 503):
        rec = serve.run(cell, seed, 6.0, False, card, time.perf_counter(),
                        peak)
        assert rec.correct, rec.checks
        theta = weights.draw(shapes, cell.config["init"], seed, card)
        checked = rec.notes["readings"]["checked"]
        ref = serve.reference_logits(cell, theta, seed, checked, card,
                                     reference.FP32)
        ctl = serve.reference_logits(cell, theta, seed, checked, card, FP8)
        gaps = judge.logit_gaps([int(c.argmax()) for c in ctl], ref)
        ok, checks = judge.verdict({"logit_gap_max": max(gaps)}, cell.limits)
        assert not ok, (seed, checks)
        del theta, ref, ctl
        free_card()
