"""The hybrid serving cell's limit against its control and its faults, at
the cell's own size on the card: on each seed a short run of the cell
(which must come out correct), then, at the served positions of its
checked requests, each variant of the reference
(``ref_granite_h.Variant``) in the program's place: its logits held to
``logit_err_max`` and the token it puts first to ``logit_gap_max``, as
the program's are. The fp8 control and the two faults (B and C left
unconvolved; the softmax scale 1/√64 for the published 1/64) must fail
the limits on every seed; the scan state held in bf16 is reported beside
them. Skips without a card; on the card:

    python3 -m pytest -m cuda -s bench/test_bench_hybrid_card.py
"""
from __future__ import annotations

import gc
import time

import pytest

from bench import judge, reference, serve_hybrid, weights
from bench.cell import load_cell
from bench.ref_granite_h import Variant

pytestmark = pytest.mark.cuda

CELL = "serve.granite-4.0-h-micro.prefill"
MUST_FAIL = {"fp8 products": Variant(num=reference.Numerics(fp8=True)),
             "B and C unconvolved": Variant(conv_bc=False),
             "softmax scale 1/sqrt(64)": Variant(scale=0.125)}
REPORTED = {"scan state in bf16": Variant(state_bf16=True)}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the controls run at the cell's own size, on the card")
    reference.no_tf32()
    yield torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("seed", [3400000701, 3400000702])
def test_the_control_and_the_faults_fail_the_hybrid_cell(card, seed):
    import torch
    from bench.flops import PEAKS
    from repro_torch.models.config import PatternConfig
    cell = load_cell(CELL)
    rec = serve_hybrid.run(cell, seed, 6.0, False, card, time.perf_counter(),
                           PEAKS[torch.cuda.get_device_name(0)])
    assert rec.correct, rec.checks
    theta = weights.draw(
        weights.program_shapes(PatternConfig(**cell.config["model"])),
        cell.config["init"], seed, card)
    checked = rec.notes["readings"]["checked"]
    ref = serve_hybrid.reference_logits(cell, theta, seed, checked, card)
    readings = {"program": {k: v for k, (v, _) in rec.checks.items()}}
    for name, variant in {**MUST_FAIL, **REPORTED}.items():
        ctl = serve_hybrid.reference_logits(cell, theta, seed, checked, card,
                                            variant)
        readings[name] = {
            "logit_gap_max": max(judge.logit_gaps(
                [int(c.argmax()) for c in ctl], ref)),
            "logit_err_max": max(serve_hybrid.logit_errors(ctl, ref))}
    print(f"seed {seed}: {readings} limits {cell.limits}")
    for name in MUST_FAIL:
        ok, checks = judge.verdict(readings[name], cell.limits)
        assert not ok, (name, checks)
