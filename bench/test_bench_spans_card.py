"""The program's spans on the card, at the cells' own sizes
(``bench/layers.py``): in a profiled sub-window the program's spans are
placed by their marks, every launch of a port kernel belongs to its own
span (``layers.KERNEL_SPANS``), and the window's clock skew is under
100 µs. Skips without a card; on the card:

    PYTHONPATH=src python3 -m pytest -m cuda bench/test_bench_spans_card.py
"""
from __future__ import annotations

import pytest

from bench import layers
from bench.cell import load_cell
from bench.test_bench_card import card  # noqa: F401  (the fixture)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["train.stablelm-1.6b-l4.s512",
                                  "serve.internlm2-1.8b.prefill"])
def test_port_kernels_launch_inside_their_spans(card, name):  # noqa: F811
    cell = load_cell(name)
    kind = cell.traffic["kind"]
    run = layers.run_train if kind == "train" else layers.run_serve
    out = run(cell, 3100000001, 2.0, 1, card)
    for kernel, span in layers.KERNEL_SPANS[kind].items():
        owners = out["kernels"][kernel]
        assert list(owners) == [span] and owners[span] > 0, (kernel, owners)
    assert out["notes"]["placed_by"] == "marks", out["notes"]
    assert abs(out["notes"]["clock_skew_us"]) < 100, out["notes"]
