"""Cells cut to a size the CPU tests can hold: the cells' own files, with
the port's smoke widths (``stablelm-smoke``, ``internlm2-smoke``) and short
traffic; dtypes, rules, init and limits as the cells have them."""
from __future__ import annotations

import dataclasses
import math

import pytest

from bench.cell import load_cell

SMOKE_TRAIN = dict(n_layers=2, d_model=128, vocab=256, n_heads=4,
                   n_kv_heads=4, d_ff=256)
SMOKE_SERVE = dict(n_layers=2, d_model=128, vocab=256, n_heads=4,
                   n_kv_heads=2, d_ff=256)


def small_train_cell(name="train.stablelm-1.6b-l4.s512", **model):
    cell = load_cell(name)
    cell.config["model"].update(SMOKE_TRAIN, **model)
    cell.traffic.update(global_batch=4, seq=64)
    return cell


def small_serve_cell(**model):
    cell = load_cell("serve.internlm2-1.8b.prefill")
    cell.config["model"].update(SMOKE_SERVE, **model)
    # the full model's logit spread (~0.9): a head of std 0.02 over
    # d_model 2048 is std 0.02·√(2048/128) over 128
    cell.config["init"].insert(0, ["lm_head",
                                   {"normal": 0.02 * math.sqrt(16)}])
    cell.traffic.update(clients=2, n_slots=2, min_len=16, max_len=64,
                        max_seq=65, cycle=8, check_requests=8)
    return cell


def port_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
