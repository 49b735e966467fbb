"""The traffic generator (``bench/traffic.py``): deterministic by seed,
the same work for every seed, and a faithful copy of the port's token
stream."""
from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from bench import traffic as T
from bench.cell import load_cell

TRAIN = load_cell("train.stablelm-1.6b-l4.s512").traffic
SERVE = load_cell("serve.internlm2-1.8b.prefill").traffic
SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_are_deterministic_and_distinct(seed):
    a = T.train_batch(TRAIN, 100352, seed, 3)
    assert a.shape == (2, 513) and a.dtype == np.int64
    assert np.array_equal(a, T.train_batch(TRAIN, 100352, seed, 3))
    assert not np.array_equal(a, T.train_batch(TRAIN, 100352, seed, 4))
    assert not np.array_equal(a, T.train_batch(TRAIN, 100352, seed + 1, 3))
    assert len({row.tobytes() for row in a}) == len(a)      # rows differ
    assert a.min() >= 0 and a.max() < 100352


@pytest.mark.parametrize("seed", SEEDS)
def test_serving_lengths_are_the_same_work_in_another_order(seed):
    k, c = SERVE["cycle"], SERVE["clients"]
    per = k // c
    got = T.client_lengths(SERVE, seed, 3 * per)
    assert got == T.client_lengths(SERVE, seed, 3 * per)
    lengths = T.length_set(SERVE)
    assert SERVE["min_len"] <= min(lengths) <= max(lengths) <= SERVE["max_len"]
    for cycle in range(3):
        rounds = sorted(tuple(sorted(client[cycle * per + i] for client
                                     in got)) for i in range(per))
        first = sorted(tuple(sorted(client[i] for client in
                                    T.client_lengths(SERVE, 0, per)))
                       for i in range(per))
        assert rounds == first          # the same rounds, every cycle
    assert got != T.client_lengths(SERVE, seed + 1, 3 * per)


def test_length_set_is_log_uniform_quantiles():
    lengths = T.length_set(SERVE)
    logs = np.log(lengths)
    steps = np.diff(logs)
    assert np.allclose(steps, steps.mean(), atol=2e-3)
    assert Counter(lengths).most_common(1)[0][1] == 1


def test_prompts_are_deterministic():
    a = T.prompt_tokens(SERVE, 32000, 11, 1, 5, 700)
    assert a.shape == (700,)
    assert np.array_equal(a, T.prompt_tokens(SERVE, 32000, 11, 1, 5, 700))
    assert not np.array_equal(a, T.prompt_tokens(SERVE, 32000, 11, 0, 5, 700))


def test_zipf_stream_is_the_ports():
    from repro_torch.data.synthetic import lm_tokens
    for seed in (3, 12345):
        ours = T.zipf_tokens(np.random.default_rng(seed), (5000,), 32000)
        assert np.array_equal(ours, lm_tokens(5000, 32000, seed=seed))
