"""The general traffic generator: what one cell's traffic file
(``bench/traffic/<name>.json``) describes, drawn from ``--seed``.

Every draw is a function of the seed and of the file alone. Where the
work of a run would otherwise depend on the seed (the prompt lengths of a
serving mix), every seed gets the same set of sizes in another order, so
that runs with different seeds do the same work.

``zipf_tokens`` is a frozen copy of the port's Zipfian LM stream
(``repro_torch.data.synthetic.lm_tokens``: ranks drawn from Zipf(a),
clipped to the vocabulary).
"""
from __future__ import annotations

import math

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one named stream of draws of ``seed`` (any
    whole number ≥ 0, 64 bits and more)."""
    return np.random.default_rng([int(seed), *stream])


def zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                a: float = 1.2) -> np.ndarray:
    """Zipf-distributed token ids of ``shape`` (int64)."""
    ranks = rng.zipf(a, size=shape)
    return np.minimum(ranks - 1, vocab - 1).astype(np.int64)


# ---------------------------------------------------------------- training

def train_batch(traffic: dict, vocab: int, seed: int, step: int
                ) -> np.ndarray:
    """The (global_batch, seq + 1) token rows of one trainer step."""
    rng = rng_for(seed, 1, step)
    return zipf_tokens(rng, (traffic["global_batch"], traffic["seq"] + 1),
                       vocab, traffic.get("zipf_a", 1.2))


# ----------------------------------------------------------------- serving

def length_set(traffic: dict) -> list[int]:
    """The prompt lengths of one cycle: ``cycle`` quantiles of the
    log-uniform law on [min_len, max_len], at the midpoints of equal
    steps of probability; the same for every seed."""
    lo, hi, k = traffic["min_len"], traffic["max_len"], traffic["cycle"]
    return [int(round(math.exp(math.log(lo) + (j + 0.5) / k
                               * (math.log(hi) - math.log(lo)))))
            for j in range(k)]


def rounds(traffic: dict) -> list[list[int]]:
    """The cycle's lengths dealt into groups of ``clients``, one group the
    requests of one round of a closed loop, by a pairing fixed for the
    mix (not by the seed)."""
    c = traffic["clients"]
    lengths = length_set(traffic)
    if len(lengths) % c:
        raise ValueError("a cycle's lengths must split evenly over clients")
    fixed = np.random.default_rng(0).permutation(len(lengths))
    return [[lengths[i] for i in fixed[j:j + c]]
            for j in range(0, len(lengths), c)]


def client_lengths(traffic: dict, seed: int, n: int) -> list[list[int]]:
    """The prompt lengths each client sends, ``n`` each.

    Each cycle the seed permutes the order of the groups (:func:`rounds`)
    and, within a group, which client sends which. So every seed sends the same rounds of work, in another
    order."""
    c = traffic["clients"]
    groups = rounds(traffic)
    out: list[list[int]] = [[] for _ in range(c)]
    cycle = 0
    while len(out[0]) < n:
        rng = rng_for(seed, 2, cycle)
        for g in rng.permutation(len(groups)):
            for client, j in enumerate(rng.permutation(c)):
                out[client].append(groups[g][j])
        cycle += 1
    return [o[:n] for o in out]


def prompt_tokens(traffic: dict, vocab: int, seed: int, client: int,
                  index: int, length: int) -> np.ndarray:
    """The token ids of one prompt, Zipfian like the training stream."""
    rng = rng_for(seed, 3, client, index)
    return zipf_tokens(rng, (length,), vocab, traffic.get("zipf_a", 1.2))

