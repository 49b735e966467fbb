"""Synthetic datasets standing in for the paper's ijcnn1 / MNIST (copies of
the JAX package's numpy generators, so one seed gives the same data in both
packages).

  * ``ijcnn1_like`` — binary, 22-dim, logistic-regression friendly.
  * ``mnist_like``  — 10-class, 28x28 images for the MLP experiments.
  * ``lm_tokens``   — a Zipfian token stream for the LM trainer.

Every generator is deterministic in (seed, sizes) and returns plain numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Dataset:
    x: np.ndarray  # features  (n, ...) float32
    y: np.ndarray  # labels    (n,)    int32
    n_classes: int

    @property
    def n(self) -> int:
        return self.x.shape[0]


def _cluster_classification(rng, n, dim, n_classes, noise=1.0, margin=2.0):
    """Gaussian class clusters + label noise — logistic-regression friendly."""
    centers = rng.normal(size=(n_classes, dim)) * margin
    y = rng.integers(0, n_classes, size=n)
    x = centers[y] + rng.normal(size=(n, dim)) * noise
    # 1% label noise: the optimum keeps a non-zero loss, so stochastic
    # gradients keep a non-vanishing variance (the paper's regime)
    flip = rng.random(n) < 0.01
    y = np.where(flip, rng.integers(0, n_classes, size=n), y)
    return x.astype(np.float32), y.astype(np.int32)


def ijcnn1_like(n: int = 10000, seed: int = 1) -> Dataset:
    rng = np.random.default_rng(seed)
    x, y = _cluster_classification(rng, n, dim=22, n_classes=2, noise=1.2)
    return Dataset(x=x, y=y, n_classes=2)


def mnist_like(n: int = 4096, seed: int = 2) -> Dataset:
    """28x28 'digit blobs': class-dependent low-rank images + pixel noise."""
    rng = np.random.default_rng(seed)
    n_classes = 10
    bases = rng.normal(size=(n_classes, 4, 28 * 28)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    coef = rng.normal(size=(n, 4)).astype(np.float32)
    x = np.einsum("nk,nkd->nd", coef, bases[y]) / 4.0
    x += rng.normal(size=x.shape).astype(np.float32) * 0.3
    x = x.reshape(n, 28, 28, 1)
    return Dataset(x=x, y=y, n_classes=n_classes)


def lm_tokens(n_tokens: int, vocab: int, seed: int = 3,
              zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-distributed token ids — realistic rank-frequency for LM smoke."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_a, size=n_tokens)
    return np.minimum(ranks - 1, vocab - 1).astype(np.int32)
