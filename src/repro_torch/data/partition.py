"""Worker data partitioning (copies of the JAX package's numpy code).

  * ``uniform_partition``   — equal-size i.i.d. shards (ijcnn1 / MNIST);
  * ``dirichlet_partition`` — label-skewed shards via Dir(alpha) mixing;
  * ``random_sizes_partition`` — i.i.d. labels, unequal sizes (covtype).
    The sizes are drawn, so two shards may still come out equal.

Each returns a list of index arrays, one per worker; ``pad_to_matrix``
right-pads them to an (M, n_shard) index matrix for device-side sampling.
"""
from __future__ import annotations

import numpy as np


def uniform_partition(n: int, m: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(s) for s in np.array_split(idx, m)]


def random_sizes_partition(n: int, m: int, seed: int = 0,
                           min_frac: float = 0.3) -> list[np.ndarray]:
    if m > n:
        raise ValueError(f"cannot split {n} examples into {m} non-empty "
                         "shards")
    rng = np.random.default_rng(seed)
    w = min_frac + rng.random(m)
    w = w / w.sum()
    # every shard >= 1 whatever the weights: each worker gets one example
    # up front, the remaining n - m are shared by weight, and the rounding
    # remainder goes to the largest fractional parts
    frac = w * (n - m)
    sizes = 1 + np.floor(frac).astype(int)
    rem = n - sizes.sum()
    if rem:
        sizes[np.argsort(-(frac - np.floor(frac)), kind="stable")[:rem]] += 1
    idx = rng.permutation(n)
    out, s = [], 0
    for sz in sizes:
        out.append(np.sort(idx[s:s + sz]))
        s += sz
    return out


def dirichlet_partition(labels: np.ndarray, m: int, alpha: float = 0.3,
                        seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    shards: list[list[int]] = [[] for _ in range(m)]
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        probs = rng.dirichlet([alpha] * m)
        cuts = (np.cumsum(probs) * len(idx)).astype(int)[:-1]
        for w, part in enumerate(np.split(idx, cuts)):
            shards[w].extend(part.tolist())
    return [np.sort(np.array(s, dtype=np.int64)) for s in shards]


def pad_to_matrix(shards: list[np.ndarray], seed: int = 0) -> np.ndarray:
    """(M, n_max) index matrix; short shards wrap around (with-replacement).

    The wrap fill is a seeded random subset of the shard, not its head, so
    every example appears ⌊n_max/len(s)⌋ or ⌊n_max/len(s)⌋+1 times.
    """
    n_max = max(len(s) for s in shards)
    rng = np.random.default_rng(seed)
    out = np.zeros((len(shards), n_max), dtype=np.int64)
    for i, s in enumerate(shards):
        if len(s) == 0:
            raise ValueError(f"worker {i} received an empty shard")
        reps, rem = divmod(n_max, len(s))
        fill = np.tile(s, reps)
        if rem:
            fill = np.concatenate([fill, rng.permutation(s)[:rem]])
        out[i] = fill
    return out
