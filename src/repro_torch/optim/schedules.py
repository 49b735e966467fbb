"""Learning-rate schedules: ``schedule(step) -> float`` with ``step`` the
optimizer's integer step count (a Python int in the port, so a schedule
never reads the device).

The paper uses a constant stepsize α = O(1/√K) for Theorem 4 and the
PL-condition schedule α_k = 2/(μ(k+K0)) for Theorem 5.
"""
from __future__ import annotations

import math


def constant(value: float):
    return lambda step: float(value)


def inv_sqrt_horizon(eta: float, horizon: int):
    """α = η/√K, the Theorem-4 choice (constant over the run)."""
    return constant(eta / float(horizon) ** 0.5)


def pl_schedule(mu: float, k0: float = 1.0):
    """α_k = 2 / (μ (k + K0)) — Theorem 5's O(1/K) schedule."""
    return lambda step: 2.0 / (mu * (step + k0))


def cosine(peak: float, total_steps: int, warmup: int = 0,
           floor: float = 0.0):
    def fn(step):
        s = float(step)
        if s < warmup:
            return peak * s / max(1.0, warmup)
        prog = min(max((s - warmup) / max(1.0, total_steps - warmup), 0.0),
                   1.0)
        return floor + 0.5 * (peak - floor) * (1.0 + math.cos(math.pi * prog))
    return fn
