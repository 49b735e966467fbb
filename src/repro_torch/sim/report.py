"""Metrics over simulated runs: time-to-target-loss, bytes-on-wire,
worker utilization.

Everything here consumes a :class:`repro_torch.sim.runtime.SimResult` and
returns plain floats/dicts (JSON-ready), as the JAX package's
``sim/report.py`` does, key for key.

``time_to_target`` is the first simulated second after
which the smoothed loss stays at/below the target for the REST of the run
(suffix-max over a sliding mean), so a transient dip cannot claim the
target. Async runs interleave per-worker losses on one clock; the sliding
window therefore spans at least one gate per worker before it trusts a
level.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.runtime import SimResult

TARGET_SLACK = 1.02   # smoothed loss must stay within 2% of the target


def smoothed_loss(result: SimResult, window: int = 0):
    """(times, smoothed) sliding-mean loss series in time order."""
    order = np.argsort(result.loss_times, kind="stable")
    t = np.asarray(result.loss_times)[order]
    x = np.asarray(result.losses)[order]
    if len(x) == 0:                  # zero-round run: nothing to smooth
        return t, x
    w = window or max(5, 2 * len(result.utilization))
    w = min(w, len(x)) or 1
    smooth = np.convolve(x, np.ones(w) / w, mode="valid")
    return t[w - 1:], smooth


def time_to_target(result: SimResult, target_loss: float,
                   window: int = 0) -> float | None:
    """First simulated second after which the smoothed loss stays ≤ the
    target (within :data:`TARGET_SLACK`) for the rest of the run, or None
    if the run never settles there."""
    t, smooth = smoothed_loss(result, window)
    if len(smooth) == 0:
        return None
    suffix_max = np.maximum.accumulate(smooth[::-1])[::-1]
    ok = suffix_max <= target_loss * TARGET_SLACK
    if not ok.any():
        return None
    return float(t[int(np.argmax(ok))])


def final_loss(result: SimResult, tail: int = 20) -> float | None:
    """Mean loss over the last ``tail`` observations (time-ordered);
    None for a zero-round run (NaN would poison the JSON sinks)."""
    order = np.argsort(result.loss_times, kind="stable")
    x = np.asarray(result.losses)[order]
    if len(x) == 0:
        return None
    return float(x[-min(tail, len(x)):].mean())


def summarize(result: SimResult, target_loss: float | None = None) -> dict:
    """JSON-ready summary row of one simulated run."""
    util = np.asarray(result.utilization)
    row = {
        "mode": result.mode,
        "profile": result.profile,
        "steps": int(result.steps),
        "sim_wall_s": round(result.wall_s, 6),
        "steps_per_sim_sec": (round(result.steps / result.wall_s, 3)
                              if result.wall_s > 0 else None),
        "final_loss": final_loss(result),
        "uploads": int(result.uploads),
        "grad_evals": int(result.grad_evals),
        "mbytes_up": round(result.bytes_up / 1e6, 6),
        "mbytes_down": round(result.bytes_down / 1e6, 6),
        "utilization_mean": round(float(util.mean()), 4),
        "utilization_min": round(float(util.min()), 4),
        "max_staleness": int(result.max_staleness),
    }
    if target_loss is not None:
        ttt = time_to_target(result, target_loss)
        row["target_loss"] = target_loss
        row["time_to_target_s"] = (round(ttt, 6) if ttt is not None
                                   else None)
    # obs ledger fields (additive — every pre-ledger key above is
    # byte-identical with or without them): the per-rule byte split,
    # staleness histogram and gate-margin quantiles record WHY a rule
    # won, not just when it hit target
    if result.ledger is not None:
        led = result.ledger
        row["wire_format"] = led["wire_format"]
        for wf in ("dense", "quantized", "sparse"):
            row[f"mbytes_up_{wf}"] = round(led[f"mbytes_up_{wf}"], 6)
        row["staleness_hist"] = led["staleness_hist"]
        if "gate_margin" in led:
            row["gate_margin"] = {k: round(v, 8)
                                  for k, v in led["gate_margin"].items()}
        for key in ("ring_occupancy", "ring_capacity", "pool_nbytes",
                    "pool_resident_nbytes", "pool_mapped_nbytes",
                    "async_pending_max"):
            if key in led:
                row[key] = led[key]
    return row
