"""The numbers that decide ``correct``, each held to its limit
(``bench/limits/<cell>.json``; ``PERF.md`` gives the readings each limit
was set from).

Training (the first three steps of the window's own step object, against
the reference following them):
  ``loss_gap``    max over the steps of |loss − loss_ref| / |loss_ref|
  ``grad_gap``    the first gradient as the optimizer got it (worked out
                  from its first moment after one step, h / (1 − β1)),
                  by the worst leaf: | ||g|| − ||g_ref|| | over the larger
                  of the reference's norm of that leaf and of the median
                  leaf
  ``change_gap``  the parameters' change over the three steps, by the
                  worst leaf, likewise; leaves whose reference gradient is
                  under a thousandth of the median leaf's are left out
                  (they move by round-off alone)
  ``lhs_gap``     the rule's norm ||g_m − s_m||² of every worker at the
                  steps after the first, | lhs − lhs_ref | over the larger
                  of lhs_ref and the step's threshold
  ``upload_flips``  (step, worker) pairs whose upload differs

Serving (a seeded sample of the window's finished requests, the longest
among them):
  ``logit_gap_max``  the widest gap, over the sample, by which a served
                  token's logit lies below the reference's best at its
                  position
"""
from __future__ import annotations

import statistics

SKIP_BELOW = 1e-3   # of the median leaf's reference gradient norm


def worst_leaf_gap(got: dict, want: dict, keep=None) -> float:
    paths = [p for p in want if keep is None or p in keep]
    med = statistics.median(want[p] for p in paths)
    return max(abs(got[p] - want[p]) / max(want[p], med, 1e-30)
               for p in paths)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"loss": [3], "grad": {leaf: norm}, "change":
    {leaf: norm}, "lhs": [[M] × 3], "rhs": [3], "upload": [[M] × 3]}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                      ref["loss"]))
    med = statistics.median(ref["grad"].values())
    moving = {p for p, g in ref["grad"].items() if g >= SKIP_BELOW * med}
    lhs_gap = 0.0
    for k in range(1, len(ref["lhs"])):
        for a, b in zip(prog["lhs"][k], ref["lhs"][k]):
            scale = max(b, ref["rhs"][k])
            if scale > 0:
                lhs_gap = max(lhs_gap, abs(a - b) / scale)
    flips = sum(bool(a) != bool(b) for pa, ra in zip(prog["upload"],
                                                     ref["upload"])
                for a, b in zip(pa, ra))
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"],
                                         moving),
            "lhs_gap": lhs_gap,
            "upload_flips": float(flips)}


def logit_gaps(served: list, ref_logits: list) -> list:
    """The gap of each ``served`` token id below the reference's best, in
    the reference's logits (V,) at its position."""
    return [float(lg.max() - lg[t]) for t, lg in zip(served, ref_logits)]


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: (value, limit)}); a number
    with no limit, or a limit with no number, fails."""
    checks = {k: (numbers.get(k, float("nan")), limits[k]) for k in limits}
    ok = set(numbers) == set(limits) and all(v <= lim for v, lim in
                                             checks.values())
    return ok, checks
