"""Communication rules as strategy objects, on the flat plane.

A :class:`CommStrategy` subclass owns what is specific to one rule: its
extra state (:meth:`~CommStrategy.init_flat_extras`), its LHS given fresh
gradients (:meth:`~CommStrategy.flat_lhs`), its post-upload transition
(:meth:`~CommStrategy.flat_post_upload`) and its accounting.
:func:`repro_torch.core.flat.flat_comm_round` owns what every rule shares.

  ==========  =======================  ====================================
  eq. (5)     :class:`LAGStrategy`     naive stochastic LAG (§2.1 baseline)
  eq. (7)     :class:`CADA1Strategy`   SVRG-style snapshot innovation
  eq. (10)    :class:`CADA2Strategy`   same-sample two-iterate difference
  —           :class:`AlwaysStrategy`  threshold never satisfied ⇒ Adam
  ==========  =======================  ====================================

The reference's other kinds (cinn, laq, topk, avp and the delta-payload
rules) and its b-bit wire quantizer are not ported yet:
:func:`strategy_for` refuses them by name.
"""
from __future__ import annotations

import torch

from repro_torch.core.flat import tree_map
from repro_torch.core.rules import CommRule
from repro_torch.kernels import ops as kops


class CommStrategy:
    """Base class: one instance per rule. Defaults: no extra state, no
    second evaluation, the raw innovation on the wire at 32 bits per entry,
    one gradient evaluation per iteration."""

    kind: str = "?"
    #: worker-side gradient evaluations per iteration (paper §2.2)
    grad_evals_per_iter: int = 1

    def __init__(self, rule: CommRule):
        self.rule = rule

    def init_flat_extras(self, layout, params, params_flat, m: int,
                         grad_dtype) -> dict:
        """Strategy-owned state on the flat plane."""
        del layout, params, params_flat, m, grad_dtype
        return {}

    def flat_pre_step(self, extras: dict, params, params_flat, k: int
                      ) -> dict:
        """Start-of-iteration transition (e.g. CADA1 snapshot refresh)."""
        del params, params_flat, k
        return extras

    def second_eval_shared(self, extras: dict):
        """Params dict at which every worker evaluates its second gradient
        (CADA1's snapshot θ̃), or None."""
        del extras
        return None

    def second_eval_indexed(self, extras: dict):
        """``(ring, slot)``: an (R,)-leading params dict of distinct
        evaluation points and the (M,) int32 ring row of each worker, or
        None when the rule has no second evaluation. ``slot=None`` means
        one row shared by every worker; the default adapts
        :meth:`second_eval_shared` into that form."""
        shared = self.second_eval_shared(extras)
        if shared is None:
            return None
        return tree_map(lambda x: x[None], shared), None

    def flat_lhs(self, ctx, extras: dict):
        """Rule LHS on the flat plane: ((M,) lhs, cache for post-upload)."""
        raise NotImplementedError

    def flat_post_upload(self, extras: dict, cache, upload, ctx) -> dict:
        """State transition once the upload mask is known."""
        del cache, upload, ctx
        return extras

    def flat_wire_delta(self, ctx, extras: dict, cache, delta):
        """The innovation that rides the wire: the raw fp32 δ (the b-bit
        quantizer of the reference is not ported yet)."""
        del ctx, extras, cache
        return delta

    def bytes_per_upload(self, n_params: int) -> float:
        return n_params * 32 / 8.0


STRATEGIES: dict[str, type[CommStrategy]] = {}


def register(cls: type[CommStrategy]) -> type[CommStrategy]:
    STRATEGIES[cls.kind] = cls
    return cls


def strategy_kinds() -> tuple[str, ...]:
    return tuple(STRATEGIES)


def strategy_for(rule: CommRule) -> CommStrategy:
    if rule.kind not in STRATEGIES:
        raise ValueError(
            f"rule kind {rule.kind!r} is not yet ported to repro_torch; "
            f"ported: {strategy_kinds()}")
    if rule.quantize_bits:
        raise ValueError("quantize_bits (the b-bit wire quantizer) is not "
                         "yet ported to repro_torch")
    return STRATEGIES[rule.kind](rule)


@register
class AlwaysStrategy(CommStrategy):
    """Threshold never satisfied ⇒ plain distributed Adam/AMSGrad."""
    kind = "always"

    def flat_lhs(self, ctx, extras):
        return torch.full((ctx.m,), torch.inf, dtype=torch.float32,
                          device=ctx.fresh.device), None


@register
class LAGStrategy(CommStrategy):
    """Eq. (5): naive stochastic LAG — the LHS compares gradients drawn at
    DIFFERENT samples, so its variance never vanishes."""
    kind = "lag"

    def flat_lhs(self, ctx, extras):
        return kops.batched_diff_sq_norm(
            ctx.fresh, ctx.comm.worker_grads.float(), impl=ctx.impl), None


@register
class CADA1Strategy(CommStrategy):
    """Eq. (7): SVRG-style innovation vs. a snapshot θ̃ refreshed every D
    iterations — the LHS is ||δ̃_m^k − δ̃_m^{k−τ}||² with
    δ̃_m = ∇ℓ(θ^k;ξ) − ∇ℓ(θ̃;ξ) at the SAME sample. θ̃ stays a params dict
    (it feeds the gradient evaluation); δ̃ is an (M, n_flat) plane."""
    kind = "cada1"
    grad_evals_per_iter = 2

    def init_flat_extras(self, layout, params, params_flat, m, grad_dtype):
        return {"snapshot": params,
                "worker_delta": torch.zeros((m, layout.n_flat),
                                            dtype=grad_dtype,
                                            device=params_flat.device)}

    def flat_pre_step(self, extras, params, params_flat, k):
        if k % self.rule.max_delay == 0:
            return {**extras, "snapshot": params}
        return extras

    def second_eval_shared(self, extras):
        return extras["snapshot"]

    def flat_lhs(self, ctx, extras):
        delta_fresh = ctx.fresh - ctx.second
        lhs = kops.batched_diff_sq_norm(
            delta_fresh, extras["worker_delta"].float(), impl=ctx.impl)
        return lhs, delta_fresh

    def flat_post_upload(self, extras, delta_fresh, upload, ctx):
        wd = extras["worker_delta"]
        return {**extras,
                "worker_delta": torch.where(upload[:, None],
                                            delta_fresh.to(wd.dtype), wd)}


@register
class CADA2Strategy(CommStrategy):
    """Eq. (10): same-sample two-iterate difference — the LHS is
    ||∇ℓ(θ^k;ξ_m^k) − ∇ℓ(θ^{k−τ_m};ξ_m^k)||², each worker re-evaluating
    its CURRENT sample at its last-communicated iterate.

    The stale iterates live in a STALE-ITERATE RING. The staleness cap
    means at most min(M, D)+1 distinct global iterates appear among the M
    stale copies θ^{k−τ_m}, so the plane keeps:

      * ``ring``         — (R,)-leading params dict of distinct iterates
      * ``slot``         — (M,) int32: each worker's ring row
      * ``ring_version`` — (R,) int32: 1 + the step each row was written
                           (0 = the shared init row), the eviction order
    """
    kind = "cada2"
    grad_evals_per_iter = 2

    def ring_rows(self, m: int) -> int:
        """R = min(M, max_delay) + 1 — the occupancy bound above."""
        return min(m, self.rule.max_delay) + 1

    def init_flat_extras(self, layout, params, params_flat, m, grad_dtype):
        del layout, grad_dtype
        rr = self.ring_rows(m)
        dev = params_flat.device
        return {
            "ring": tree_map(
                lambda p: p[None].expand((rr,) + p.shape).clone(), params),
            "slot": torch.zeros((m,), dtype=torch.int32, device=dev),
            "ring_version": torch.zeros((rr,), dtype=torch.int32,
                                        device=dev),
        }

    def second_eval_indexed(self, extras):
        return extras["ring"], extras["slot"]

    def flat_lhs(self, ctx, extras):
        return kops.batched_diff_sq_norm(ctx.fresh, ctx.second,
                                         impl=ctx.impl), None

    def flat_post_upload(self, extras, cache, upload, ctx):
        slot, version = extras["slot"], extras["ring_version"]
        rr = version.shape[0]
        # Refcount the rows still held by NON-uploading workers and write
        # θ^k into the oldest unreferenced row (argmin takes the first
        # minimum, as jnp.argmin does). Full participation always leaves
        # one free; under partial participation an offline worker's row
        # may be evicted, but only once it is ≥ D versions old, so that
        # worker's next upload is already forced by the staleness cap.
        keep = torch.where(upload, 0, 1).to(torch.int32)
        refs = torch.zeros((rr,), dtype=torch.int32,
                           device=slot.device).index_add_(0, slot.long(),
                                                          keep)
        s = torch.argmin(version + torch.where(refs > 0, 2 ** 30, 0)).view(1)
        # The ring is written only when some worker uploads; the choice
        # stays on the device (no host read of the mask).
        written = upload.any()
        ring = tree_map(
            lambda row, p: row.index_copy(
                0, s, torch.where(written, p.to(row.dtype),
                                  row.index_select(0, s)[0])[None]),
            extras["ring"], ctx.params)
        version = version.index_copy(
            0, s, torch.where(written, ctx.step + 1,
                              version.index_select(0, s)).to(version.dtype))
        return {**extras,
                "ring": ring,
                "slot": torch.where(upload, s.to(slot.dtype), slot),
                "ring_version": version}
