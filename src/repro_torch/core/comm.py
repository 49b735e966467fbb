"""Communication rules as strategy objects, on the flat plane.

A :class:`CommStrategy` subclass owns what is specific to one rule: its
extra state (:meth:`~CommStrategy.init_flat_extras`), its LHS given fresh
gradients (:meth:`~CommStrategy.flat_lhs`), its post-upload transition
(:meth:`~CommStrategy.flat_post_upload`), its wire format
(:meth:`~CommStrategy.flat_wire_delta`, :meth:`~CommStrategy.flat_sparse_wire`)
and its accounting. :func:`repro_torch.core.flat.flat_comm_round` owns what
every rule shares.

  ==========  =======================  ====================================
  eq. (5)     :class:`LAGStrategy`     naive stochastic LAG (§2.1 baseline)
  eq. (7)     :class:`CADA1Strategy`   SVRG-style snapshot innovation
  eq. (10)    :class:`CADA2Strategy`   same-sample two-iterate difference
  —           :class:`AlwaysStrategy`  threshold never satisfied ⇒ Adam
  beyond      :class:`CompressedInnovationStrategy`  quantized-innovation
  paper                                gating (``cinn``)
  beyond      :class:`LAQStrategy`     LAQ: error-feedback residual +
  paper                                quantized wire
  beyond      :class:`TopKStrategy`    top-k sparsified innovation with
  paper                                error feedback
  beyond      :class:`AVPStrategy`     per-worker variance-adaptive upload
  paper                                period
  ==========  =======================  ====================================

``quantize_bits`` puts the b-bit wire quantizer under any kind. The
delta-payload rules ``local_momentum`` and ``fedadam`` (local momentum SGD
and FedAdam, the paper's local-update baselines) are registered by
:mod:`repro_torch.core.local_update`, which the package imports after this
module.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.flat import (per_worker_quantize_dequantize_flat,
                                   per_worker_topk_extract_flat,
                                   per_worker_topk_sparsify_flat)
from repro_torch.core.quantize import ef_correct, ef_residual, topk_count
from repro_torch.core.rules import CommRule
from repro_torch.kernels import ops as kops
from repro_torch.utils.trees import tree_map


def adapt_period(period, grow, p_min, p_max):
    """Integer cadence adaptation: ±1, clipped to [p_min, p_max], int32.
    avp's per-worker upload periods GROW while the innovation energy stays
    under the shared RHS and shrink when it clears it."""
    period = torch.as_tensor(period, dtype=torch.int32)
    nxt = torch.where(grow, period + 1, period - 1)
    return torch.clamp(nxt, p_min, p_max).to(torch.int32)


class CommStrategy:
    """Base class: one instance per rule. Defaults: no extra state, no
    second evaluation, the innovation on the wire at 32 bits per entry (or
    at ``quantize_bits``), one gradient evaluation per iteration."""

    kind: str = "?"
    #: worker-side gradient evaluations per iteration (paper §2.2)
    grad_evals_per_iter: int = 1
    #: True ⇒ the rule keeps NO innovation state (the trainer drops the
    #: whole CommState and runs the lean distributed-baseline step)
    stateless: bool = False
    #: True ⇒ the payload is the model delta of local optimizer steps, not
    #: a fresh gradient (core/local_update.py)
    delta_payload: bool = False

    def __init__(self, rule: CommRule):
        self.rule = rule

    def server_optimizer(self):
        """The server optimizer the rule prescribes (the engine takes it
        when none is given), or None for the engine's default."""
        return None

    def init_flat_extras(self, layout, params, params_flat, m: int,
                         grad_dtype) -> dict:
        """Strategy-owned state on the flat plane."""
        del layout, params, params_flat, m, grad_dtype
        return {}

    def pooled_extras(self) -> tuple:
        """Keys of the extras that are O(M·n) per-worker PLANES: the entries
        the cohort plane (``flat.flat_cohort_round``) keeps in the host
        :class:`~repro_torch.core.flat.WorkerPool` and moves to the device C
        rows at a time (CADA1's ``worker_delta``, laq/topk's error-feedback
        ``residual``, local momentum's ``momenta``). Everything else stays
        on the device in the cohort server state: shared dicts (snapshots,
        rings) and (M,) vectors (slots, periods) are O(n) / O(M). A pooled
        entry's hooks see (C, n_flat) rows; hooks that touch a NON-pooled
        (M,) extra must index it by ``ctx.cohort`` when that is set (see
        CADA2 and avp).

        Writeback-ordering contract (the pipelined cohort driver): the
        host pool is written back LATE — under ``pipeline=True`` round i's
        rows land in the pool one round later, and the rows that
        consecutive cohorts share are forwarded on the device instead
        (``flat.run_cohort_rounds``). Hooks therefore take the in-round
        rows and the extras they return as the only truth of pooled state
        and never read the host pool mid-round; every hook is a function
        of its device inputs, which is what keeps the reordered transfers
        bit-exact."""
        return ()

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

    def transform_delta_flat(self, layout, delta):
        """Wire format of the uploaded innovation on the (M, n_flat) plane:
        the b-bit round trip at :attr:`bits_per_entry` below 32 (one scale
        per worker and leaf segment), else the raw δ. Both sides apply it,
        so the server's stale worker copies stay what each worker sent."""
        if self.bits_per_entry < 32:
            return per_worker_quantize_dequantize_flat(
                layout, delta, self.bits_per_entry)
        return delta

    def flat_wire_delta(self, ctx, extras: dict, cache, delta):
        """The innovation that rides the wire, given the raw fp32
        δ = fresh − stale. Rules whose LHS already compressed the plane
        return their cache instead."""
        del extras, cache
        return self.transform_delta_flat(ctx.layout, delta)

    def flat_sparse_wire(self, ctx, extras: dict, cache, delta):
        """An optional true sparse wire, ((M, K) values, (M, K) int64 flat
        positions), that replaces the dense plane on the wire; None (the
        default) keeps the dense wire."""
        del ctx, extras, cache, delta
        return None

    #: wire width when ``quantize_bits`` is 0; below 32 the wire is quantized
    default_bits: int = 32

    @property
    def bits_per_entry(self) -> int:
        return self.rule.quantize_bits or self.default_bits

    def bytes_per_upload(self, n_params: int) -> float:
        return n_params * self.bits_per_entry / 8.0

    @property
    def wire_format(self) -> str:
        """``dense``, ``quantized`` or ``sparse``: which ledger bucket the
        rule's uploads fill."""
        return "quantized" if self.bits_per_entry < 32 else "dense"


STRATEGIES: dict[str, type[CommStrategy]] = {}


def register(cls: type[CommStrategy]) -> type[CommStrategy]:
    STRATEGIES[cls.kind] = cls
    return cls


def strategy_kinds() -> tuple[str, ...]:
    return tuple(STRATEGIES)


def strategy_for(rule: CommRule) -> CommStrategy:
    try:
        return STRATEGIES[rule.kind](rule)
    except KeyError:
        raise ValueError(
            f"no communication strategy registered for kind={rule.kind!r}; "
            f"known: {strategy_kinds()}") from None


@register
class AlwaysStrategy(CommStrategy):
    """Threshold never satisfied ⇒ plain distributed Adam/AMSGrad."""
    kind = "always"
    stateless = True

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

    def pooled_extras(self):
        # δ̃ is the one O(M·n) plane; θ̃ is shared and stays on the device
        return ("worker_delta",)

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
        #
        # A cohort round's ``upload`` covers only its C rows, but the
        # refcount spans ALL M workers: an offline worker keeps its row as
        # a dense-plane non-participant does (keep = 1), so both planes
        # evict the same row.
        keep = torch.where(upload, 0, 1).to(torch.int32)
        if ctx.cohort is not None:
            cohort = ctx.cohort
            keep = torch.ones_like(slot).index_copy(0, cohort, keep)
            upload_m = torch.zeros(slot.shape, dtype=torch.bool,
                                   device=slot.device).index_copy(
                                       0, cohort, upload)
        else:
            upload_m = upload
        refs = torch.zeros((rr,), dtype=torch.int32,
                           device=slot.device).index_add_(0, slot.long(),
                                                          keep)
        s = torch.argmin(version + torch.where(refs > 0, 2 ** 30, 0)).view(1)
        # The ring is written only when some worker uploads; the choice
        # stays on the device (no host read of the mask).
        written = upload.any()

        def write(row, p):
            new_row = torch.where(written, p.to(row.dtype),
                                  row.index_select(0, s)[0])[None]
            # a cohort round consumes its server state, as the reference's
            # donated cohort step does, so its ring (R rows of the model)
            # is written in place; the dense round returns a new ring
            if ctx.cohort is not None:
                return row.index_copy_(0, s, new_row)
            return row.index_copy(0, s, new_row)

        ring = tree_map(write, extras["ring"], ctx.params)
        version = version.index_copy(
            0, s, torch.where(written, ctx.step + 1,
                              version.index_select(0, s)).to(version.dtype))
        return {**extras,
                "ring": ring,
                "slot": torch.where(upload_m, s.to(slot.dtype), slot),
                "ring_version": version}


@register
class CompressedInnovationStrategy(CommStrategy):
    """Beyond-paper: compressed-innovation gating. The worker quantizes its
    innovation δ_m to ``quantize_bits`` (default 8) and uploads when the
    quantized innovation carries enough energy: ||Q_b(δ_m)||² > RHS. The
    quantized plane computed for the gate IS the wire (the cache), so the
    round quantizes once; uploads are charged at b bits per entry."""
    kind = "cinn"
    default_bits = 8

    def flat_lhs(self, ctx, extras):
        innovation = ctx.fresh - ctx.comm.worker_grads.float()
        q = self.transform_delta_flat(ctx.layout, innovation)
        return kops.batched_sq_norm(q, impl=ctx.impl), q

    def flat_wire_delta(self, ctx, extras, cache, delta):
        del delta  # cache IS Q_b(δ) of this round's innovation
        return cache


class ErrorFeedbackStrategy(CommStrategy):
    """Shared scaffolding of the explicit-residual compressed-upload rules:
    wire = C(δ_m + e_m), gate = ||wire||², residual transition on upload.
    Subclasses supply the compressor (:meth:`_compress_flat`) and their
    accounting. ``error_feedback=False`` allocates no residual plane."""

    def _compress_flat(self, layout, corrected):
        raise NotImplementedError

    def init_flat_extras(self, layout, params, params_flat, m, grad_dtype):
        if not self.rule.error_feedback:
            return {}
        return {"residual": torch.zeros((m, layout.n_flat), dtype=grad_dtype,
                                        device=params_flat.device)}

    def pooled_extras(self):
        # e_m is a worker-plane: pooled where it exists at all
        return ("residual",) if self.rule.error_feedback else ()

    def flat_lhs(self, ctx, extras):
        delta = ctx.fresh - ctx.comm.worker_grads.float()
        corrected = (ef_correct(delta, extras["residual"])
                     if self.rule.error_feedback else delta)
        wire = self._compress_flat(ctx.layout, corrected)
        return kops.batched_sq_norm(wire, impl=ctx.impl), (wire, corrected)

    def flat_wire_delta(self, ctx, extras, cache, delta):
        del delta
        return cache[0]

    def flat_post_upload(self, extras, cache, upload, ctx):
        if not self.rule.error_feedback:
            return extras
        wire, corrected = cache
        return {**extras,
                "residual": ef_residual(corrected, wire, upload,
                                        extras["residual"])}


@register
class LAQStrategy(ErrorFeedbackStrategy):
    """Beyond-paper: LAQ — lazy uploads with a b-bit quantized wire
    Q_b(δ_m + e_m) and an error-feedback residual e_m. The gate is the
    wire's energy; on upload e_m ← (δ_m + e_m) − Q_b(δ_m + e_m), on skip e_m
    is carried. Uploads are charged at b (default 8) bits per entry."""
    kind = "laq"
    default_bits = 8

    def _compress_flat(self, layout, corrected):
        return self.transform_delta_flat(layout, corrected)


@register
class TopKStrategy(ErrorFeedbackStrategy):
    """Beyond-paper: top-k sparsified innovation with error feedback. The
    wire keeps the ⌈topk_frac·size⌉ largest-magnitude entries of δ_m + e_m
    per (worker, leaf), optionally quantized to ``quantize_bits``; the
    dropped mass lands in e_m. With ``sparse_wire`` the round ships the
    (values, indices) pairs instead of the dense masked plane.

    Accounting is SPARSE: an upload costs k·(value_bits + ⌈log₂ n⌉) bits
    with k = ⌈topk_frac·n⌉ and value_bits = ``quantize_bits`` or 32."""
    kind = "topk"

    def _compress_flat(self, layout, corrected):
        sparse = per_worker_topk_sparsify_flat(layout, corrected,
                                               self.rule.topk_frac)
        return self.transform_delta_flat(layout, sparse)

    def flat_sparse_wire(self, ctx, extras, cache, delta):
        del extras, delta
        if not self.rule.sparse_wire or self.rule.topk_frac >= 1.0:
            return None
        return per_worker_topk_extract_flat(ctx.layout, cache[0],
                                            self.rule.topk_frac)

    def bytes_per_upload(self, n_params: int) -> float:
        k = topk_count(n_params, self.rule.topk_frac)
        index_bits = (max(1, math.ceil(math.log2(n_params)))
                      if n_params > 1 else 1)
        return k * (self.bits_per_entry + index_bits) / 8.0

    @property
    def wire_format(self) -> str:
        return "sparse"


@register
class AVPStrategy(CommStrategy):
    """Beyond-paper: variance-adaptive upload period. Each worker keeps an
    int32 period p_m ∈ [period_min, resolved_period_max] and uploads when
    its staleness reaches p_m (the max-staleness cap still applies). After
    each round p_m shrinks by one while the innovation energy ||δ_m||²
    exceeds the shared RHS, else it grows by one. ``avp_compose`` makes the
    LHS the energy where the worker is due (−∞ otherwise): it then uploads
    only when due AND over the RHS. A worker that sat the round out keeps
    its period."""
    kind = "avp"

    def _adapt(self, period, energy, diff_hist):
        r = self.rule
        return adapt_period(period, ~(energy > r.rhs(diff_hist)),
                            r.period_min, r.resolved_period_max)

    def _gate(self, staleness, period, energy):
        due = staleness >= period
        if self.rule.avp_compose:
            return torch.where(due, energy, -torch.inf).float()
        return torch.where(due, torch.inf, -torch.inf).float()

    def init_flat_extras(self, layout, params, params_flat, m, grad_dtype):
        return {"period": torch.full((m,), self.rule.period_min,
                                     dtype=torch.int32,
                                     device=params_flat.device)}

    def flat_lhs(self, ctx, extras):
        energy = kops.batched_diff_sq_norm(
            ctx.fresh, ctx.comm.worker_grads.float(), impl=ctx.impl)
        # a cohort round gates its C rows against their own periods; the
        # (M,) period vector stays on the server
        period = extras["period"]
        if ctx.cohort is not None:
            period = period[ctx.cohort]
        return self._gate(ctx.comm.staleness, period, energy), energy

    def flat_post_upload(self, extras, energy, upload, ctx):
        if ctx.cohort is not None:
            # the cohort's form of the participation freeze: only the
            # sampled rows evaluated a gradient, so only their periods
            # adapt (the dense plane's integers exactly)
            period = extras["period"]
            return {**extras, "period": period.index_copy(
                0, ctx.cohort, self._adapt(period[ctx.cohort], energy,
                                           ctx.comm.diff_hist))}
        period = self._adapt(extras["period"], energy, ctx.comm.diff_hist)
        if ctx.participation is not None:
            period = torch.where(ctx.participation, period,
                                 extras["period"])
        return {**extras, "period": period}
