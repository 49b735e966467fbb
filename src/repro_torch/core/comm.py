"""Communication rules as strategy objects, and the per-leaf pytree round.

A :class:`CommStrategy` subclass owns what is specific to one rule: its
extra state, its LHS given fresh gradients, its post-upload transition,
its wire format and its accounting, each in two forms. The flat plane's
hooks (:meth:`~CommStrategy.init_flat_extras`,
:meth:`~CommStrategy.flat_lhs`, :meth:`~CommStrategy.flat_post_upload`,
:meth:`~CommStrategy.flat_wire_delta`,
:meth:`~CommStrategy.flat_sparse_wire`) serve
:func:`repro_torch.core.flat.flat_comm_round`, the engine's and the
trainer's default; the pytree hooks (:meth:`~CommStrategy.init_extras`,
:meth:`~CommStrategy.pre_step`, :meth:`~CommStrategy.lhs`,
:meth:`~CommStrategy.post_upload`, :meth:`~CommStrategy.wire_delta`) serve
:func:`comm_round`, the per-leaf plane of ``fused=False``, which keeps the
state as dicts of (M,)-leading leaves and is the readable oracle the flat
plane is held against. Each of the two rounds owns what every rule
shares.

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
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.flat import (batch_has_local_axis, batch_map,
                                   local_steps_vector,
                                   per_worker_quantize_dequantize_flat,
                                   per_worker_topk_extract_flat,
                                   per_worker_topk_sparsify_flat, spec_dim)
# the pytree round's line-17 tail is the flat plane's: the RHS ring push
# reads only ``diff_hist``, so one function serves both states
from repro_torch.core.flat import record_progress  # noqa: F401
from repro_torch.core.quantize import (ef_correct, ef_residual,
                                       per_worker_quantize_dequantize,
                                       per_worker_topk_sparsify, topk_count)
from repro_torch.core.rules import CommRule
from repro_torch.kernels import ops as kops
from repro_torch.utils.trees import (tree_cast, tree_leaves, tree_map,
                                     tree_size, tree_zeros_like)


# ------------------------------------------------------------------ state

class CommState(NamedTuple):
    """The communication state of Algorithm 1 on the pytree plane:
    gradient-shaped state as dicts, per-worker state as dicts of
    (M,)-leading leaves. ``extras`` is the strategy-owned slice dict."""
    nabla: Any               # ∇^{k-1}: aggregated stale gradient (eq. 3)
    worker_grads: Any        # per-worker last contributed ∇ℓ(θ̂_m;ξ̂_m)
    staleness: torch.Tensor  # τ_m, (M,) int32
    diff_hist: torch.Tensor  # (d_max,) ring buffer of ||θ^{k+1-d}−θ^{k-d}||²
    extras: dict             # strategy-owned per-rule slices


class CommContext(NamedTuple):
    """What a strategy's pytree hooks may consult. ``vgrad(params, batch)``
    gives the per-worker (losses, gradients) at shared parameters,
    ``vgrad_per`` at an (M,)-leading parameter dict."""
    params: Any
    batch: Any
    fresh: Any               # per-worker fresh gradients at θ^k
    comm: CommState
    step: int
    m: int
    vgrad: Callable
    vgrad_per: Callable
    participation: Any = None  # (M,) bool round-participation mask | None
    # the mesh runtime's ``distributed.sharding.TreeSharding`` (None off
    # the mesh): the worker trees then hold the rank's worker row, cut to
    # its ``gwsp`` blocks, the (M,) vectors all M workers, and the hooks
    # pass it to the norms and compressors and cut (M,) vectors to the
    # trees' rows with :meth:`plane_rows`
    shard: Any = None

    def plane_rows(self, v):
        """The entries of an (M,) vector (the round's upload mask) that
        belong to the rows the worker trees hold: all of them off the
        mesh."""
        return v if self.shard is None else self.shard.plane_rows(v)


class CommRoundResult(NamedTuple):
    losses: torch.Tensor     # (M,) per-worker losses at θ^k
    comm: CommState          # diff_hist NOT yet updated (record_progress)
    upload: torch.Tensor     # (M,) bool upload mask
    metrics: dict


# ------------------------------------------------------------ tree helpers

def per_worker_sq_norm(tree, shard=None) -> torch.Tensor:
    """(M,) squared norms of an M-leading dict, accumulated in fp32 leaf
    by leaf in the reference's leaf order. ``shard`` (the mesh runtime's
    ``TreeSharding``, or None): the leaves are the rank's one-row blocks
    under ``gwsp``; each leaf's partial sum is completed over the axes
    that cut it (a leaf no axis cuts counts once), and the rows are
    assembled into all M over the worker axis."""
    parts = []
    for leaf in tree_leaves(tree):
        sq = torch.square(leaf.float())
        parts.append(sq.sum(dim=tuple(range(1, leaf.dim())))
                     if leaf.dim() > 1 else sq)
    if shard is not None:
        parts = shard.complete(parts, shard.worker_specs())
    tot = 0.0
    for part in parts:
        tot = tot + part
    return tot if shard is None else shard.rows_sum(tot)


def select_rows(mask, new, old):
    """Per-worker select: rows of ``new`` where ``mask``, else ``old`` (the
    result keeps ``old``'s storage dtype)."""
    def leaf(n, o):
        mm = mask.reshape((-1,) + (1,) * (n.dim() - 1))
        return torch.where(mm, n.to(o.dtype), o)
    return tree_map(leaf, new, old)


def broadcast_to_workers(tree, m: int):
    return tree_map(lambda x: x[None].expand((m,) + tuple(x.shape)), tree)


def _f32(tree):
    return tree_cast(tree, torch.float32)


def _innovation(fresh, stale):
    """fresh − stale per leaf, in fp32."""
    return tree_map(lambda f, s: f.float() - s.float(), fresh, stale)


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
    #: extras keys SHARED by every worker (not (M,)-leading), which the
    #: async sim (``repro_torch.sim``) passes whole to a one-worker gate
    #: while it slices every other entry to the worker's row (CADA1's θ̃)
    async_shared_extras: tuple = ()
    #: extras keys of the stale-iterate RING family: the async sim skips
    #: them on slice and merge and gives each gate a one-row ring built by
    #: :meth:`async_indexed_row` from the worker's own stale iterate (the
    #: bounded ring assumes the synchronous staleness cap)
    async_indexed_extras: tuple = ()

    def __init__(self, rule: CommRule):
        self.rule = rule

    def server_optimizer(self):
        """The server optimizer the rule prescribes (the engine takes it
        when none is given), or None for the engine's default."""
        return None

    # ---- the pytree plane (comm_round)
    def init_extras(self, params, m: int, make_grad_zeros, bcast) -> dict:
        """Strategy-owned state on the pytree plane. ``make_grad_zeros()``
        gives a gradient-shaped zero dict in the comm storage dtype;
        ``bcast(t, m)`` prepends the worker axis."""
        del params, m, make_grad_zeros, bcast
        return {}

    def extras_specs(self, param_spec, worker_param_spec,
                     worker_grad_spec) -> dict:
        """PartitionSpec dict matching :meth:`init_extras` (the reference's
        table of the pytree plane on the mesh)."""
        del param_spec, worker_param_spec, worker_grad_spec
        return {}

    def pre_step(self, extras: dict, params, k: int) -> dict:
        """Start-of-iteration transition (e.g. CADA1 snapshot refresh)."""
        del params, k
        return extras

    def lhs(self, ctx: CommContext, extras: dict):
        """Rule LHS given fresh gradients: ((M,) lhs, cache for
        :meth:`post_upload`)."""
        raise NotImplementedError

    def post_upload(self, extras: dict, cache, upload, ctx: CommContext
                    ) -> dict:
        """State transition once the upload mask is known."""
        del cache, upload, ctx
        return extras

    def transform_delta(self, delta, shard=None):
        """Wire format of the uploaded innovation δ_m on the pytree plane:
        the b-bit round trip at :attr:`bits_per_entry` below 32 (one scale
        per worker and leaf, completed over the axes that cut the leaf on
        the mesh), else the raw δ."""
        if self.bits_per_entry < 32:
            complete = (None if shard is None else
                        lambda parts, op: shard.complete(
                            parts, shard.worker_specs(), op))
            return per_worker_quantize_dequantize(delta, self.bits_per_entry,
                                                  complete)
        return delta

    def wire_delta(self, ctx: CommContext, extras: dict, cache, delta):
        """The innovation that rides the wire, given the raw fp32
        δ = fresh − stale; rules whose LHS already compressed it return
        their cache instead."""
        del extras, cache
        return self.transform_delta(delta, ctx.shard)

    def local_payload(self, extras: dict, params, batch, m: int, vgrad_per,
                      h_steps, shard=None):
        """The delta-payload rules' local run on the pytree plane:
        ``(losses, payload, cache)`` (core/local_update.py)."""
        raise NotImplementedError

    # ---- the flat plane (flat.flat_comm_round)
    def init_flat_extras(self, layout, params, params_flat, m: int,
                         grad_dtype) -> dict:
        """Strategy-owned state on the flat plane."""
        del layout, params, params_flat, m, grad_dtype
        return {}

    def flat_extras_specs(self, param_spec, worker_param_spec, waxis: str,
                          P, col_axes: tuple = ()) -> dict:
        """PartitionSpec dict matching :meth:`init_flat_extras` (the
        reference's table). ``col_axes`` are the state-shard axes of the
        flat dim of (M, n_flat) planes."""
        del param_spec, worker_param_spec, waxis, P, col_axes
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

    def async_indexed_row(self, stale_params) -> dict:
        """The one-row ``async_indexed_extras`` entries of one async gate,
        built from the worker's own stale iterate ``stale_params``."""
        del stale_params
        return {}

    def flat_lhs(self, ctx, extras: dict):
        """Rule LHS on the flat plane: ((M,) lhs, cache for post-upload)."""
        raise NotImplementedError

    def flat_post_upload(self, extras: dict, cache, upload, ctx) -> dict:
        """State transition once the upload mask is known."""
        del cache, upload, ctx
        return extras

    def transform_delta_flat(self, layout, delta, shard=None):
        """Wire format of the uploaded innovation on the (M, n_flat) plane:
        the b-bit round trip at :attr:`bits_per_entry` below 32 (one scale
        per worker and leaf segment, completed over the column group on
        the mesh), else the raw δ. Both sides apply it, so the server's
        stale worker copies stay what each worker sent."""
        if self.bits_per_entry < 32:
            return per_worker_quantize_dequantize_flat(
                layout, delta, self.bits_per_entry, shard=shard)
        return delta

    def flat_wire_delta(self, ctx, extras: dict, cache, delta):
        """The innovation that rides the wire, given the raw fp32
        δ = fresh − stale. Rules whose LHS already compressed the plane
        return their cache instead."""
        del extras, cache
        return self.transform_delta_flat(ctx.layout, delta, ctx.shard)

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

    def lhs(self, ctx, extras):
        dev = tree_leaves(ctx.fresh)[0].device
        return torch.full((ctx.m,), torch.inf, dtype=torch.float32,
                          device=dev), None

    def flat_lhs(self, ctx, extras):
        return torch.full((ctx.m,), torch.inf, dtype=torch.float32,
                          device=ctx.fresh.device), None


@register
class LAGStrategy(CommStrategy):
    """Eq. (5): naive stochastic LAG — the LHS compares gradients drawn at
    DIFFERENT samples, so its variance never vanishes."""
    kind = "lag"

    def lhs(self, ctx, extras):
        return per_worker_sq_norm(_innovation(ctx.fresh,
                                              ctx.comm.worker_grads),
                                  ctx.shard), None

    def flat_lhs(self, ctx, extras):
        return kops.batched_diff_sq_norm(
            ctx.fresh, ctx.comm.worker_grads.float(), impl=ctx.impl,
            shard=ctx.shard), None


@register
class CADA1Strategy(CommStrategy):
    """Eq. (7): SVRG-style innovation vs. a snapshot θ̃ refreshed every D
    iterations — the LHS is ||δ̃_m^k − δ̃_m^{k−τ}||² with
    δ̃_m = ∇ℓ(θ^k;ξ) − ∇ℓ(θ̃;ξ) at the SAME sample. θ̃ stays a params dict
    (it feeds the gradient evaluation); δ̃ is an (M, n_flat) plane."""
    kind = "cada1"
    grad_evals_per_iter = 2
    async_shared_extras = ("snapshot",)

    def init_extras(self, params, m, make_grad_zeros, bcast):
        return {"snapshot": params,
                "worker_delta": bcast(make_grad_zeros(), m)}

    def extras_specs(self, param_spec, worker_param_spec, worker_grad_spec):
        return {"snapshot": param_spec, "worker_delta": worker_grad_spec}

    def pre_step(self, extras, params, k):
        if k % self.rule.max_delay == 0:
            return {**extras, "snapshot": params}
        return extras

    def lhs(self, ctx, extras):
        _, snap_grads = ctx.vgrad(extras["snapshot"], ctx.batch)
        delta_fresh = _innovation(ctx.fresh, snap_grads)
        diff = tree_map(lambda a, b: a - b.float(), delta_fresh,
                        extras["worker_delta"])
        return per_worker_sq_norm(diff, ctx.shard), delta_fresh

    def post_upload(self, extras, delta_fresh, upload, ctx):
        return {**extras,
                "worker_delta": select_rows(ctx.plane_rows(upload),
                                            delta_fresh,
                                            extras["worker_delta"])}

    def init_flat_extras(self, layout, params, params_flat, m, grad_dtype):
        return {"snapshot": params,
                "worker_delta": torch.zeros((m, layout.n_flat),
                                            dtype=grad_dtype,
                                            device=params_flat.device)}

    def flat_extras_specs(self, param_spec, worker_param_spec, waxis, P,
                          col_axes=()):
        return {"snapshot": param_spec,
                "worker_delta": P(waxis, spec_dim(col_axes))}

    def flat_pre_step(self, extras, params, params_flat, k):
        return self.pre_step(extras, params, k)

    def pooled_extras(self):
        # δ̃ is the one O(M·n) plane; θ̃ is shared and stays on the device
        return ("worker_delta",)

    def second_eval_shared(self, extras):
        return extras["snapshot"]

    def flat_lhs(self, ctx, extras):
        delta_fresh = ctx.fresh - ctx.second
        lhs = kops.batched_diff_sq_norm(
            delta_fresh, extras["worker_delta"].float(), impl=ctx.impl,
            shard=ctx.shard)
        return lhs, delta_fresh

    def flat_post_upload(self, extras, delta_fresh, upload, ctx):
        wd = extras["worker_delta"]
        return {**extras,
                "worker_delta": torch.where(ctx.plane_rows(upload)[:, None],
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
    # the async sim tracks each worker's exact stale iterate on the host
    # (free-running workers break the ring's occupancy bound), and a gate
    # sees a one-row ring of it
    async_indexed_extras = ("ring", "slot", "ring_version")

    # the pytree plane keeps the dense (M,)-leading ``worker_params`` dict
    # of stale iterates (the flat plane's ring is its compressed form)
    def init_extras(self, params, m, make_grad_zeros, bcast):
        return {"worker_params": bcast(params, m)}

    def extras_specs(self, param_spec, worker_param_spec, worker_grad_spec):
        return {"worker_params": worker_param_spec}

    def lhs(self, ctx, extras):
        _, stale_now = ctx.vgrad_per(extras["worker_params"], ctx.batch)
        return per_worker_sq_norm(_innovation(ctx.fresh, stale_now),
                                  ctx.shard), None

    def post_upload(self, extras, cache, upload, ctx):
        stale = extras["worker_params"]
        point = (ctx.params if ctx.shard is None
                 else ctx.shard.params_to_stale(ctx.params))
        rows = tree_leaves(stale)[0].shape[0]
        return {**extras,
                "worker_params": select_rows(
                    ctx.plane_rows(upload), broadcast_to_workers(point, rows),
                    stale)}

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

    def flat_extras_specs(self, param_spec, worker_param_spec, waxis, P,
                          col_axes=()):
        del worker_param_spec, waxis, col_axes
        # ring rows shard like params (the leading R axis replicated); the
        # index vectors ride with the other (M,) scalars
        return {"ring": tree_map(lambda sp: P(None, *sp), param_spec),
                "slot": P(None),
                "ring_version": P(None)}

    def second_eval_indexed(self, extras):
        return extras["ring"], extras["slot"]

    def async_indexed_row(self, stale_params):
        dev = tree_leaves(stale_params)[0].device
        return {"ring": tree_map(lambda x: x[None], stale_params),
                "slot": torch.zeros((1,), dtype=torch.int32, device=dev),
                "ring_version": torch.zeros((1,), dtype=torch.int32,
                                            device=dev)}

    def flat_lhs(self, ctx, extras):
        return kops.batched_diff_sq_norm(ctx.fresh, ctx.second,
                                         impl=ctx.impl,
                                         shard=ctx.shard), None

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

    def lhs(self, ctx, extras):
        q = self.transform_delta(_innovation(ctx.fresh,
                                             ctx.comm.worker_grads),
                                 ctx.shard)
        return per_worker_sq_norm(q, ctx.shard), q

    def wire_delta(self, ctx, extras, cache, delta):
        del delta  # cache IS Q_b(δ) of this round's innovation
        return cache

    def flat_lhs(self, ctx, extras):
        innovation = ctx.fresh - ctx.comm.worker_grads.float()
        q = self.transform_delta_flat(ctx.layout, innovation, ctx.shard)
        return kops.batched_sq_norm(q, impl=ctx.impl, shard=ctx.shard), q

    def flat_wire_delta(self, ctx, extras, cache, delta):
        del delta  # cache IS Q_b(δ) of this round's innovation
        return cache


class ErrorFeedbackStrategy(CommStrategy):
    """Shared scaffolding of the explicit-residual compressed-upload rules:
    wire = C(δ_m + e_m), gate = ||wire||², residual transition on upload.
    Subclasses supply the compressor (:meth:`_compress_flat`) and their
    accounting. ``error_feedback=False`` allocates no residual plane."""

    def _compress(self, corrected, shard=None):
        """The compressor over the fp32 corrected innovation (dicts; on the
        mesh the rank's blocks, ``shard``)."""
        raise NotImplementedError

    def _compress_flat(self, layout, corrected, shard=None):
        """The compressor on the (M, n_flat) plane: the same bits (on the
        mesh over the rank's column slice, ``shard``)."""
        raise NotImplementedError

    def init_extras(self, params, m, make_grad_zeros, bcast):
        if not self.rule.error_feedback:
            return {}
        return {"residual": bcast(make_grad_zeros(), m)}

    def extras_specs(self, param_spec, worker_param_spec, worker_grad_spec):
        if not self.rule.error_feedback:
            return {}
        return {"residual": worker_grad_spec}

    def lhs(self, ctx, extras):
        delta = _innovation(ctx.fresh, ctx.comm.worker_grads)
        corrected = (ef_correct(delta, extras["residual"])
                     if self.rule.error_feedback else delta)
        wire = self._compress(corrected, ctx.shard)
        return per_worker_sq_norm(wire, ctx.shard), (wire, corrected)

    def wire_delta(self, ctx, extras, cache, delta):
        del delta
        return cache[0]

    def _residual_update(self, extras, cache, rows):
        """e_m ← (δ_m + e_m) − wire_m on the uploading ``rows`` (the mask
        of the rows the residual holds)."""
        if not self.rule.error_feedback:
            return extras
        wire, corrected = cache
        return {**extras,
                "residual": ef_residual(corrected, wire, rows,
                                        extras["residual"])}

    def post_upload(self, extras, cache, upload, ctx):
        return self._residual_update(extras, cache, ctx.plane_rows(upload))

    def init_flat_extras(self, layout, params, params_flat, m, grad_dtype):
        if not self.rule.error_feedback:
            return {}
        return {"residual": torch.zeros((m, layout.n_flat), dtype=grad_dtype,
                                        device=params_flat.device)}

    def flat_extras_specs(self, param_spec, worker_param_spec, waxis, P,
                          col_axes=()):
        if not self.rule.error_feedback:
            return {}
        return {"residual": P(waxis, spec_dim(col_axes))}

    def pooled_extras(self):
        # e_m is a worker-plane: pooled where it exists at all
        return ("residual",) if self.rule.error_feedback else ()

    def flat_lhs(self, ctx, extras):
        delta = ctx.fresh - ctx.comm.worker_grads.float()
        corrected = (ef_correct(delta, extras["residual"])
                     if self.rule.error_feedback else delta)
        wire = self._compress_flat(ctx.layout, corrected, ctx.shard)
        return (kops.batched_sq_norm(wire, impl=ctx.impl, shard=ctx.shard),
                (wire, corrected))

    def flat_wire_delta(self, ctx, extras, cache, delta):
        del delta
        return cache[0]

    def flat_post_upload(self, extras, cache, upload, ctx):
        return self._residual_update(extras, cache, ctx.plane_rows(upload))


@register
class LAQStrategy(ErrorFeedbackStrategy):
    """Beyond-paper: LAQ — lazy uploads with a b-bit quantized wire
    Q_b(δ_m + e_m) and an error-feedback residual e_m. The gate is the
    wire's energy; on upload e_m ← (δ_m + e_m) − Q_b(δ_m + e_m), on skip e_m
    is carried. Uploads are charged at b (default 8) bits per entry."""
    kind = "laq"
    default_bits = 8

    def _compress(self, corrected, shard=None):
        return self.transform_delta(corrected, shard)

    def _compress_flat(self, layout, corrected, shard=None):
        return self.transform_delta_flat(layout, corrected, shard)


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

    def _compress(self, corrected, shard=None):
        if shard is not None:
            # the exact top-k with its lower-index tie order needs the
            # whole leaf: the worker's leaves are gathered over the axes
            # that cut them, compressed, and cut back
            return shard.on_whole_worker(self._compress, corrected)
        return self.transform_delta(
            per_worker_topk_sparsify(corrected, self.rule.topk_frac))

    def _compress_flat(self, layout, corrected, shard=None):
        sparse = per_worker_topk_sparsify_flat(layout, corrected,
                                               self.rule.topk_frac, shard)
        return self.transform_delta_flat(layout, sparse, shard)

    def flat_sparse_wire(self, ctx, extras, cache, delta):
        """The (values, indices) pair of each row's kept entries. On a mesh
        whose worker planes shard columns no rank holds a whole segment,
        and the dense masked wire rides instead: the pair rebuilds it
        value for value, and the mesh's eq. (3) collective is dense."""
        del extras, delta
        if not self.rule.sparse_wire or self.rule.topk_frac >= 1.0:
            return None
        if ctx.shard is not None and ctx.shard.col_axes:
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

    def _init_periods(self, m: int, device):
        return torch.full((m,), self.rule.period_min, dtype=torch.int32,
                          device=device)

    def init_extras(self, params, m, make_grad_zeros, bcast):
        return {"period": self._init_periods(m,
                                             tree_leaves(params)[0].device)}

    def extras_specs(self, param_spec, worker_param_spec, worker_grad_spec):
        from repro_torch.distributed.sharding import P
        return {"period": P(None)}

    def lhs(self, ctx, extras):
        energy = per_worker_sq_norm(_innovation(ctx.fresh,
                                                ctx.comm.worker_grads),
                                    ctx.shard)
        return self._gate(ctx.comm.staleness, extras["period"],
                          energy), energy

    def post_upload(self, extras, energy, upload, ctx):
        period = self._adapt(extras["period"], energy, ctx.comm.diff_hist)
        if ctx.participation is not None:
            # an offline worker evaluated nothing this round: its period
            # cannot adapt to a gradient it never computed
            period = torch.where(ctx.participation, period,
                                 extras["period"])
        return {**extras, "period": period}

    def init_flat_extras(self, layout, params, params_flat, m, grad_dtype):
        return {"period": self._init_periods(m, params_flat.device)}

    def flat_extras_specs(self, param_spec, worker_param_spec, waxis, P,
                          col_axes=()):
        return {"period": P(None)}

    def flat_lhs(self, ctx, extras):
        energy = kops.batched_diff_sq_norm(
            ctx.fresh, ctx.comm.worker_grads.float(), impl=ctx.impl,
            shard=ctx.shard)
        # a cohort round gates its C rows against their own periods; the
        # (M,) period vector stays on the server
        period = extras["period"]
        if ctx.cohort is not None:
            period = period[ctx.cohort]
        return self._gate(ctx.comm.staleness, period, energy), energy

    def flat_post_upload(self, extras, energy, upload, ctx):
        if ctx.cohort is None:
            return self.post_upload(extras, energy, upload, ctx)
        # the cohort's form of the participation freeze: only the sampled
        # rows evaluated a gradient, so only their periods adapt (the dense
        # plane's integers exactly)
        period = extras["period"]
        return {**extras, "period": period.index_copy(
            0, ctx.cohort, self._adapt(period[ctx.cohort], energy,
                                       ctx.comm.diff_hist))}


# ----------------------------------------------------------- shared round

def init_comm_state(strategy: CommStrategy, params, m: int,
                    grad_dtype=None) -> CommState:
    """Fresh pytree CommState: τ_m starts at D so iteration 0 uploads
    everywhere. ``grad_dtype`` is the storage dtype of gradient-shaped
    state (None follows each parameter's dtype)."""
    r = strategy.rule
    dev = tree_leaves(params)[0].device
    zeros = tree_zeros_like(params, grad_dtype)
    extras = strategy.init_extras(params, m, lambda: zeros,
                                  broadcast_to_workers)
    return CommState(
        nabla=zeros,
        worker_grads=broadcast_to_workers(zeros, m),
        staleness=torch.full((m,), r.max_delay, dtype=torch.int32,
                             device=dev),
        diff_hist=torch.zeros((r.d_max,), dtype=torch.float32, device=dev),
        extras=extras,
    )


def comm_state_specs(strategy: CommStrategy, param_spec, worker_param_spec,
                     grad_spec, worker_grad_spec, scalar_spec) -> CommState:
    """CommState-shaped PartitionSpec tree of the pytree plane (the
    reference's table): ∇ by ``grad_spec``, the stale gradients by
    ``worker_grad_spec``, τ and the RHS ring by ``scalar_spec``, the
    strategy's extras by its :meth:`~CommStrategy.extras_specs`."""
    return CommState(
        nabla=grad_spec,
        worker_grads=worker_grad_spec,
        staleness=scalar_spec,
        diff_hist=scalar_spec,
        extras=strategy.extras_specs(param_spec, worker_param_spec,
                                     worker_grad_spec),
    )


def comm_round(strategy: CommStrategy, comm: CommState, params, batch,
               k: int, *, vgrad, vgrad_per=None, participation=None,
               local_steps=None, shard=None) -> CommRoundResult:
    """One communication round of Algorithm 1 (lines 4-15) on the pytree
    plane: the reference's expression order, leaf by leaf.

    The caller applies the server update (lines 16-17) to
    ``result.comm.nabla`` and then records the progress scalar with
    :func:`record_progress`. ``participation`` ((M,) bool or None) masks
    the uploads of a partial-participation round; ``local_steps`` is legal
    for the delta-payload rules only, whose batch leads with the H axis
    where ``flat.batch_has_local_axis`` says so and whose payload is the
    model delta of the local run (``flat.flat_comm_round`` has the
    contract).

    ``shard`` (a ``distributed.sharding.TreeSharding`` on the mesh
    runtime, or None) runs the round on one rank: the worker trees of
    ``comm`` hold the rank's worker row cut to its ``gwsp`` blocks, ∇ its
    ``gsp`` blocks, ``params`` its parameter shards, the (M,) vectors all
    M workers; ``vgrad``/``vgrad_per`` give the rank's worker's one-row
    losses and its gradients cut to the ``gwsp`` blocks. The norms and
    the wire's scales are completed per leaf over the axes that cut it,
    and eq. (3) is the per-leaf mean of the workers' rows, gathered over
    the worker axis (a round in which no worker uploads skips the
    gather)."""
    r = strategy.rule
    m = comm.staleness.shape[0]
    rows = None if shard is None else shard.row_index(comm.staleness.device)
    if local_steps is not None and not strategy.delta_payload:
        raise ValueError(
            f"rule kind {r.kind!r} ships per-iteration gradients; "
            "local_steps is only meaningful for delta-payload rules "
            "(local_momentum, fedadam)")

    # Line 4 (rule-owned): e.g. CADA1 snapshot refresh every D iterations.
    extras = strategy.pre_step(comm.extras, params, k)

    if strategy.delta_payload:
        # h_w local optimizer steps per worker; the payload θ^k − θ_m^(h)
        # takes the fresh gradient's place and always uploads
        batch_h = (batch if batch_has_local_axis(r, local_steps)
                   else batch_map(lambda x: x[None], batch))
        h_steps = local_steps_vector(m, batch_h, local_steps,
                                     device=comm.staleness.device)
        losses, fresh, cache = strategy.local_payload(
            extras, params, batch_h, m if rows is None else 1, vgrad_per,
            h_steps if rows is None else h_steps[rows], shard=shard)
        ctx = CommContext(params=params, batch=batch, fresh=fresh,
                          comm=comm._replace(extras=extras), step=k, m=m,
                          vgrad=vgrad, vgrad_per=vgrad_per,
                          participation=participation, shard=shard)
        lhs = torch.full((m,), torch.inf, dtype=torch.float32,
                         device=comm.staleness.device)
    else:
        h_steps = None
        # Lines 6/8: fresh stochastic gradients at θ^k (all rules).
        losses, fresh = vgrad(params, batch)
        ctx = CommContext(params=params, batch=batch, fresh=fresh,
                          comm=comm._replace(extras=extras), step=k, m=m,
                          vgrad=vgrad, vgrad_per=vgrad_per,
                          participation=participation, shard=shard)
        # Lines 7/9: rule LHS vs the shared recent-progress RHS.
        lhs, cache = strategy.lhs(ctx, extras)
    if shard is not None:
        losses = shard.rows_sum(losses)
    rhs = r.rhs(comm.diff_hist)
    # Line 10: upload if the condition is VIOLATED or staleness capped.
    upload = (lhs > rhs) | (comm.staleness >= r.max_delay)
    if participation is not None:
        upload = upload & participation

    # Eq. (3): the wire format is applied to δ before both the server
    # aggregate and the worker's stale copy, and the cast to the stale
    # storage dtype is the wire dtype, so the two sides stay in sync.
    delta = strategy.wire_delta(ctx, extras, cache,
                                _innovation(fresh, comm.worker_grads))
    zeros = tree_zeros_like(delta)
    wire = tree_map(lambda d, s: d.to(s.dtype),
                    select_rows(ctx.plane_rows(upload), delta, zeros),
                    comm.worker_grads)
    if shard is None:
        inc = tree_map(lambda d: d.float().mean(dim=0), wire)
    elif bool(upload.any()):
        # the workers' rows of the rank's blocks, their mean, and the
        # rank's part of it under ∇'s specs
        inc = shard.worker_to_grad(tree_map(
            lambda d: d.float().mean(dim=0), shard.worker_rows(wire)))
    else:   # every row is +0.0: the mean is +0.0 without the gather
        inc = tree_map(lambda n: torch.zeros(n.shape, dtype=torch.float32,
                                             device=n.device), comm.nabla)
    nabla = tree_map(lambda n, d: (n.float() + d).to(n.dtype), comm.nabla,
                     inc)
    worker_grads = tree_map(lambda s, d: (s.float() + d.float()).to(s.dtype),
                            comm.worker_grads, wire)

    staleness = torch.where(upload, 1, comm.staleness + 1).to(torch.int32)
    extras = strategy.post_upload(extras, cache, upload, ctx)

    uploads = upload.sum(dtype=torch.int32)
    n_active = (torch.tensor(m, dtype=torch.int32, device=upload.device)
                if participation is None
                else participation.sum(dtype=torch.int32))
    if strategy.delta_payload:
        # one eval per local step: Σ_active h_w
        grad_evals = (h_steps if participation is None
                      else torch.where(participation, h_steps, 0)
                      ).sum(dtype=torch.int32)
    else:
        grad_evals = n_active * strategy.grad_evals_per_iter
    metrics = {
        "uploads": uploads,
        # the share of ACTIVE workers that skipped
        "skip_rate": 1.0 - uploads.float() / n_active,
        "upload_mask": upload,
        "staleness": staleness,
        "rhs": rhs,
        "lhs": lhs,
        "mean_lhs": torch.where(torch.isfinite(lhs), lhs, 0.0).mean(),
        "max_staleness": staleness.max(),
        "grad_evals": grad_evals,
        "bytes_up": (uploads.float() * strategy.bytes_per_upload(
            tree_size(params) if shard is None
            else shard.whole_size(params, shard.psp))),
    }
    new_comm = CommState(nabla=nabla, worker_grads=worker_grads,
                         staleness=staleness, diff_hist=comm.diff_hist,
                         extras=extras)
    return CommRoundResult(losses=losses, comm=new_comm, upload=upload,
                           metrics=metrics)


def nabla_f32(comm: CommState):
    """The server-update driver ∇^k in fp32 (line 16's input)."""
    return _f32(comm.nabla)

