"""CADA communication-rule hyper-parameters (paper eqs. 5, 7, 10).

A copy of the JAX package's ``core/rules.py``: the same fields, defaults and
validation. A rule decides, per worker and per iteration, whether the fresh
stochastic gradient is informative enough to upload. All rules share the RHS
    (c/d_max) * Σ_{d=1..d_max} ||θ^{k+1-d} − θ^{k-d}||²
(the recent-progress measure, a ring buffer of d_max scalars) and the
max-staleness override τ_m ≥ D.

The hyper-parameters of every kind of the reference validate here, and the
port runs every kind (:func:`repro_torch.core.comm.strategy_for`).
``quantize_bits`` puts a b-bit wire under any kind. The paper's rules:

  * ``cada1``  (eq. 7)  — SVRG-style innovation vs. a snapshot θ̃ refreshed
    every D iterations:  ||δ̃_m^k − δ̃_m^{k−τ}||² ≤ RHS.
  * ``cada2``  (eq. 10) — same-sample two-iterate difference:
    ||∇ℓ(θ^k;ξ_m^k) − ∇ℓ(θ^{k−τ_m};ξ_m^k)||² ≤ RHS, with the stale
    iterates held in a ring of R = min(M, D)+1 rows.
  * ``lag``    (eq. 5)  — naive stochastic LAG (different samples).
  * ``always``          — threshold never satisfied ⇒ distributed Adam.

Beyond-paper rules, which both skip uploads and shrink the ones sent:

  * ``cinn`` — upload iff the b-bit quantized innovation ||Q_b(δ_m)||²
    exceeds the RHS; ``quantize_bits`` (default 8) sets the wire width.
  * ``laq``  — LAQ: the wire is Q_b(δ_m + e_m) with an error-feedback
    residual e_m (``error_feedback=False`` drops it), charged at b bits.
  * ``topk`` — the ``topk_frac`` largest-magnitude entries of δ_m + e_m per
    leaf ride the wire, charged sparsely as k·(value_bits + ⌈log₂ n⌉);
    ``sparse_wire`` ships (values, indices) pairs instead of the dense
    masked plane.
  * ``avp``  — per-worker upload periods in [period_min, period_max],
    adapted against the RHS; ``avp_compose`` also asks ||δ_m||² > RHS.

The delta-payload rules (the paper's local-update baselines) run
``local_steps`` H local steps per round and ship the model delta:

  * ``local_momentum`` — local heavy-ball SGD (``local_lr``,
    ``local_beta``), the models and momenta averaged every round.
  * ``fedadam`` — local SGD at ``local_lr``, a server Adam step at
    ``server_lr`` on the mean delta.
"""
from __future__ import annotations

from dataclasses import dataclass

RULES = ("cada1", "cada2", "lag", "always", "cinn", "laq", "topk", "avp")
#: the delta-payload family (ships local-step model deltas, not gradients)
LOCAL_RULES = ("local_momentum", "fedadam")
#: every kind the reference registers, in its registration order
KINDS = ("always", "lag", "cada1", "cada2", "cinn", "laq", "topk", "avp",
         "local_momentum", "fedadam")


@dataclass(frozen=True)
class CommRule:
    """Hyper-parameters of the adaptive-communication condition."""
    kind: str = "cada2"
    c: float = 0.6          # threshold constant (paper grid {0.05..1.8})
    d_max: int = 10         # averaging window of the RHS (paper: 10 / 2)
    max_delay: int = 50     # D — forces an upload and snapshot period
    quantize_bits: int = 0  # 0 = rule default; b-bit uniform innovation
    error_feedback: bool = True  # laq/topk: carry the residual e_m
    topk_frac: float = 0.1  # topk: fraction of innovation entries uploaded
    sparse_wire: bool = False  # topk: ship (values, indices) pairs
    period_min: int = 1     # avp: per-worker upload-period lower bound
    period_max: int = 0     # avp: upper bound (0 = max_delay)
    avp_compose: bool = False  # avp: upload only when due AND over the RHS
    local_steps: int = 1    # delta-payload rules: local steps H per round
    local_lr: float = 0.1   # delta-payload rules: local SGD learning rate
    local_beta: float = 0.9  # local_momentum: local momentum coefficient
    server_lr: float = 0.01  # fedadam: server Adam learning rate
    adapt_local_steps: bool = False  # adapt H per worker (sim runtime)
    local_steps_min: int = 1  # adaptive-H lower bound
    local_steps_max: int = 0  # adaptive-H upper bound (0 = max_delay)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"rule kind must be one of {KINDS}")
        if self.d_max < 1 or self.max_delay < 1:
            raise ValueError("d_max and max_delay must be >= 1")
        if self.c < 0:
            raise ValueError("threshold c must be >= 0")
        if self.quantize_bits and not 2 <= self.quantize_bits < 32:
            raise ValueError("quantize_bits must be 0 or in [2, 32)")
        if not 0.0 < self.topk_frac <= 1.0:
            raise ValueError("topk_frac must be in (0, 1]")
        if self.period_min < 1 or self.period_max < 0:
            raise ValueError("period_min must be >= 1 and period_max >= 0")
        if self.resolved_period_max < self.period_min:
            raise ValueError(
                f"period_max ({self.resolved_period_max}) must be >= "
                f"period_min ({self.period_min})")
        if self.local_steps < 1:
            raise ValueError("local_steps must be >= 1")
        if self.local_lr <= 0:
            raise ValueError("local_lr must be > 0")
        if not 0.0 <= self.local_beta < 1.0:
            raise ValueError("local_beta must be in [0, 1)")
        if self.server_lr <= 0:
            raise ValueError("server_lr must be > 0")
        if self.local_steps_min < 1 or self.local_steps_max < 0:
            raise ValueError(
                "local_steps_min must be >= 1 and local_steps_max >= 0")
        if self.resolved_local_steps_max < self.local_steps_min:
            raise ValueError(
                f"local_steps_max ({self.resolved_local_steps_max}) must "
                f"be >= local_steps_min ({self.local_steps_min})")
        if ((self.local_steps > 1 or self.adapt_local_steps)
                and self.kind not in LOCAL_RULES):
            raise ValueError(
                f"kind={self.kind!r} ships per-iteration gradients; "
                "local_steps > 1 / adapt_local_steps need a "
                f"delta-payload rule ({LOCAL_RULES})")

    @property
    def resolved_period_max(self) -> int:
        """avp upper period bound: explicit, or the staleness cap D."""
        return self.period_max or self.max_delay

    @property
    def resolved_local_steps_max(self) -> int:
        """Adaptive-H upper bound: explicit, or the staleness cap D."""
        return self.local_steps_max or self.max_delay

    def rhs(self, diff_hist):
        """The shared recent-progress RHS,
        (c/d_max)·Σ_d ||θ^{k+1-d}−θ^{k-d}||²: a Python double times the fp32
        sum, as in the reference."""
        return (self.c / self.d_max) * diff_hist.sum()

    @property
    def grad_evals_per_iter(self) -> int:
        """Worker-side gradient evaluations per iteration (paper §2.2)."""
        from repro_torch.core.comm import strategy_for
        return strategy_for(self).grad_evals_per_iter
