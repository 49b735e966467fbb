"""Per-architecture training policy: which CADA rule, precision and
microbatching a (config, mesh) pair gets (the JAX package's
``launch/policy.py``, field for field).

The paper's protocol (fp32 stale state, CADA on every worker) is kept
wherever it fits; the 34B/314B/405B archs need production memory policy
(ZeRO over the pod axis, bf16 stale/moment storage, gradient accumulation),
and every deviation is recorded here in one place.

``rule_kind`` may be ANY strategy registered in :mod:`repro_torch.core.comm`
(the paper's rules, ``cinn``, ``laq``, ``topk``, ``avp`` and the
delta-payload rules); the policy decides hyper-parameters and memory knobs,
never rule behaviour. For ``topk`` the kept fraction scales down with
model size (the absolute kept count is what the wire pays for).

The returned :class:`TrainHParams` may ask for parameter FSDP
(``fsdp=True`` for the 7B+ archs), which the mesh runtime
(``trainer.jit_train_step``) runs: the per-layer gathers of the FSDP dims
inside the remat region. The table itself is the reference's.
"""
from __future__ import annotations

from repro_torch.core.comm import strategy_kinds
from repro_torch.core.rules import CommRule
from repro_torch.distributed.trainer import TrainHParams
from repro_torch.launch.mesh import POD
from repro_torch.models.config import ModelConfig, param_count


def train_policy(cfg: ModelConfig, mesh, rule_kind: str | None = None
                 ) -> TrainHParams:
    """Defaults chosen by napkin math over the per-rank memory; the mesh is
    read through its ``.shape`` only."""
    n = param_count(cfg)
    multi = POD in mesh.shape

    if rule_kind is None:
        rule_kind = "cada2"  # the paper's best-performing rule
    if rule_kind not in strategy_kinds():
        raise ValueError(f"unknown rule kind {rule_kind!r}; registered "
                         f"strategies: {strategy_kinds()}")

    # topk: a 34B+ innovation at frac=0.1 still ships gigabytes per upload;
    # 1% keeps the sparse wire proportionate on the big archs.
    topk_frac = 0.01 if (rule_kind == "topk" and n > 20e9) else 0.1
    rule = CommRule(kind=rule_kind, c=0.6, d_max=10, max_delay=50,
                    topk_frac=topk_frac)

    if n > 100e9:  # grok-1-314b, llama3-405b
        if not multi:
            # Per-worker CADA state cannot fit 16 data-axis workers on one
            # pod; run the paper's own baseline (distributed AMSGrad) and
            # exercise CADA across pods.
            rule = CommRule(kind="always")
        # Params FSDP stays POD-LOCAL (pod-spanning param gathers would
        # cross the slow inter-pod link per layer per microbatch); only
        # the once-per-step optimizer state ZeROs across pods.
        return TrainHParams(
            rule=rule, microbatches=16, cada_dtype="bfloat16",
            moments_dtype="bfloat16", fsdp=True, fsdp_axes=("data",),
            state_fsdp_axes=("data", "pod") if multi else ())

    if n > 20e9:  # yi-34b
        return TrainHParams(rule=rule, microbatches=16,
                            cada_dtype="bfloat16", fsdp=True)

    if n > 3e9:  # falcon-mamba-7b
        return TrainHParams(rule=rule, microbatches=8, fsdp=True)

    return TrainHParams(rule=rule, microbatches=4)
