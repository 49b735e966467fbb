"""The port's ``CommRule`` against the reference's, and its strategies'
accounting against the reference's, for every rule kind (the eight
gradient rules and the two delta-payload rules)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import comm as jax_comm
from repro.core.rules import CommRule as JaxRule
from repro_torch.core import comm
from repro_torch.core.rules import CommRule

torch.set_num_threads(1)

BAD = [
    dict(kind="nope"), dict(d_max=0), dict(max_delay=0), dict(c=-1.0),
    dict(quantize_bits=1), dict(quantize_bits=32), dict(topk_frac=0.0),
    dict(topk_frac=1.5), dict(period_min=0), dict(period_max=-1),
    dict(period_min=5, period_max=3), dict(local_steps=0),
    dict(local_lr=0.0), dict(local_beta=1.0), dict(server_lr=0.0),
    dict(local_steps_min=0), dict(local_steps_min=4, local_steps_max=2),
    dict(kind="cada2", local_steps=2),
    dict(kind="lag", adapt_local_steps=True),
]
GOOD = [dict(), dict(kind="always"), dict(kind="lag", c=1.8, d_max=2),
        dict(kind="cada1", max_delay=1), dict(kind="cinn", quantize_bits=4),
        dict(kind="avp", period_min=2, period_max=9),
        dict(kind="fedadam", local_steps=4, adapt_local_steps=True)]


def test_same_fields_and_defaults():
    ours = [(f.name, f.default) for f in dataclasses.fields(CommRule)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxRule)]
    assert ours == ref


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: repr(kw))
def test_same_value_errors(kw):
    with pytest.raises(ValueError) as ref_err:
        JaxRule(**kw)
    with pytest.raises(ValueError) as our_err:
        CommRule(**kw)
    assert str(our_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kw", GOOD, ids=lambda kw: repr(kw))
def test_same_accepted_rules(kw):
    assert dataclasses.asdict(CommRule(**kw)) == dataclasses.asdict(
        JaxRule(**kw))
    assert CommRule(**kw).resolved_period_max == \
        JaxRule(**kw).resolved_period_max
    assert CommRule(**kw).resolved_local_steps_max == \
        JaxRule(**kw).resolved_local_steps_max


def test_rhs_matches_reference():
    import jax.numpy as jnp
    hist = np.array([0.25, 1e-3, 7.5], np.float32)
    rule_kw = dict(c=0.6, d_max=3)
    ours = CommRule(**rule_kw).rhs(torch.from_numpy(hist))
    ref = JaxRule(**rule_kw).rhs(jnp.asarray(hist))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-7)


KINDS = ["always", "lag", "cada1", "cada2", "cinn", "laq", "topk", "avp",
         "local_momentum", "fedadam"]


@pytest.mark.parametrize("kind", KINDS)
def test_ported_kinds_build_their_strategy(kind):
    rule = CommRule(kind=kind)
    s = comm.strategy_for(rule)
    ref = jax_comm.strategy_for(JaxRule(kind=kind))
    assert s.kind == kind and s.rule is rule
    assert rule.grad_evals_per_iter == JaxRule(kind=kind).grad_evals_per_iter
    assert s.delta_payload == ref.delta_payload
    assert (s.server_optimizer() is None) == (ref.server_optimizer() is None)


def test_every_reference_kind_is_registered_in_its_order():
    assert comm.strategy_kinds() == jax_comm.strategy_kinds() == tuple(KINDS)


WIRES = [dict(), dict(quantize_bits=4), dict(quantize_bits=8),
         dict(quantize_bits=16), dict(topk_frac=0.01, sparse_wire=True)]


@pytest.mark.parametrize("kw", WIRES, ids=lambda kw: repr(kw))
@pytest.mark.parametrize("kind", KINDS)
def test_quantized_wire_is_accepted_and_charged_at_b_bits(kind, kw):
    """``quantize_bits`` is accepted for every kind, and each strategy
    charges what the reference's does: n·b/8 bytes per upload for a b-bit
    dense wire, k·(value_bits + ⌈log₂ n⌉)/8 for top-k."""
    ours = comm.strategy_for(CommRule(kind=kind, **kw))
    ref = jax_comm.strategy_for(JaxRule(kind=kind, **kw))
    assert ours.bits_per_entry == ref.bits_per_entry
    assert ours.wire_format == ref.wire_format
    for n in (1, 46, 12_730, 101_770):
        assert ours.bytes_per_upload(n) == ref.bytes_per_upload(n)
    if kind not in ("cinn", "laq", "topk"):
        assert ours.bytes_per_upload(1000) == 1000 * (
            kw.get("quantize_bits") or 32) / 8
