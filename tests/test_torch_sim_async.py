"""The port's async sim (``repro_torch.sim``, ``mode="async"``) against
the JAX package's, and its host-pool form against its device plane.

The problem is ``test_torch_sim.py``'s: the reference's ``test_sim.py``
logistic regression at M = 3, batches drawn with numpy, both packages in
one process on the CPU.

Contract:
  * ``async_tau = 1``: every gate uploads, so the event schedule does not
    depend on a float. For every kind in ``RULES`` the gate times and
    versions, the server-update times, uploads, bytes, staleness and the
    trace's events equal the reference's exactly; the final parameters
    lie within STATE_TOL of each leaf's scale (``test_torch_sim.py``'s
    band; measured at most 2.4e-7, shown with ``-s``).
  * ``async_tau = 20`` on ``hetero`` (cada1, cada2, laq): the gates'
    sequence (time, worker, upload, staleness) equals the reference's up
    to the first gate whose reference margin |LHS − RHS| lies within
    MARGIN_BAND · RHS at a worker the cap does not force (none in these
    runs), and the test asserts how many gates it compared; the final
    parameters within STATE_TOL (measured at most 6.6e-6, laq's 8-bit
    wire).
  * ``host_pool`` (the rows in a host WorkerPool, one row streamed per
    gate, its writeback parked on the device) equals the device (M,
    n_flat) plane bit for bit, also with ``ASYNC_PENDING_CAP`` at 1.
"""
import numpy as np
import pytest
import torch

from repro.core.rules import CommRule as JaxRule
from repro.models.small import logreg_loss as jax_logreg_loss
from repro.obs import Tracer as JaxTracer
import repro.sim as JS
import repro.sim.runtime as JR
from repro_torch.core.rules import RULES, CommRule
from repro_torch.models.small import logreg_loss
from repro_torch.obs import Tracer
import repro_torch.sim as TS
import repro_torch.sim.runtime as TR
from test_torch_sim import M, MARGIN_BAND, STATE_TOL, both, max_gap, problem

torch.set_num_threads(1)


def _recording(cls, log, monkeypatch):
    """Wrap ``cls._build_gate`` so every gate's (LHS, RHS) lands in
    ``log`` (each package's gate returns them for its ledger)."""
    build = cls._build_gate

    def wrapped(self, tau):
        gate = build(self, tau)

        def recorded(*args):
            out = gate(*args)
            log.append((float(out[5]), float(out[6])))
            return out
        return recorded

    monkeypatch.setattr(cls, "_build_gate", wrapped)


def _gates(tracer):
    """(time, worker, upload, staleness) of every gate of a trace."""
    return [(e[4], e[2], e[6]["upload"], e[6]["staleness"])
            for e in tracer.events if e[0] == "i" and e[1] == "gate"]


def _run_both(kind, tau, steps, monkeypatch, network="hetero"):
    params, batches = problem(steps=steps)
    tp, tb, jp, jb = both(params, batches)
    kw = dict(kind=kind, c=0.6, d_max=4, max_delay=50)
    logs = {"port": [], "ref": []}
    _recording(TR.SimRuntime, logs["port"], monkeypatch)
    _recording(JR.SimRuntime, logs["ref"], monkeypatch)
    tt, jt = Tracer(), JaxTracer()
    ours = TS.simulate(logreg_loss, CommRule(**kw), tp, tb, n_workers=M,
                       network=network, mode="async", async_tau=tau,
                       lr=0.01, device="cpu", trace=tt)
    ref = JS.simulate(jax_logreg_loss, JaxRule(**kw), jp, jb, n_workers=M,
                      network=network, mode="async", async_tau=tau,
                      lr=0.01, trace=jt)
    return ours, ref, tt, jt, logs


@pytest.mark.parametrize("kind", RULES)
def test_async_tau_one_equals_the_jax_sim(kind, monkeypatch):
    ours, ref, tt, jt, _ = _run_both(kind, 1, 12, monkeypatch)
    assert ours.steps == ref.steps == 12
    assert np.array_equal(ours.loss_times, ref.loss_times)
    assert np.array_equal(ours.times, ref.times)
    assert ours.wall_s == ref.wall_s
    assert ours.uploads == ref.uploads
    assert ours.uploads >= len(ours.losses) - M     # every gate uploads
    assert ours.bytes_up == ref.bytes_up and ours.bytes_down == ref.bytes_down
    assert ours.max_staleness == ref.max_staleness
    assert ours.grad_evals == ref.grad_evals
    assert np.array_equal(ours.utilization, ref.utilization)
    assert tt.tracks == jt.tracks and tt.events == jt.events
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=1e-5)
    gap = max_gap(ours.final_params, ref.final_params)
    print(f"\n{kind}: async tau=1, params gap {gap:.3g}")
    assert gap <= STATE_TOL


@pytest.mark.parametrize("kind", ["cada1", "cada2", "laq"])
def test_async_gate_sequence_equals_the_jax_sim(kind, monkeypatch):
    ours, ref, tt, jt, logs = _run_both(kind, 20, 30, monkeypatch)
    g_port, g_ref = _gates(tt), _gates(jt)
    compared = 0
    for (lhs, rhs), a, b in zip(logs["ref"], g_port, g_ref):
        forced = b[3] >= 20
        if not forced and abs(lhs - rhs) <= MARGIN_BAND * abs(rhs):
            break
        assert a == b, f"gate {compared}: {a} vs {b}"
        compared += 1
    print(f"\n{kind}: async tau=20, {compared} of {len(g_ref)} gates "
          f"compared, {ours.uploads} uploads")
    assert compared == len(g_ref) == len(g_port)
    assert compared >= 30
    assert ours.uploads == ref.uploads and ours.wall_s == ref.wall_s
    assert len(logs["port"]) == len(logs["ref"])
    assert max_gap(ours.final_params, ref.final_params) <= STATE_TOL
    if kind != "cada1":
        assert ours.uploads < len(g_port), "the gate never skipped"


def _pool_runs(kind, m=M, steps=10):
    params, batches = problem(m=m, steps=steps)
    tp, tb, _, _ = both(params, batches)
    rule = CommRule(kind=kind, c=0.6, d_max=4, max_delay=6)
    return [TS.simulate(logreg_loss, rule, tp, tb, n_workers=m,
                        network="hetero", mode="async", async_tau=5,
                        host_pool=hp, lr=0.01, device="cpu")
            for hp in (False, True)]


def _same(runs):
    assert np.array_equal(runs[0].losses, runs[1].losses)
    assert np.array_equal(runs[0].loss_times, runs[1].loss_times)
    assert runs[0].uploads == runs[1].uploads
    assert runs[0].wall_s == runs[1].wall_s
    for k in runs[0].final_params:
        assert torch.equal(runs[0].final_params[k], runs[1].final_params[k])


@pytest.mark.parametrize("kind", ["cada1", "laq", "cada2", "topk", "avp"])
def test_async_host_pool_equals_the_device_plane(kind):
    runs = _pool_runs(kind)
    _same(runs)
    assert runs[1].ledger["pool_nbytes"] > 0
    assert runs[1].ledger["async_pending_max"] <= TR.ASYNC_PENDING_CAP


def test_async_pending_cap_bounds_the_parked_rows(monkeypatch):
    """With the cap at 1 and M = 8 free-running workers the oldest parked
    row is flushed at nearly every gate; the result is still the device
    plane's bit for bit."""
    monkeypatch.setattr(TR, "ASYNC_PENDING_CAP", 1)
    runs = _pool_runs("cada1", m=8)
    _same(runs)
    assert runs[1].ledger["async_pending_max"] == 1


def test_async_keeps_the_servers_versions_and_the_cap():
    """The reference's ``test_async_converges_and_respects_staleness_cap``
    at its settings: the version target is reached, one upload per
    version at least, the staleness seen at a gate within the cap plus
    one iteration's worth of other workers' updates, the loss down from
    log 2."""
    m, tau = 4, 6
    params, batches = problem(m=m, steps=80, n=1200, batch=32)
    tp, tb, _, _ = both(params, batches)
    rule = CommRule(kind="cada2", c=0.6, d_max=10, max_delay=100)
    res = TS.simulate(logreg_loss, rule, tp, tb, n_workers=m,
                      network="zero", mode="async", async_tau=tau,
                      lr=0.01, device="cpu")
    assert res.steps == 80 and res.uploads >= res.steps
    assert res.max_staleness <= tau + 2 * m
    order = np.argsort(res.loss_times)
    assert res.losses[order][-12:].mean() < 0.3
    assert res.wall_s > 0 and (res.utilization <= 1.0 + 1e-9).all()
