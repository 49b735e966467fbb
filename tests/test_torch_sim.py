"""The port's sim runtime (``repro_torch.sim``) against the JAX package's
(``repro.sim``): the numpy modules, the barrier modes, the refusals, the
telemetry, the grouped second evaluation and the launcher's
``--runtime sim``. The async mode is in ``test_torch_sim_async.py``.

Both packages run in one process on the CPU from the same numpy inputs:
the logistic regression of the reference's ``tests/test_sim.py`` (ijcnn1
features, M = 3 workers, 8 rounds of 16 samples a worker, zero
parameters), its batches drawn with numpy instead of ``jax.random``.

Contract:
  * ``clock``, ``events`` and ``report`` are copies of numpy code: every
    draw, time, mask, event order and summary equals the reference's bit
    for bit, and ``SimConfig`` refuses what the reference's refuses with
    its message.
  * Degenerate parity, port against port: under the ``zero`` profile the
    barrier sim is the port's own ``CADAEngine.run`` bit for bit (masks,
    staleness, losses, every parameter), with full participation and with
    participation 0.5 against ``run(participation=)``.
  * Against the JAX sim (barrier, ``hetero`` and ``wan``; adaptive local
    steps; the cohort plane): masks and staleness exact except where the
    reference's gate margin |LHS − RHS| lies within MARGIN_BAND · RHS
    (then the comparison stops at that round, and the test asserts how
    many rounds it compared: all of them in these runs); the pricing
    (wall clock, round times, bytes, utilization, the ledger's summary)
    is float64 numpy fed by those masks and must be equal; the final
    parameters within STATE_TOL of each leaf's scale (the lockstep band of
    ``test_torch_lockstep.py``; measured at most 4.3e-7 here, shown with
    ``-s``).
  * topk at its default fraction keeps 5 of the 44 weight entries: the
    binary logreg's two weight columns carry gradients of equal magnitude,
    so its 5th place is an exact tie that rounding breaks, and the two
    packages may keep different entries. Its masks and pricing are held
    exact there; its parameters are held at a fraction whose k takes whole
    pairs and no gate margin lies in the band (0.58: 26 of 44 and 2 of 2).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as JF
from repro.core.engine import CADAEngine as JaxEngine
from repro.core.rules import CommRule as JaxRule
from repro.models.small import logreg_loss as jax_logreg_loss
from repro.models.small import mlp_loss as jax_mlp_loss
from repro.obs import Tracer as JaxTracer
from repro.optim.adam import adam as jax_adam
from repro.optim.fused import FusedAMSGrad as JaxFusedAMSGrad
import repro.sim as JS
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core import flat as F
from repro_torch.core.engine import CADAEngine, sample_cohorts
from repro_torch.core.rules import RULES, CommRule
from repro_torch.data import ijcnn1_like, pad_to_matrix, uniform_partition
from repro_torch.launch import train as train_cli
from repro_torch.models.model import init_params, lm_loss
from repro_torch.models.small import logreg_loss, mlp_loss
from repro_torch.obs import Tracer, validate_chrome_trace, write_chrome_trace
from repro_torch.optim.adam import adam
from repro_torch.optim.fused import FusedAMSGrad
import repro_torch.sim as TS
from repro_torch.utils.trees import tree_leaves, tree_paths, tree_unflatten

torch.set_num_threads(1)

M, STEPS = 3, 8
MARGIN_BAND = 1e-3
STATE_TOL = 2.3e-5
ULP_BAND = 8      # grouped second evaluation: fp32 spacings at the scale


def problem(m=M, steps=STEPS, n=600, batch=16, seed=1):
    """(numpy params, numpy (x, y) batches of shape (steps, M, b, ...))."""
    ds = ijcnn1_like(n=n)
    mtx = pad_to_matrix(uniform_partition(ds.n, m, seed=0))
    rng = np.random.default_rng(seed)
    ids = mtx[np.arange(m)[None, :, None],
              rng.integers(0, mtx.shape[1], (steps, m, batch))]
    params = {"w": np.zeros((22, 2), np.float32),
              "b": np.zeros((2,), np.float32)}
    return params, (ds.x[ids], ds.y[ids])


def both(params, batches):
    """The numpy inputs as (port's, reference's) params and batches."""
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            tuple(torch.from_numpy(b) for b in batches),
            jax.tree.map(jnp.asarray, params),
            tuple(jnp.asarray(b) for b in batches))


def max_gap(port_params, ref_params) -> float:
    """Largest |port − ref| of any leaf over that leaf's scale."""
    gaps = []
    for k in sorted(ref_params):
        a = np.asarray(ref_params[k], np.float32)
        b = port_params[k].float().cpu().numpy()
        gaps.append(float(np.abs(b - a).max() / max(np.abs(a).max(), 1e-30)))
    return max(gaps)


def compared_rounds(ref_mets, max_delay: int) -> int:
    """Rounds before the first whose reference gate margin lies inside
    the band at a worker the staleness cap did not force to upload (all
    rounds when there is none)."""
    lhs = np.asarray(ref_mets["lhs"], np.float64)
    rhs = np.asarray(ref_mets["rhs"], np.float64)[:, None]
    stale = np.asarray(ref_mets["staleness"])
    before = np.concatenate([np.full((1, stale.shape[1]), max_delay),
                             stale[:-1]])
    with np.errstate(invalid="ignore"):
        near = (np.isfinite(lhs) & (before < max_delay)
                & (np.abs(lhs - rhs) <= MARGIN_BAND * np.abs(rhs)))
    rows = np.nonzero(near.any(axis=1))[0]
    return int(rows[0]) if rows.size else lhs.shape[0]


# ------------------------------------------------------- numpy modules

@pytest.mark.parametrize("kind", ["deterministic", "lognormal", "trace"])
def test_compute_model_draws_equal_the_reference(kind):
    kw = dict(eval_s=[1e-3, 2e-3, 5e-4], kind=kind, sigma=0.4, seed=7,
              slowdown=[1.0, 3.0, 1.0], transient=[(1, 0.002, 0.01, 4.0)],
              second_eval_factor=0.5)
    if kind == "trace":
        kw["traces"] = [[1e-3, 3e-3, 2e-3], [5e-4]]
    t = TS.ComputeModel.make(3, **kw)
    j = JS.ComputeModel.make(3, **kw)
    for w in range(3):
        for it in range(12):
            for now in (0.0, 0.005, 0.02):
                for ev in (0, 1):
                    assert t.eval_time(w, it, ev, now) == j.eval_time(
                        w, it, ev, now)
                assert t.iter_time(w, it, now, 2) == j.iter_time(
                    w, it, now, 2)
                assert t.round_time(w, it, now, 3, 2) == j.round_time(
                    w, it, now, 3, 2)


def test_link_model_with_a_trace_equals_the_reference():
    kw = dict(latency_s=[0.01, 0.002], bandwidth=[1e6, 5e5],
              down_bandwidth=[1e7, 2e6])
    traced = dict(latency_s=0.001, trace=[[(0.0, 8.0, 80.0),
                                           (10.0, 16.0, 160.0)],
                                          [(0.0, 4.0)]])
    for make in (kw, traced):
        t, j = TS.LinkModel.make(2, **make), JS.LinkModel.make(2, **make)
        for w in range(2):
            for nbytes in (0, 184.0, 1e6):
                for now in (0.0, 3.3, 99.0):
                    assert t.up_time(w, nbytes, now=now) == j.up_time(
                        w, nbytes, now=now)
                    assert t.down_time(w, nbytes, now=now) == j.down_time(
                        w, nbytes, now=now)
    with pytest.raises(ValueError) as ref:
        JS.LinkModel.make(1, trace=[[(1.0, 8.0), (0.0, 8.0)]])
    with pytest.raises(ValueError) as ours:
        TS.LinkModel.make(1, trace=[[(1.0, 8.0), (0.0, 8.0)]])
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("name", sorted(JS.PROFILES))
def test_network_profiles_equal_the_reference(name):
    assert sorted(TS.PROFILES) == sorted(JS.PROFILES)
    t = TS.network_profile(name, 5, eval_s=2e-3, seed=3)
    j = JS.network_profile(name, 5, eval_s=2e-3, seed=3)
    assert t.name == j.name
    for w in range(5):
        for it in range(6):
            assert t.compute.iter_time(w, it, 0.1, 2) == \
                j.compute.iter_time(w, it, 0.1, 2)
        for nb in (4e5, 1e8):
            assert t.link.up_time(w, nb, now=1.0) == j.link.up_time(
                w, nb, now=1.0)
            assert t.link.down_time(w, nb) == j.link.down_time(w, nb)
    with pytest.raises(ValueError) as ref:
        JS.network_profile("dialup", 4)
    with pytest.raises(ValueError) as ours:
        TS.network_profile("dialup", 4)
    assert str(ours.value) == str(ref.value)


def test_participation_masks_and_event_order_equal_the_reference():
    for m, frac, seed in ((8, 0.4, 3), (5, 1.0, 0), (10, 0.25, 9)):
        assert np.array_equal(TS.ParticipationModel(m, frac, seed).masks(12),
                              JS.ParticipationModel(m, frac, seed).masks(12))
    queues = TS.EventQueue(), JS.EventQueue()
    rng = np.random.default_rng(0)
    times = rng.integers(0, 4, 20) / 2.0
    for q in queues:
        for i, tm in enumerate(times):
            q.push(tm, f"k{i}", worker=i % 3, tag=i)
    popped = [[(e.time, e.kind, e.worker, e.payload) for e in
               (q.pop() for _ in range(len(times)))] for q in queues]
    assert popped[0] == popped[1]


def test_summary_and_time_to_target_equal_the_reference():
    rng = np.random.default_rng(4)
    fields = dict(mode="async", profile="hetero", steps=40, wall_s=3.25,
                  times=np.sort(rng.random(40)) * 3,
                  loss_times=rng.random(90) * 3,
                  losses=np.exp(-np.linspace(0, 3, 90)) + 0.05
                  * rng.random(90),
                  uploads=37, grad_evals=180, bytes_up=1.5e6,
                  bytes_down=9.25e6, utilization=rng.random(3),
                  max_staleness=7, final_params=None,
                  ledger={"wire_format": "quantized", "mbytes_up_dense": 0.0,
                          "mbytes_up_quantized": 1.5, "mbytes_up_sparse": 0.0,
                          "staleness_hist": {1: 30, 2: 7},
                          "gate_margin": {"q10": -0.1, "q50": 0.2,
                                          "q90": 1.3},
                          "ring_occupancy": 3, "async_pending_max": 4})
    t, j = TS.SimResult(**fields), JS.SimResult(**fields)
    for target in (None, 0.2, 1e-9):
        assert TS.summarize(t, target) == JS.summarize(j, target)
    assert TS.time_to_target(t, 0.3) == JS.time_to_target(j, 0.3)
    for a, b in zip(TS.report.smoothed_loss(t, 7),
                    JS.report.smoothed_loss(j, 7)):
        assert np.array_equal(a, b)
    assert TS.report.final_loss(t) == JS.report.final_loss(j)


REFUSED_CONFIGS = {
    "mode": dict(mode="warp"),
    "tau": dict(mode="async", async_tau=-1),
    "cohort-negative": dict(cohort_size=-1),
    "cohort-async": dict(mode="async", cohort_size=2),
    "host-pool-barrier": dict(host_pool=True),
    "cohort-and-participation": dict(cohort_size=2, participation=0.5),
    "async-participation": dict(mode="async", participation=0.5),
    "metrics-every": dict(metrics_every=0),
    "pool-storage": dict(cohort_size=2, pool_storage="disk"),
    "memmap-path": dict(cohort_size=2, pool_storage="memmap"),
    "memmap-knob": dict(pool_storage="memmap", pool_path="/unused"),
}


@pytest.mark.parametrize("case", sorted(REFUSED_CONFIGS))
def test_sim_config_refuses_what_the_reference_refuses(case):
    kw = REFUSED_CONFIGS[case]
    with pytest.raises(ValueError) as ref:
        JS.SimConfig(network=JS.network_profile("zero", 4), **kw)
    with pytest.raises(ValueError) as ours:
        TS.SimConfig(network=TS.network_profile("zero", 4), **kw)
    assert str(ours.value) == str(ref.value)


# ---------------------------------------- degenerate parity, port vs port

@pytest.mark.parametrize("participation", [1.0, 0.5], ids=["full", "half"])
@pytest.mark.parametrize("kind", RULES)
def test_degenerate_sim_matches_the_ports_engine(kind, participation):
    params, batches = problem()
    tp, tb, _, _ = both(params, batches)
    rule = CommRule(kind=kind, c=20.0, d_max=4, max_delay=10)
    res = TS.simulate(logreg_loss, rule, tp, tb, n_workers=M,
                      network="zero", participation=participation, lr=0.01,
                      device="cpu")
    eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.01), rule, M,
                     device="cpu")
    if participation == 1.0:
        fst, mets = eng.run(eng.init(tp), tb)
    else:
        masks = TS.ParticipationModel(M, participation, 0).masks(STEPS)
        assert np.array_equal(res.participation_masks, masks)
        fst, mets = eng.run(eng.init(tp), tb, torch.from_numpy(masks))
        assert not (res.upload_masks & ~masks).any()
    assert np.array_equal(res.upload_masks, mets["upload_mask"].numpy())
    assert np.array_equal(res.staleness, mets["staleness"].numpy())
    assert np.array_equal(res.losses, mets["loss"].double().numpy())
    for k in fst.params:
        assert torch.equal(res.final_params[k], fst.params[k]), k
    if kind == "cada2" and participation == 1.0:
        # the run exercises both branches of the gate
        assert 0 < res.uploads < STEPS * M


# ------------------------------------------------ barrier vs the JAX sim

def _against_jax(kind, network, **rule_kw):
    params, batches = problem()
    tp, tb, jp, jb = both(params, batches)
    kw = dict(kind=kind, c=20.0, d_max=4, max_delay=10, **rule_kw)
    tt, jt = Tracer(), JaxTracer()
    ours = TS.simulate(logreg_loss, CommRule(**kw), tp, tb, n_workers=M,
                       network=network, lr=0.01, device="cpu", trace=tt)
    ref = JS.simulate(jax_logreg_loss, JaxRule(**kw), jp, jb, n_workers=M,
                      network=network, lr=0.01, trace=jt)
    return ours, ref, tt, jt


@pytest.mark.parametrize("network", ["hetero", "wan"])
@pytest.mark.parametrize("kind", RULES)
def test_barrier_sim_matches_the_jax_sim(kind, network):
    ours, ref, tt, jt = _against_jax(kind, network)
    n = compared_rounds(ref.metrics, 10)
    assert n == STEPS, f"a gate margin within the band at round {n}"
    assert np.array_equal(ours.upload_masks, ref.upload_masks)
    assert np.array_equal(ours.staleness, ref.staleness)
    assert ours.wall_s == ref.wall_s
    assert np.array_equal(ours.times, ref.times)
    assert ours.bytes_up == ref.bytes_up and ours.bytes_down == ref.bytes_down
    assert np.array_equal(ours.utilization, ref.utilization)
    assert ours.uploads == ref.uploads and ours.grad_evals == ref.grad_evals
    # the ledger's summary: counts exact, the margins' quantiles within
    # the losses' band (they are float gate values)
    lo, lr_ = dict(ours.ledger), dict(ref.ledger)
    qo, qr = lo.pop("gate_margin", None), lr_.pop("gate_margin", None)
    assert lo == lr_
    if qr is not None:
        for q in qr:
            assert abs(qo[q] - qr[q]) <= 1e-4 * max(abs(qr[q]), 1e-6), q
    assert tt.tracks == jt.tracks
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=1e-5)
    gap = max_gap(ours.final_params, ref.final_params)
    print(f"\n{kind}/{network}: {n} rounds compared, params gap {gap:.3g}")
    if kind != "topk":
        assert gap <= STATE_TOL


def test_barrier_sim_topk_params_at_a_fraction_without_ties():
    ours, ref, _, _ = _against_jax("topk", "hetero", topk_frac=0.58)
    assert compared_rounds(ref.metrics, 10) == STEPS
    assert np.array_equal(ours.upload_masks, ref.upload_masks)
    assert ours.wall_s == ref.wall_s and ours.bytes_up == ref.bytes_up
    assert max_gap(ours.final_params, ref.final_params) <= STATE_TOL


# ------------------------------------------------ adaptive local steps

def _local_problem(rounds=6, h=8, m=M, seed=1):
    rng = np.random.default_rng(seed)
    params = {"w": (0.3 * rng.normal(size=(6, 2))).astype(np.float32),
              "b": (0.1 * rng.normal(size=(2,))).astype(np.float32)}
    return params, (rng.normal(size=(rounds, h, m, 8, 6)).astype(np.float32),
                    rng.normal(size=(rounds, h, m, 8, 2)).astype(np.float32))


def _sq_loss(p, b):
    x, y = b
    return torch.mean((x @ p["w"] + p["b"] - y) ** 2)


def _jax_sq_loss(p, b):
    x, y = b
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


@pytest.mark.parametrize("network", ["wan", "zero"])
def test_adaptive_local_steps_schedule_equals_the_reference(network):
    """The (rounds, M) H schedule is computed on the host from the clock
    before the numerics: equal to the reference's. On the WAN H climbs
    toward the cap; on free links it collapses to 1 (the reference's
    ``test_adaptive_schedule_grows_on_wan_shrinks_on_zero``)."""
    params, batches = _local_problem()
    tp, tb, jp, jb = both(params, batches)
    kw = dict(kind="local_momentum", c=0.6, d_max=4, max_delay=10,
              adapt_local_steps=True, local_steps_max=8, local_lr=0.05)
    ours = TS.SimRuntime(_sq_loss, CommRule(**kw), M, TS.SimConfig(
        network=TS.network_profile(network, M)), device="cpu").run(tp, tb)
    ref = JS.SimRuntime(_jax_sq_loss, JaxRule(**kw), M, JS.SimConfig(
        network=JS.network_profile(network, M))).run(jp, jb)
    hs = ours.metrics["local_steps"]
    assert hs.shape == (6, M)
    assert np.array_equal(hs, np.asarray(ref.metrics["local_steps"]))
    assert ours.wall_s == ref.wall_s and ours.grad_evals == ref.grad_evals
    assert max_gap(ours.final_params, ref.final_params) <= STATE_TOL
    if network == "wan":
        assert (hs[-1] > hs[0]).all() and hs.max() > 1
    else:
        assert (hs[1:] == 1).all()


# ------------------------------------------------ the cohort barrier

def test_federated_cohort_sim_prices_the_cohort_only():
    """``cohort_size``: C-worker rounds on the host-pool cohort plane,
    priced over cohort members only; the masks equal the JAX cohort
    sim's (the reference's
    ``test_federated_cohort_sim_prices_cohort_only``)."""
    m, c, rounds = 32, 8, 10
    params, (x, y) = problem(m=m, steps=rounds)
    tp, tb, jp, jb = both(params, (x, y))
    rule = dict(kind="cada2", c=0.6, d_max=10, max_delay=50)
    ours = TS.simulate(logreg_loss, CommRule(**rule), tp, tb, n_workers=m,
                       network="lan", cohort_size=c, lr=0.01, device="cpu")
    ref = JS.simulate(jax_logreg_loss, JaxRule(**rule), jp, jb,
                      n_workers=m, network="lan", cohort_size=c, lr=0.01)
    assert ours.steps == rounds
    assert ours.upload_masks.shape == (rounds, c)
    assert np.array_equal(ours.metrics["cohorts"], ref.metrics["cohorts"])
    assert np.array_equal(ours.metrics["cohorts"],
                          sample_cohorts(m, c, rounds, seed=0))
    assert np.array_equal(ours.upload_masks, ref.upload_masks)
    assert np.array_equal(ours.staleness, ref.staleness)
    assert ours.wall_s == ref.wall_s and ours.bytes_up == ref.bytes_up
    assert ours.bytes_down == pytest.approx(rounds * c * 4.0 * 46)
    assert ours.upload_masks[0].all()
    assert (ours.metrics["device_worker_plane_bytes"] * (m // c)
            <= ours.metrics["host_pool_bytes"])
    for key in ("host_pool_bytes", "device_worker_plane_bytes"):
        assert ours.metrics[key] == ref.metrics[key]
    assert max_gap(ours.final_params, ref.final_params) <= STATE_TOL


@pytest.mark.parametrize("form", ["sampler", "arrays"])
@pytest.mark.parametrize("kind", ["cada2", "laq", "local_momentum"])
def test_cohort_sim_pipelined_equals_serial(kind, form):
    """The pipelined cohort rounds equal the serial ones bit for bit in
    the port, through a callable sampler and through array batches."""
    m, c, rounds = 8, 3, 10
    local = kind == "local_momentum"
    if local:
        params, (x, y) = _local_problem(rounds=rounds, h=2, m=m)
        loss = _sq_loss
        rule = CommRule(kind=kind, c=0.6, d_max=4, max_delay=6,
                        local_steps=2, local_lr=0.05)
    else:
        params, (x, y) = problem(m=m, steps=rounds)
        loss = logreg_loss
        rule = CommRule(kind=kind, c=5.0, d_max=4, max_delay=6)
    tp, tb, _, _ = both(params, (x, y))
    if form == "sampler":
        def batches(k, cohort):
            return tuple(b[k][:, cohort] if local else b[k][cohort]
                         for b in tb)
    else:
        batches = tb
    runs = [TS.simulate(loss, rule, tp, batches, n_workers=m,
                        network="lan", cohort_size=c, pipeline=p,
                        metrics_every=4, rounds=rounds, lr=0.01,
                        device="cpu")
            for p in (False, True)]
    assert np.array_equal(runs[0].losses, runs[1].losses)
    assert np.array_equal(runs[0].upload_masks, runs[1].upload_masks)
    assert np.array_equal(runs[0].staleness, runs[1].staleness)
    assert runs[0].wall_s == runs[1].wall_s
    for k in runs[0].final_params:
        assert torch.equal(runs[0].final_params[k], runs[1].final_params[k])


# ------------------------------------------------------------ refusals

def test_sim_refusals_equal_the_reference():
    """A delta rule in async mode ("barrier-only"), adaptive H on the
    cohort plane ("cohort") and async without a FusedAMSGrad ("fused"),
    each with the reference's message."""
    lrule = dict(kind="fedadam", c=0.6, d_max=4, max_delay=10,
                 local_steps=4, local_lr=0.05)
    arule = dict(kind="fedadam", adapt_local_steps=True, local_lr=0.05)
    cases = [(lrule, dict(mode="async"), None, "barrier-only"),
             (arule, dict(cohort_size=2), None, "cohort"),
             (dict(kind="always"), dict(mode="async"), "adam", "fused")]
    for rule, cfg, opt, what in cases:
        with pytest.raises(ValueError, match=what) as ref:
            JS.SimRuntime(_jax_sq_loss, JaxRule(**rule), M, JS.SimConfig(
                network=JS.network_profile("wan", M), **cfg),
                optimizer=None if opt is None else jax_adam(0.01))
        with pytest.raises(ValueError, match=what) as ours:
            TS.SimRuntime(_sq_loss, CommRule(**rule), M, TS.SimConfig(
                network=TS.network_profile("wan", M), **cfg),
                optimizer=None if opt is None else adam(0.01),
                device="cpu")
        assert str(ours.value) == str(ref.value)


def test_a_callable_cohort_sampler_needs_rounds():
    params, _ = problem()
    cfg = TS.SimConfig(network=TS.network_profile("zero", 4), cohort_size=2)
    with pytest.raises(ValueError, match="rounds="):
        TS.SimRuntime(logreg_loss, CommRule(kind="always"), 4, cfg,
                      device="cpu").run(
            {k: torch.from_numpy(v) for k, v in params.items()},
            lambda k, cohort: None)


def test_the_sim_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params, batches = problem()
    tp, tb, _, _ = both(params, batches)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.simulate(logreg_loss, CommRule(kind="cada2"), tp, tb,
                    n_workers=M)


# ------------------------------------------------------------ telemetry

@pytest.mark.parametrize("mode", ["barrier", "async"])
def test_sim_trace_exports_and_matches_the_reference(mode, tmp_path):
    params, batches = problem()
    tp, tb, jp, jb = both(params, batches)
    kw = dict(kind="laq", c=0.6, d_max=4, max_delay=10)
    extra = dict(mode=mode, async_tau=5 if mode == "async" else 0)
    tt, jt = Tracer(), JaxTracer()
    ours = TS.simulate(logreg_loss, CommRule(**kw), tp, tb, n_workers=M,
                       network="hetero", lr=0.01, device="cpu", trace=tt,
                       **extra)
    ref = JS.simulate(jax_logreg_loss, JaxRule(**kw), jp, jb, n_workers=M,
                      network="hetero", lr=0.01, trace=jt, **extra)
    obj = write_chrome_trace(tt, str(tmp_path / "sim.json"),
                             meta={"runtime": "sim", "mode": mode})
    assert validate_chrome_trace(obj) >= len(tt.events)
    assert tt.tracks == jt.tracks
    assert tt.events == jt.events
    for key in ("uploads", "mbytes_up", "mbytes_down", "rounds",
                "wire_format", "staleness_hist"):
        assert ours.ledger[key] == ref.ledger[key], key


# ------------------------------------------- grouped second evaluation

def _ring_problem(m=6, rr=4, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w1": (rng.normal(size=(20, 8)) / 4).astype(np.float32),
              "b1": np.zeros(8, np.float32),
              "w2": (rng.normal(size=(8, 3)) / 3).astype(np.float32),
              "b2": np.zeros(3, np.float32)}
    ring = {k: (v[None] + 0.1 * rng.normal(size=(rr,) + v.shape)
                ).astype(np.float32) for k, v in params.items()}
    slot = np.array([0, 2, 2, 3, 0, 2], np.int32)[:m]   # row 1 empty
    x = rng.normal(size=(m, 5, 20)).astype(np.float32)
    y = rng.integers(0, 3, (m, 5)).astype(np.int32)
    return params, ring, slot, x, y


def test_grouped_second_evaluation_equals_the_reference():
    """cada2's ring with R = 4 < M = 6 rows, one of them empty: the
    grouped plane (one evaluation per occupied row) against the
    reference's grouped plane and against the port's gathered plane,
    within ULP_BAND fp32 spacings at the plane's scale."""
    m = 6
    params, ring, slot, x, y = _ring_problem(m)
    rule = dict(kind="cada2", c=1.0, d_max=3, max_delay=3)
    te = CADAEngine(mlp_loss, None, CommRule(**rule), m, device="cpu")
    je = JaxEngine(jax_mlp_loss, None, JaxRule(**rule), m)
    tp = convert.params_from_numpy(params, "cpu")
    jp = jax.tree.map(jnp.asarray, params)
    assert te.strategy.ring_rows(m) == 4
    textras = {"ring": convert.params_from_numpy(ring, "cpu"),
               "slot": torch.from_numpy(slot),
               "ring_version": torch.zeros(4, dtype=torch.int32)}
    jextras = {"ring": jax.tree.map(jnp.asarray, ring),
               "slot": jnp.asarray(slot),
               "ring_version": jnp.zeros(4, jnp.int32)}
    tb = (torch.from_numpy(x), torch.from_numpy(y))
    jb = (jnp.asarray(x), jnp.asarray(y))
    layout = F.layout_of(tp)
    calls = []

    def counting(point, batch):
        calls.append(1)
        return te._vgrad(point, batch)

    planes = {}
    for grouped in (False, True):
        _, _, planes[grouped] = F.eval_two_point(
            te.strategy, layout, textras, tp, tb, m,
            vgrad=counting if grouped else te._vgrad,
            vgrad_per=te._vgrad_per, group_evals=grouped)
    # the fresh evaluation and one per OCCUPIED row (rows 0, 2, 3)
    assert len(calls) == 1 + 3
    _, _, ref = JF.eval_two_point(je.strategy, JF.layout_of(jp), jextras, jp,
                                  jb, m, vgrad=je._vgrad,
                                  vgrad_per=je._vgrad_per, group_evals=True)
    ref = np.asarray(ref)
    band = ULP_BAND * np.spacing(np.float32(np.abs(ref).max()))
    assert planes[True].dtype == torch.float32
    assert np.abs(planes[True].numpy() - ref).max() <= band
    assert np.abs(planes[True].numpy() - planes[False].numpy()).max() <= band


def test_engine_group_evals_in_lockstep_with_the_reference():
    """``CADAEngine(group_evals=True)`` for 6 rounds at M = 6 with
    max_delay 3 (R = 4 < M), each round from the reference's state:
    masks, staleness and slots exact (no margin of these rounds lies in
    the band), θ and ∇ within STATE_TOL of scale, and the plane's ring
    rows fewer than the workers in the late rounds."""
    m, rounds = 6, 6
    params, _, _, _, _ = _ring_problem(m)
    rule = dict(kind="cada2", c=0.3, d_max=3, max_delay=3)
    j_eng = JaxEngine(jax_mlp_loss, JaxFusedAMSGrad(lr=0.01),
                      JaxRule(**rule), m, group_evals=True)
    t_eng = CADAEngine(mlp_loss, FusedAMSGrad(lr=0.01), CommRule(**rule), m,
                       group_evals=True, device="cpu")
    j_step = jax.jit(j_eng.step)
    j_state = j_eng.init(jax.tree.map(jnp.asarray, params))
    rng = np.random.default_rng(3)
    skips = 0
    for k in range(rounds):
        x = rng.normal(size=(m, 5, 20)).astype(np.float32)
        y = rng.integers(0, 3, (m, 5)).astype(np.int32)
        t_state = convert.engine_state_from_numpy(
            jax.tree.map(np.asarray, j_state), "cpu")
        j_state, jm = j_step(j_state, (jnp.asarray(x), jnp.asarray(y)))
        t_next, tm = t_eng.step(t_state, (torch.from_numpy(x),
                                          torch.from_numpy(y)))
        lhs, rhs = np.asarray(jm["lhs"]), float(jm["rhs"])
        assert (np.abs(lhs - rhs) > MARGIN_BAND * rhs).all() or rhs == 0
        assert np.array_equal(tm["upload_mask"].numpy(),
                              np.asarray(jm["upload_mask"]))
        skips += int((~np.asarray(jm["upload_mask"])).sum())
        for key in ("slot", "ring_version"):
            assert np.array_equal(t_next.comm.extras[key].numpy(),
                                  np.asarray(j_state.comm.extras[key]))
        for a, b in ((j_state.params_flat, t_next.params_flat),
                     (j_state.comm.nabla, t_next.comm.nabla)):
            a = np.asarray(a)
            assert np.abs(b.numpy() - a).max() <= STATE_TOL * max(
                np.abs(a).max(), 1e-30)
    assert skips > 0, "the gate never skipped: the slots never differ"


# ------------------------------------------------------------- launcher

def _reference_row_keys(mode, kind, host_pool, target):
    """The key set of the reference's summary row for the same mode, rule
    family and pool, from a cheap logreg run of the JAX sim."""
    params, batches = problem(steps=4)
    _, _, jp, jb = both(params, batches)
    rule = JaxRule(kind=kind, c=1.0, d_max=10, max_delay=50,
                   **({"local_steps": 1} if kind == "local_momentum" else {}))
    res = JS.simulate(
        _jax_sq_loss if kind == "local_momentum" else jax_logreg_loss, rule,
        jp if kind != "local_momentum" else jax.tree.map(
            jnp.asarray, _local_problem(rounds=4, h=1)[0]),
        jb if kind != "local_momentum" else tuple(
            jnp.asarray(b[:, 0]) for b in _local_problem(rounds=4, h=1)[1]),
        n_workers=M, network="wan", mode=mode,
        async_tau=4 if mode == "async" else 0, host_pool=host_pool)
    return set(JS.summarize(res, target))


@pytest.mark.parametrize("case", ["barrier", "async-host-pool",
                                  "adaptive-local-momentum"])
def test_launcher_runtime_sim(case, capsys, tmp_path):
    argv = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
            "--runtime", "sim", "--network", "wan", "--workers", "2",
            "--steps", "3", "--global-batch", "4", "--seq", "16",
            "--target-loss", "5.0", "--metrics-out",
            str(tmp_path / "m.jsonl"), "--trace", str(tmp_path / "t.json")]
    kind, mode, host_pool = "cada2", "barrier", False
    if case == "async-host-pool":
        argv += ["--async-tau", "4", "--host-pool"]
        mode, host_pool = "async", True
    elif case == "adaptive-local-momentum":
        argv += ["--rule", "local_momentum", "--adapt-local-steps",
                 "--local-steps-max", "2", "--global-batch", "8"]
        kind = "local_momentum"
    (row,) = train_cli.main(argv)
    out = capsys.readouterr().out
    assert "[sim] wan/" in out and "simulated s" in out
    assert row["mode"] == mode and row["steps"] == 3
    assert np.isfinite(row["final_loss"])
    assert set(row) == _reference_row_keys(mode, kind, host_pool, 5.0)
    with open(tmp_path / "m.jsonl") as f:
        assert json.loads(f.readline())["uploads"] == row["uploads"]
    with open(tmp_path / "t.json") as f:
        assert validate_chrome_trace(json.load(f)) > 0


def test_launcher_refuses_adaptive_local_steps_without_the_sim():
    with pytest.raises(SystemExit, match="--runtime sim"):
        train_cli.main(["--arch", "stablelm-1.6b", "--smoke", "--device",
                        "cpu", "--rule", "local_momentum",
                        "--adapt-local-steps"])


def test_the_sims_lm_loss_is_the_training_route_without_remat():
    """The launcher's sim loss: ``lm_loss(train=True)`` on the config with
    ``remat`` off gives the values and gradients of the remat config
    (remat changes memory, not values)."""
    cfg = TC.get_smoke_config("stablelm-1.6b")
    params = init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(train_cli.make_token_batches(
        cfg, global_batch=2, seq=16, steps=1)[0]).long()
    out = {}
    for remat in (True, False):
        leaves = [x.detach().clone().requires_grad_()
                  for x in tree_leaves(params)]
        loss = lm_loss(cfg.with_(remat=remat),
                       tree_unflatten(tree_paths(params), leaves),
                       {"tokens": toks}, train=True)[0]
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
