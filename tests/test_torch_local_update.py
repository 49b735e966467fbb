"""The port's delta-payload rules (``local_momentum``, ``fedadam``) against
the JAX engine's, in lockstep, and the local-steps cadence around them.

For each rule, H ∈ {1, 8}, each model (logreg on ijcnn1_like, an MLP
784→16→10 on mnist_like) and three settings (every worker, a
partial-participation mask, an 8-bit wire), ROUNDS rounds run like this:
the JAX engine's round-k state is loaded into the port
(``convert.engine_state_from_numpy``), both engines take the same numpy
(H, M, b, ...) batch (the plain (M, b, ...) form at H = 1), each takes one
``step`` on the rule's prescribed server optimizer (sgd(1.0) for local
momentum, the non-AMSGrad server Adam for FedAdam), and the results are
compared. The JAX side runs as its own tests run it on the CPU: the jitted
engine step.

Contract:
  * Upload masks, staleness, uploads and gradient evaluations (Σ h_w over
    the active workers) match exactly.
  * Float state (θ, the server optimizer's moments, ∇, the worker plane,
    the momenta, the RHS ring and the loss) matches to
    |Δ| ≤ STATE_TOL · max|ref| per array. The two frameworks round the
    gradients differently (XLA's FMA in the momentum and SGD steps, its
    own exp/log, the MLP's 784-wide sums in another order), and H local
    steps compound the gap before the server's step divides small mean
    deltas by Adam's roots. The largest gap measured (printed per case
    with ``pytest -s``) is 4.1e-6 of scale, FedAdam's worker plane on the
    MLP under partial participation.
  * Under an 8-bit wire the uploaded deltas may round to neighbouring
    levels at a few entries; they are counted and checked as in
    ``test_torch_lockstep.py`` (``lockstep_wire.py``), and the columns they
    touch are left out of the server-side arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import CADAEngine as JaxEngine
from repro.core.local_update import LocalUpdateEngine as JaxLocalEngine
from repro.core.rules import CommRule as JaxRule
from repro.models.small import logreg_loss as jax_logreg_loss
from repro.models.small import mlp_loss as jax_mlp_loss
from repro.sim import SimConfig as JaxSimConfig
from repro.sim import SimRuntime as JaxSimRuntime
from repro.sim import network_profile as jax_network_profile
from repro_torch import convert
from repro_torch.core.engine import CADAEngine
from repro_torch.core.local_update import LocalUpdateEngine
from repro_torch.core.rules import LOCAL_RULES, CommRule
from repro_torch.data import (ijcnn1_like, mnist_like, pad_to_matrix,
                              uniform_partition)
from repro_torch.models.small import logreg_loss, mlp_loss
from repro_torch.sim import SimConfig, SimRuntime, network_profile

from lockstep_wire import wire_differences

torch.set_num_threads(1)

M, BATCH, ROUNDS = 4, 6, 5
STATE_TOL = 2e-5
MAX_WIRE_DIFF_SHARE = 1e-3
LOCAL = dict(local_lr=0.05, local_beta=0.9, server_lr=0.01, c=0.6, d_max=3,
             max_delay=5)
SETTINGS = {"full": {}, "partial": {}, "q8": dict(quantize_bits=8)}


def _problem(model, rng):
    if model == "logreg":
        ds = ijcnn1_like(n=512)
        params = {"w": np.zeros((22, 2), np.float32),
                  "b": np.zeros((2,), np.float32)}
        return ds.x, ds.y, params, jax_logreg_loss, logreg_loss
    ds = mnist_like(n=512)
    params = {
        "w1": (rng.normal(size=(784, 16)) / 28.0).astype(np.float32),
        "b1": np.zeros(16, np.float32),
        "w2": (rng.normal(size=(16, 10)) / 4.0).astype(np.float32),
        "b2": np.zeros(10, np.float32),
    }
    return ds.x.reshape(ds.n, -1), ds.y, params, jax_mlp_loss, mlp_loss


def _draw(rng, x, y, mtx, h):
    """One round's (H, M, b, ...) batch as numpy."""
    ids = mtx[np.arange(M)[None, :, None],
              rng.integers(0, mtx.shape[1], (h, M, BATCH))]
    return x[ids], y[ids]


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _opt_arrays(opt_state, layout):
    """name -> packed array of every field of an optimizer state but the
    count (SGD's state is the count alone)."""
    if not hasattr(opt_state, "_fields"):
        return {}
    out = {}
    for f in opt_state._fields:
        if f == "count":
            continue
        v = getattr(opt_state, f)
        out[f] = _np(layout.pack({k: x if torch.is_tensor(x)
                                  else torch.from_numpy(np.array(x))
                                  for k, x in v.items()}))
    return out


def _run_lockstep(kind, h, model, setting, schedule=None):
    rng = np.random.default_rng(0)
    x, y, params, jax_loss, loss = _problem(model, rng)
    mtx = pad_to_matrix(uniform_partition(len(y), M, seed=0))
    hp = dict(kind=kind, local_steps=h, **LOCAL, **SETTINGS[setting])
    j_eng = JaxEngine(jax_loss, None, JaxRule(**hp), M)
    t_eng = CADAEngine(loss, None, CommRule(**hp), M, device="cpu")
    j_step = jax.jit(j_eng.step)
    j_state = j_eng.init(jax.tree.map(jnp.asarray, params))

    worst, wire_diffs, entries = (0.0, ""), 0, 0
    for k in range(ROUNDS):
        bx, by = _draw(rng, x, y, mtx, h)
        if h == 1 and schedule is None:
            bx, by = bx[0], by[0]
        mask = (rng.random(M) < 0.7) if setting == "partial" else None
        j_prev = jax.tree.map(np.asarray, j_state)
        t_state = convert.engine_state_from_numpy(j_prev, "cpu")
        j_state, jm = j_step(
            j_state, (jnp.asarray(bx), jnp.asarray(by)),
            None if mask is None else jnp.asarray(mask),
            None if schedule is None else jnp.asarray(schedule))
        t_next, tm = t_eng.step(
            t_state, (torch.from_numpy(bx), torch.from_numpy(by)),
            None if mask is None else torch.from_numpy(mask),
            None if schedule is None else torch.from_numpy(schedule))
        j = jax.tree.map(np.asarray, j_state)
        jm = jax.tree.map(np.asarray, jm)
        layout = t_eng._layout

        assert t_next.step == k + 1
        assert np.array_equal(tm["upload_mask"].numpy(), jm["upload_mask"])
        assert np.array_equal(t_next.comm.staleness.numpy(),
                              j.comm.staleness)
        assert int(tm["uploads"]) == int(jm["uploads"])
        assert int(tm["grad_evals"]) == int(jm["grad_evals"])
        assert np.isinf(tm["lhs"].numpy()).all() and np.isinf(jm["lhs"]).all()
        np.testing.assert_allclose(float(tm["bytes_up"]),
                                   float(jm["bytes_up"]), rtol=1e-6)

        wg_prev = _np(j_prev.comm.worker_grads)
        flagged, _ = wire_differences(
            t_eng.rule, layout, STATE_TOL, wg_prev, _np(j.comm.worker_grads),
            _np(t_next.comm.worker_grads))
        cols = flagged.any(axis=0)
        wire_diffs += int(flagged.sum())
        entries += int(jm["uploads"]) * layout.n

        pairs = [("params_flat", j.params_flat, t_next.params_flat, "col"),
                 ("nabla", j.comm.nabla, t_next.comm.nabla, "col"),
                 ("worker_grads", j.comm.worker_grads,
                  t_next.comm.worker_grads, "entry"),
                 ("loss", jm["loss"], tm["loss"], None),
                 ("diff_hist", j.comm.diff_hist, t_next.comm.diff_hist,
                  "all")]
        j_opt = _opt_arrays(j.opt_state, layout)
        t_opt = _opt_arrays(t_next.opt_state, layout)
        assert sorted(j_opt) == sorted(t_opt)
        pairs += [(f"opt.{n}", j_opt[n], t_opt[n], "col") for n in j_opt]
        assert sorted(j.comm.extras) == sorted(t_next.comm.extras)
        pairs += [(n, v, t_next.comm.extras[n], None)
                  for n, v in dict(j.comm.extras).items()]
        for name, a, b, where in pairs:
            a, b = _np(a), _np(b)
            assert a.shape == b.shape, name
            keep = (np.broadcast_to(~cols, a.shape) if where == "col"
                    else ~flagged if where == "entry"
                    else np.full(a.shape, not (where == "all"
                                               and cols.any())))
            if not keep.any():
                continue
            scale = max(np.abs(a).max(), 1e-30)
            gap = np.abs(b - a)[keep].max() / scale
            assert gap <= STATE_TOL, f"{name} at round {k}: {gap:.3g}"
            worst = max(worst, (float(gap), name))
    print(f"\n{kind} H={h} {model} {setting}: largest gap {worst[0]:.3g} of "
          f"scale ({worst[1]}), {wire_diffs} wire differences in {entries} "
          "uploaded entries")
    assert wire_diffs <= MAX_WIRE_DIFF_SHARE * entries


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("model", ["logreg", "mlp"])
@pytest.mark.parametrize("h", [1, 8])
@pytest.mark.parametrize("kind", LOCAL_RULES)
def test_delta_rule_lockstep(kind, h, model, setting):
    _run_lockstep(kind, h, model, setting)


@pytest.mark.parametrize("kind", LOCAL_RULES)
def test_per_worker_schedule_is_clipped_in_lockstep(kind):
    """A per-worker schedule outside [1, H] is clipped into it, as the
    reference clips it: the same rounds, and Σ h_w grad evals."""
    _run_lockstep(kind, 4, "logreg", "full",
                  schedule=np.array([0, 3, 9, 2], np.int32))


def _engine_and_batches(kind, h, rounds=4):
    rng = np.random.default_rng(2)
    x, y, params, _, loss = _problem("logreg", rng)
    mtx = pad_to_matrix(uniform_partition(len(y), M, seed=0))
    draws = [_draw(rng, x, y, mtx, h) for _ in range(rounds)]
    batches = tuple(torch.from_numpy(np.stack(t)) for t in zip(*draws))
    rule = CommRule(kind=kind, local_steps=h, **LOCAL)
    eng = CADAEngine(loss, None, rule, M, device="cpu")
    return eng, eng.init(convert.params_from_numpy(params, "cpu")), batches


@pytest.mark.parametrize("kind", LOCAL_RULES)
def test_plain_batch_equals_h1_axis(kind):
    """At H = 1 a delta rule takes the plain (M, b, ...) batch; the
    (1, M, b, ...) form driven by an all-ones schedule gives the same bits."""
    eng, st0, batches = _engine_and_batches(kind, 1)
    st_a, m_a = eng.run(st0, batches, None,
                        torch.ones((4, M), dtype=torch.int32))
    st_b, m_b = eng.run(st0, tuple(b[:, 0] for b in batches))
    assert torch.equal(st_a.params_flat, st_b.params_flat)
    assert torch.equal(st_a.comm.nabla, st_b.comm.nabla)
    assert torch.equal(m_a["loss"], m_b["loss"])


@pytest.mark.parametrize("kind", LOCAL_RULES)
def test_schedule_is_clipped_to_its_bounds(kind):
    """A (steps, M) schedule with counts below 1 and above H runs as the
    schedule clipped into [1, H], bit for bit, and charges Σ h_w evals."""
    eng, st0, batches = _engine_and_batches(kind, 4)
    raw = torch.tensor([[0, 3, 9, 2]] * 4, dtype=torch.int32)
    st_a, m_a = eng.run(st0, batches, None, raw)
    st_b, m_b = eng.run(st0, batches, None, raw.clamp(1, 4))
    assert torch.equal(st_a.params_flat, st_b.params_flat)
    assert m_a["grad_evals"].tolist() == [1 + 3 + 4 + 2] * 4
    assert torch.equal(m_a["loss"], m_b["loss"])


@pytest.mark.parametrize("h", [1, 4])
@pytest.mark.parametrize("kind", LOCAL_RULES)
def test_rules_match_the_standalone_engine(kind, h):
    """The registered rule's trajectory equals the port's standalone
    ``LocalUpdateEngine`` at the same H and batches (within 1e-5 of scale:
    the two associate the mean and the server step differently), with the
    same uploads, grad evals and mean losses; the standalone engine in
    turn equals the reference's."""
    eng, st0, batches = _engine_and_batches(kind, h)
    st, mets = eng.run(st0, batches if h > 1
                       else tuple(b[:, 0] for b in batches))
    seed = LocalUpdateEngine(logreg_loss, M, h, algo=kind, lr=0.05,
                             beta=0.9, server_lr=0.01)
    sst, smets = seed.run(seed.init(st0.params), batches)
    for name in st.params:
        ref = sst.params[name]
        torch.testing.assert_close(st.params[name], ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))
    assert mets["uploads"].tolist() == smets["uploads"].tolist()
    assert mets["grad_evals"].tolist() == smets["grad_evals"].tolist()
    torch.testing.assert_close(mets["loss"], smets["loss"].mean(dim=1),
                               rtol=1e-5, atol=1e-7)

    jseed = JaxLocalEngine(jax_logreg_loss, n_workers=M, h_period=h,
                           algo=kind, lr=0.05, beta=0.9, server_lr=0.01)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in st0.params.items()}
    jst, jmets = jax.jit(jseed.run)(
        jseed.init(jparams), tuple(jnp.asarray(b.numpy()) for b in batches))
    for name in sst.params:
        ref = np.asarray(jst.params[name])
        np.testing.assert_allclose(sst.params[name].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(smets["loss"].numpy(),
                               np.asarray(jmets["loss"]), rtol=1e-5)


def test_local_steps_on_a_gradient_rule_is_refused_as_in_the_reference():
    rng = np.random.default_rng(0)
    x, y, params, jax_loss, loss = _problem("logreg", rng)
    hp = dict(kind="cada2", c=0.6, d_max=3, max_delay=5)
    bx, by = x[:M * BATCH].reshape(M, BATCH, -1), y[:M * BATCH].reshape(
        M, BATCH)
    j_eng = JaxEngine(jax_loss, None, JaxRule(**hp), M)
    with pytest.raises(ValueError) as ref:
        j_eng.step(j_eng.init(jax.tree.map(jnp.asarray, params)),
                   (jnp.asarray(bx), jnp.asarray(by)),
                   local_steps=jnp.ones((M,), jnp.int32))
    t_eng = CADAEngine(loss, None, CommRule(**hp), M, device="cpu")
    with pytest.raises(ValueError) as ours:
        t_eng.step(t_eng.init(convert.params_from_numpy(params, "cpu")),
                   (torch.from_numpy(bx), torch.from_numpy(by)),
                   local_steps=torch.ones((M,), dtype=torch.int32))
    assert str(ours.value) == str(ref.value)


def test_adaptive_local_steps_on_a_bare_engine_is_refused_as_in_the_reference():
    """The reference's ``test_bare_engine_rejects_adaptive_h`` and
    ``test_sim_rejects_delta_async_and_adaptive_cohort``: the bare engine
    refuses adaptive H (it has no clock) and names the port's sim; the sim
    opts in; the sim refuses a delta rule in async mode and adaptive H on
    the cohort plane with the reference's messages."""
    rule_kw = dict(kind="local_momentum", adapt_local_steps=True)
    with pytest.raises(ValueError, match="clock") as ref:
        JaxEngine(jax_logreg_loss, None, JaxRule(**rule_kw), M)
    with pytest.raises(ValueError, match="clock") as ours:
        CADAEngine(logreg_loss, None, CommRule(**rule_kw), M, device="cpu")
    assert "repro_torch.sim" in str(ours.value)
    assert "--runtime sim" in str(ref.value) and "--runtime sim" in str(
        ours.value)
    CADAEngine(logreg_loss, None, CommRule(**rule_kw), M, device="cpu",
               allow_adaptive_local_steps=True)

    cases = ((dict(kind="fedadam", c=0.6, d_max=4, max_delay=10,
                   local_steps=4, local_lr=0.05), dict(mode="async"),
              "barrier-only"),
             (dict(kind="fedadam", adapt_local_steps=True, local_lr=0.05),
              dict(cohort_size=2), "cohort"))
    for rule, cfg, what in cases:
        with pytest.raises(ValueError, match=what) as ref:
            JaxSimRuntime(jax_logreg_loss, JaxRule(**rule), M, JaxSimConfig(
                network=jax_network_profile("wan", M), **cfg))
        with pytest.raises(ValueError, match=what) as ours:
            SimRuntime(logreg_loss, CommRule(**rule), M, SimConfig(
                network=network_profile("wan", M), **cfg), device="cpu")
        assert str(ours.value) == str(ref.value)


def test_prescribed_server_optimizers():
    """With no optimizer given the engine takes the rule's: SGD for local
    momentum (a bare count state), non-AMSGrad Adam for FedAdam."""
    for kind, fields in (("local_momentum", None),
                         ("fedadam", ("count", "h", "v", "vhat"))):
        eng = CADAEngine(logreg_loss, None, CommRule(kind=kind), M,
                         device="cpu")
        st = eng.init({"w": torch.zeros(3, 2), "b": torch.zeros(2)})
        assert getattr(st.opt_state, "_fields", None) == fields
        if kind == "local_momentum":
            assert st.comm.extras["momenta"].shape == (M, 8)
