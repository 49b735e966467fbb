"""The port's Algorithm-1 round against the JAX engine, in lockstep.

For each rule (always, lag, cada1, cada2), each model (logreg on
ijcnn1_like, an MLP 784→16→10 on mnist_like) and with and without a
partial-participation mask, 30 rounds run like this: the JAX engine's
round-k state is loaded into the port (``convert.engine_state_from_numpy``),
both engines take the same numpy batch, each takes one ``step``, and the
results are compared. Reloading every round keeps a near-threshold gate
flip from snowballing into two different trajectories.

The JAX side runs as its own tests run it on the CPU: the jitted engine
step, whose kernels take their plain jnp route there.

Contract:
  * Upload masks, staleness, CADA2 slots and ring versions match exactly,
    except for a worker whose JAX-side gate margin |LHS − RHS| is within
    MARGIN_BAND · RHS. Such a flip is counted, the round's float state is
    not compared (the two sides legitimately differ), and at most one
    round in a run may flip.
  * Float state (θ, h, v̂, ∇, worker planes, RHS ring, CADA1's δ̃ and
    snapshot, CADA2's ring, the LHS and the loss) matches to
    |Δ| ≤ STATE_TOL · max|ref| per array. The two frameworks round
    differently: XLA contracts the moment update into an FMA, evaluates
    exp/log/expm1 with its own approximations, and sums the 784-wide MLP
    products in another order. The largest gap this test measures (shown
    with ``pytest -s``) is 2.3e-5 of the array's scale: the CADA1 logreg
    LHS, a norm of a difference of close gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import CADAEngine as JaxEngine
from repro.core.rules import CommRule as JaxRule
from repro.models.small import logreg_loss as jax_logreg_loss
from repro.models.small import mlp_loss as jax_mlp_loss
from repro.optim.fused import FusedAMSGrad as JaxFusedAMSGrad
from repro_torch import convert
from repro_torch.core.engine import CADAEngine
from repro_torch.core.rules import CommRule
from repro_torch.data import (ijcnn1_like, mnist_like, pad_to_matrix,
                              uniform_partition)
from repro_torch.models.small import logreg_loss, mlp_loss
from repro_torch.optim.fused import FusedAMSGrad

torch.set_num_threads(1)

M, BATCH, ROUNDS = 4, 8, 30
MARGIN_BAND = 1e-3
STATE_TOL = 1e-4


def _problem(model, rng):
    if model == "logreg":
        ds = ijcnn1_like(n=512)
        params = {"w": np.zeros((22, 2), np.float32),
                  "b": np.zeros((2,), np.float32)}
        # c chosen so every gated rule both uploads and skips
        return ds.x, ds.y, params, jax_logreg_loss, logreg_loss, 0.3, 0.05
    ds = mnist_like(n=512)
    params = {
        "w1": (rng.normal(size=(784, 16)) / 28.0).astype(np.float32),
        "b1": np.zeros(16, np.float32),
        "w2": (rng.normal(size=(16, 10)) / 4.0).astype(np.float32),
        "b2": np.zeros(10, np.float32),
    }
    # a smaller step keeps the MLP's logits moderate: at lr=0.05 they grow
    # until the softmax gradient loses digits to cancellation in both
    # frameworks alike
    return (ds.x.reshape(ds.n, -1), ds.y, params, jax_mlp_loss, mlp_loss,
            10.0, 0.01)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _float_pairs(j, t, jm, tm):
    """(name, reference, port) float arrays of one round's outputs."""
    pairs = [("params_flat", j.params_flat, t.params_flat),
             ("h", j.opt_state.h, t.opt_state.h),
             ("vhat", j.opt_state.vhat, t.opt_state.vhat),
             ("nabla", j.comm.nabla, t.comm.nabla),
             ("worker_grads", j.comm.worker_grads, t.comm.worker_grads),
             ("diff_hist", j.comm.diff_hist, t.comm.diff_hist),
             ("loss", jm["loss"], tm["loss"]),
             ("rhs", jm["rhs"], tm["rhs"])]
    jl = np.asarray(jm["lhs"])
    if np.isfinite(jl).all():
        pairs.append(("lhs", jl, tm["lhs"]))
    ex_t = t.comm.extras
    for name, v in dict(j.comm.extras).items():
        if name in ("slot", "ring_version"):
            continue
        if isinstance(v, dict):
            pairs += [(f"{name}.{k}", vv, ex_t[name][k])
                      for k, vv in v.items()]
        else:
            pairs.append((name, v, ex_t[name]))
    return pairs


@pytest.mark.parametrize("participation", [False, True],
                         ids=["full", "partial"])
@pytest.mark.parametrize("model", ["logreg", "mlp"])
@pytest.mark.parametrize("kind", ["always", "lag", "cada1", "cada2"])
def test_lockstep_round(kind, model, participation):
    rng = np.random.default_rng(0)
    x, y, params, jax_loss, loss, c, lr = _problem(model, rng)
    mtx = pad_to_matrix(uniform_partition(len(y), M, seed=0))
    hp = dict(kind=kind, c=c, d_max=3, max_delay=5)
    j_eng = JaxEngine(jax_loss, JaxFusedAMSGrad(lr=lr), JaxRule(**hp), M)
    t_eng = CADAEngine(loss, FusedAMSGrad(lr=lr), CommRule(**hp), M,
                       device="cpu")
    j_step = jax.jit(j_eng.step)
    j_state = j_eng.init(jax.tree.map(jnp.asarray, params))

    flip_rounds, uploads, skips, worst = 0, 0, 0, (0.0, "")
    for k in range(ROUNDS):
        ids = mtx[np.arange(M)[:, None],
                  rng.integers(0, mtx.shape[1], (M, BATCH))]
        bx, by = x[ids], y[ids]
        mask = rng.random(M) < 0.7 if participation else None

        t_state = convert.engine_state_from_numpy(
            jax.tree.map(np.asarray, j_state), "cpu")
        assert t_state.step == k
        j_next, jm = j_step(j_state, (jnp.asarray(bx), jnp.asarray(by)),
                            None if mask is None else jnp.asarray(mask))
        t_next, tm = t_eng.step(
            t_state, (torch.from_numpy(bx), torch.from_numpy(by)),
            None if mask is None else torch.from_numpy(mask))
        j = jax.tree.map(np.asarray, j_next)
        jm = jax.tree.map(np.asarray, jm)
        j_state = j_next

        j_up, t_up = jm["upload_mask"], tm["upload_mask"].numpy()
        uploads += int(j_up.sum())
        skips += int((~j_up & (True if mask is None else mask)).sum())
        if not np.array_equal(j_up, t_up):
            margin = np.abs(jm["lhs"] - jm["rhs"])
            flipped = j_up != t_up
            assert (margin[flipped] <= MARGIN_BAND * jm["rhs"]).all(), (
                f"round {k}: upload masks differ outside the margin band: "
                f"jax {j_up}, port {t_up}, lhs {jm['lhs']}, rhs {jm['rhs']}")
            flip_rounds += 1
            continue

        assert t_next.step == k + 1
        assert t_next.opt_state.count == int(j.opt_state.count)
        assert np.array_equal(t_next.comm.staleness.numpy(), j.comm.staleness)
        assert t_next.comm.staleness.dtype == torch.int32
        for key in ("slot", "ring_version"):
            if key in j.comm.extras:
                assert np.array_equal(t_next.comm.extras[key].numpy(),
                                      j.comm.extras[key]), key
        assert int(tm["uploads"]) == int(jm["uploads"])
        assert int(tm["grad_evals"]) == int(jm["grad_evals"])
        for name, a, b in _float_pairs(j, t_next, jm, tm):
            a, b = _np(a), _np(b)
            assert a.shape == b.shape, name
            scale = max(np.abs(a).max(), 1e-30)
            np.testing.assert_allclose(b, a, rtol=0, atol=STATE_TOL * scale,
                                       err_msg=f"{name} at round {k}")
            worst = max(worst, (float(np.abs(b - a).max() / scale), name))

    # the measured gap, shown with `pytest -s`
    print(f"\n{kind}/{model}/{'partial' if participation else 'full'}: "
          f"largest gap {worst[0]:.3g} of scale ({worst[1]}), "
          f"{flip_rounds} in-band flip rounds, {uploads} uploads")
    assert flip_rounds <= 1
    assert uploads > 0
    if kind != "always":
        assert skips > 0, "the gate never skipped: the test is vacuous"


def test_gathered_and_stacked_second_evals_agree():
    """cada2's second evaluation in its gathered (``fuse_evals=False``) and
    stacked (default) forms gives the same round, within STATE_TOL."""
    rng = np.random.default_rng(1)
    x, y, params, _, loss, c, lr = _problem("mlp", rng)
    mtx = pad_to_matrix(uniform_partition(len(y), M, seed=0))
    hp = dict(kind="cada2", c=c, d_max=3, max_delay=5)
    engines = [CADAEngine(loss, FusedAMSGrad(lr=lr), CommRule(**hp), M,
                          fuse_evals=f, device="cpu") for f in (True, False)]
    state = engines[0].init(convert.params_from_numpy(params, "cpu"))
    for _ in range(12):
        ids = mtx[np.arange(M)[:, None],
                  rng.integers(0, mtx.shape[1], (M, BATCH))]
        batch = (torch.from_numpy(x[ids]), torch.from_numpy(y[ids]))
        (s_a, m_a), (s_b, m_b) = (e.step(state, batch) for e in engines)
        assert torch.equal(m_a["upload_mask"], m_b["upload_mask"])
        for a, b in ((s_a.params_flat, s_b.params_flat),
                     (s_a.comm.worker_grads, s_b.comm.worker_grads),
                     (m_a["lhs"], m_b["lhs"])):
            torch.testing.assert_close(
                a, b, rtol=0, atol=STATE_TOL * float(b.abs().max()))
        state = s_a
