"""The port's server optimizers and schedules against the reference's.

``FusedAMSGrad.apply_flat`` is run on both sides from the same numpy state
for several steps, with a constant step size and with a schedule; the JAX
side runs its Pallas kernel in interpret mode. The protocol optimizers
(``sgd``, ``momentum``, ``adam``/``amsgrad``, ``chain_weight_decay``,
``as_optimizer``) run four steps on both sides from the same dict of numpy
arrays, each step restarted from the reference's state. Tolerance as in
test_torch_kernels.py: 2⁻²⁰ · max|ref| per array (one-ULP rounding
differences of the moment update, which XLA contracts into an FMA), Σupd²
rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adam import adam as jax_adam
from repro.optim.adam import amsgrad as jax_amsgrad
from repro.optim import base as jax_base
from repro.optim import fused as jax_fused
from repro.optim import schedules as jax_schedules
from repro.optim.fused import FusedAMSGrad as JaxFusedAMSGrad
from repro.optim.sgd import momentum as jax_momentum
from repro.optim.sgd import sgd as jax_sgd
from repro_torch import convert
from repro_torch.optim import base, fused, schedules
from repro_torch.optim.adam import adam, amsgrad
from repro_torch.optim.fused import FusedAMSGrad
from repro_torch.optim.sgd import momentum, sgd

torch.set_num_threads(1)

SCHEDULES = [
    ("constant", (0.01,)),
    ("inv_sqrt_horizon", (0.3, 400)),
    ("pl_schedule", (2.0, 5.0)),
    ("cosine", (0.1, 50, 10, 0.01)),
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[s[0] for s in
                                                       SCHEDULES])
def test_schedules_match_reference(name, args):
    ours = getattr(schedules, name)(*args)
    ref = getattr(jax_schedules, name)(*args)
    for step in (0, 1, 5, 9, 10, 11, 37, 50, 80):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(ours(step), want, rtol=1e-6)


@pytest.mark.parametrize("lr", [0.05, schedules.pl_schedule(2.0, 5.0)],
                         ids=["constant", "schedule"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_flat_matches_reference(rng, lr, moment_dtype):
    n = 1000
    tdt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    jax_lr = (lr if not callable(lr)
              else jax_schedules.pl_schedule(2.0, 5.0))
    ours, ref = FusedAMSGrad(lr=lr), JaxFusedAMSGrad(lr=jax_lr)
    theta = rng.normal(size=n).astype(np.float32)
    t_state = ours.init_flat(n, tdt, device="cpu")
    j_state = ref.init_flat(n, jdt)
    t_theta, j_theta = torch.from_numpy(theta), jnp.asarray(theta)
    for _ in range(4):
        g = rng.normal(size=n).astype(np.float32)
        t_theta, t_state, t_sq = ours.apply_flat(t_theta, t_state,
                                                 torch.from_numpy(g))
        j_theta, j_state, j_sq = ref.apply_flat(j_theta, j_state,
                                                jnp.asarray(g),
                                                interpret=True)
        assert t_state.count == int(j_state.count)
        assert t_state.h.dtype == tdt and t_state.vhat.dtype == tdt
        jh, jv = (np.array(j_state.h, np.float32),
                  np.array(j_state.vhat, np.float32))
        jt = np.asarray(j_theta)
        same = np.ones(n, bool)
        for a, b in ((t_state.h, jh), (t_state.vhat, jv)):
            a = a.float().numpy()
            if moment_dtype == "bfloat16":
                # a one-ULP fp32 gap may flip a bf16 rounding (≤ 0.1%)
                np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0)
                assert (a != b).mean() <= 1e-3
                same &= a == b
            else:
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=2.0 ** -20 * np.abs(b).max())
        np.testing.assert_allclose(t_theta.numpy()[same], jt[same], rtol=0,
                                   atol=2.0 ** -20 * np.abs(jt).max())
        if same.all():
            np.testing.assert_allclose(float(t_sq), float(j_sq), rtol=1e-5)
        # the next step starts both sides from the reference state
        t_theta = torch.from_numpy(np.array(jt))
        t_state = t_state._replace(h=torch.from_numpy(jh).to(tdt),
                                   vhat=torch.from_numpy(jv).to(tdt))


PROTOCOL = {   # name: (port's, reference's)
    "sgd": (sgd(0.05), jax_sgd(0.05)),
    "sgd-schedule": (sgd(schedules.pl_schedule(2.0, 5.0)),
                     jax_sgd(jax_schedules.pl_schedule(2.0, 5.0))),
    "momentum": (momentum(0.01, beta=0.9), jax_momentum(0.01, beta=0.9)),
    "momentum-nesterov": (momentum(0.01, beta=0.8, nesterov=True),
                          jax_momentum(0.01, beta=0.8, nesterov=True)),
}
ADAM = [dict(amsgrad=a, bias_correction=b, eps_inside_sqrt=e)
        for a in (True, False) for b in (False, True) for e in (True, False)]


def _tree(rng):
    return {"w": rng.normal(size=(7, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}


def _close(got, want, what, scale=None):
    """|Δ| ≤ 2⁻²⁰ · ``scale`` (default max|want|)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -20 * max(scale, 1e-30),
                               err_msg=what)


def _run_protocol(ours, ref, rng, steps=4):
    """``steps`` updates on both sides; each starts the port from the
    reference's state. Compares updates, new params and the state."""
    params = _tree(rng)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = ref.init(j_params)
    for _ in range(steps):
        grads = _tree(rng)
        t_state = convert.opt_state_from_numpy(
            jax.tree.map(np.asarray, j_state), "cpu")
        t_params = convert.params_from_numpy(
            jax.tree.map(np.asarray, j_params), "cpu")
        j_upd, j_state = ref.update(jax.tree.map(jnp.asarray, grads),
                                    j_state, j_params)
        t_upd, t_state = ours.update(convert.params_from_numpy(grads, "cpu"),
                                     t_state, t_params)
        j_params = jax_base.apply_updates(j_params, j_upd)
        t_params = base.apply_updates(t_params, t_upd)
        for k in sorted(params):
            _close(t_upd[k], j_upd[k], f"update {k}")
            _close(t_params[k], j_params[k], f"params {k}")
        yield t_state, jax.tree.map(np.asarray, j_state)


@pytest.mark.parametrize("name", sorted(PROTOCOL))
def test_sgd_and_momentum_match_reference(rng, name):
    ours, ref = PROTOCOL[name]
    for t_state, j_state in _run_protocol(ours, ref, rng):
        if name.startswith("sgd"):
            assert t_state == int(j_state)
        else:
            assert t_state.count == int(j_state.count)
            for k in ("w", "b"):
                _close(t_state.momentum[k], j_state.momentum[k], k)


@pytest.mark.parametrize("kw", ADAM, ids=lambda kw: "-".join(
    f"{k}={int(v)}" for k, v in kw.items()))
def test_adam_matches_reference(rng, kw):
    lr = 0.01
    ours, ref = adam(lr, **kw), jax_adam(lr, **kw)
    for t_state, j_state in _run_protocol(ours, ref, rng):
        assert t_state.count == int(j_state.count)
        for field in ("h", "v", "vhat"):
            for k in ("w", "b"):
                _close(getattr(t_state, field)[k],
                       getattr(j_state, field)[k], f"{field}.{k}")


def test_amsgrad_alias_and_weight_decay_match_reference(rng):
    ours = base.chain_weight_decay(amsgrad(0.01, b1=0.8), 0.1)
    ref = jax_base.chain_weight_decay(jax_amsgrad(0.01, b1=0.8), 0.1)
    for t_state, j_state in _run_protocol(ours, ref, rng):
        _close(t_state.vhat["w"], j_state.vhat["w"], "vhat")
    assert base.chain_weight_decay(ours, 0.0) is ours


def test_as_optimizer_matches_reference(rng):
    """The fused step through the protocol adapter: the same updates as
    the reference's adapter (whose state is per leaf; the port's covers the
    packed parameters, so only the updates and parameters are compared).
    The adapter's update is θ' − θ, so a one-ULP gap in θ' is a gap of one
    ULP of θ in the update: updates are held at the parameters' scale."""
    ours = fused.as_optimizer(FusedAMSGrad(lr=0.01))
    ref = jax_fused.as_optimizer(JaxFusedAMSGrad(lr=0.01))
    params = _tree(rng)
    t_params = convert.params_from_numpy(params, "cpu")
    j_params = jax.tree.map(jnp.asarray, params)
    t_state, j_state = ours.init(t_params), ref.init(j_params)
    for _ in range(3):
        grads = _tree(rng)
        t_upd, t_state = ours.update(convert.params_from_numpy(grads, "cpu"),
                                     t_state, t_params)
        j_upd, j_state = ref.update(jax.tree.map(jnp.asarray, grads),
                                    j_state, j_params)
        t_params = base.apply_updates(t_params, t_upd)
        j_params = jax_base.apply_updates(j_params, j_upd)
        for k in sorted(params):
            _close(t_upd[k], j_upd[k], f"update {k}",
                   scale=np.abs(np.asarray(j_params[k])).max())
            _close(t_params[k], j_params[k], f"params {k}")
    assert t_state.count == int(j_state.count) == 3
