"""The port's server optimizer and schedules against the reference's.

``FusedAMSGrad.apply_flat`` is run on both sides from the same numpy state
for several steps, with a constant step size and with a schedule; the JAX
side runs its Pallas kernel in interpret mode. Tolerance as in
test_torch_kernels.py: 2⁻²⁰ · max|ref| per array (one-ULP rounding
differences of the moment update), Σupd² rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import schedules as jax_schedules
from repro.optim.fused import FusedAMSGrad as JaxFusedAMSGrad
from repro_torch.optim import schedules
from repro_torch.optim.fused import FusedAMSGrad

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
