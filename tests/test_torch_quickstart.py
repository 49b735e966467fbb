"""The quickstart problem run free (no lockstep) in both packages, and the
port's refusal to run quietly on the CPU.

Both packages train the quickstart's label-skewed logistic regression (M=10,
ijcnn1_like, batch 32) for 500 rounds from the same numpy batches: the JAX
package with the quickstart's ``adam(lr=0.01)`` (the paper's AMSGrad form),
the port with ``FusedAMSGrad(lr=0.01)`` (the same math in one kernel).
Free-running trajectories drift apart at near-threshold gate decisions, so
the contract is statistical:
  * CADA2 uploads fewer than distributed Adam, in the port as in JAX;
  * the final loss (mean of the last 20 rounds) of each rule is within
    LOSS_BAND (relative) of the JAX run's;
  * CADA2's upload count is within UPLOAD_BAND (relative) of the JAX run's.
Measured on the CPU: final losses 0.034939 (always) and 0.038338 (cada2) in
both packages, 1e-6 apart relative; 664 cada2 uploads in both. The bands
leave room for a gate flip on another CPU, after which the runs part.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import CADAEngine as JaxEngine
from repro.core.rules import CommRule as JaxRule
from repro.models.small import logreg_loss as jax_logreg_loss
from repro.optim.adam import adam
from repro_torch.core.engine import CADAEngine, resolve_device
from repro_torch.core.rules import CommRule
from repro_torch.data import dirichlet_partition, ijcnn1_like, pad_to_matrix
from repro_torch.models.small import logreg_init, logreg_loss
from repro_torch.optim.fused import FusedAMSGrad

torch.set_num_threads(1)

M, ITERS, BATCH = 10, 500, 32
LOSS_BAND = 0.02
UPLOAD_BAND = 0.10
RULES = {"always": dict(kind="always"),
         "cada2": dict(kind="cada2", c=0.6, d_max=10, max_delay=100)}


@pytest.fixture(scope="module")
def runs():
    ds = ijcnn1_like(n=8000)
    shards = pad_to_matrix(dirichlet_partition(ds.y, m=M, alpha=0.3, seed=0))
    rng = np.random.default_rng(1)
    pos = rng.integers(0, shards.shape[1], (ITERS, M, BATCH))
    ids = np.take_along_axis(shards[None], pos, axis=2)
    bx, by = ds.x[ids], ds.y[ids]
    params = logreg_init(None, ds.x.shape[1], ds.n_classes, device="cpu")
    out = {}
    for name, hp in RULES.items():
        j_eng = JaxEngine(jax_logreg_loss, adam(lr=0.01), JaxRule(**hp), M)
        j_state = j_eng.init({k: jnp.asarray(v.numpy())
                              for k, v in params.items()})
        _, jm = jax.jit(j_eng.run)(j_state, (jnp.asarray(bx),
                                             jnp.asarray(by)))
        t_eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.01),
                           CommRule(**hp), M, device="cpu")
        _, tm = t_eng.run(t_eng.init(params),
                          (torch.from_numpy(bx), torch.from_numpy(by)))
        out[name] = {
            "jax": (float(np.asarray(jm["loss"])[-20:].mean()),
                    int(np.asarray(jm["uploads"]).sum())),
            "port": (float(tm["loss"][-20:].mean()),
                     int(tm["uploads"].sum())),
        }
    return out


def test_cada2_uploads_fewer_than_always(runs):
    assert runs["always"]["port"][1] == ITERS * M
    assert runs["cada2"]["port"][1] < runs["always"]["port"][1]
    assert runs["cada2"]["jax"][1] < runs["always"]["jax"][1]


@pytest.mark.parametrize("rule", sorted(RULES))
def test_final_loss_within_band_of_jax(runs, rule):
    (j_loss, _), (t_loss, _) = runs[rule]["jax"], runs[rule]["port"]
    assert np.isfinite(t_loss)
    assert abs(t_loss - j_loss) <= LOSS_BAND * j_loss, runs[rule]


def test_cada2_upload_count_within_band_of_jax(runs):
    j_up, t_up = runs["cada2"]["jax"][1], runs["cada2"]["port"][1]
    assert abs(t_up - j_up) <= UPLOAD_BAND * j_up, runs["cada2"]


def test_no_silent_cpu():
    """With no CUDA device, the engine and the sampler refuse to start
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CADAEngine(logreg_loss)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CADAEngine(logreg_loss, device="cuda")
    assert CADAEngine(logreg_loss, device="cpu").device.type == "cpu"
