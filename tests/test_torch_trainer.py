"""The port's LM trainer on its own: the JAX package's trainer properties
(``tests/test_trainer_distributed.py``), the port's engine against its
trainer per iteration (as ``tests/test_parity_engine_trainer.py`` pins for
the reference), the hyper-parameters once refused, the CLI and its token
stream, and the example's end-to-end run with its own loss-decrease
check.

Bands: ``cada2`` at c = 0 against ``always`` and the microbatch invariance
keep the reference test's rtol 2e-2, atol 2e-4 on θ after a few steps (c = 0
sums innovations where ``always`` averages fresh gradients; two
microbatches add their fp32 halves). The engine and the trainer compute the
same round with the same ops (the engine vmaps the workers, the trainer
loops over them), so their masks and staleness must match exactly at every
iteration, and θ within ENGINE_TOL of its scale on a raw wire (measured:
1.5e-7 in absolute terms); the 8-bit wire of cinn and laq turns that gap
into whole quantization levels at a few entries, so there only the masks
and staleness are held.
"""
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

from repro.launch.train import make_token_batches as jax_token_batches
import repro_torch.configs as TC
from repro_torch.core.engine import CADAEngine
from repro_torch.core.rules import RULES, CommRule
from repro_torch.distributed.trainer import (
    DistTrainState, TrainHParams, init_train_state, jit_train_step,
    make_train_step, train_state_specs, worker_split)
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as TM
from repro_torch.optim.fused import FusedAMSGrad
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

CFG = TC.get_smoke_config("internlm2-1.8b")
ENGINE_CFG = TC.get_smoke_config("stablelm-1.6b")
ENGINE_TOL = 1e-5


def _batch(rng, cfg=CFG, b=8, s=32):
    return {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s + 1))).long()}


def _steps(kind, n=4, m=4, microbatches=1, c=0.5, seed=0, lr=1e-3):
    hp = TrainHParams(rule=CommRule(kind=kind, c=c, d_max=4, max_delay=10),
                      lr=lr, microbatches=microbatches)
    step = make_train_step(CFG, hp, m)
    st = init_train_state(CFG, hp, m, 42, "cpu")
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(n):
        st, mets = step(st, worker_split(_batch(rng), m))
        outs.append(mets)
    return st, outs


def _params_close(a, b, rtol, atol):
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=rtol, atol=atol)


# ------------------------------------------- the reference's properties

@pytest.mark.parametrize("kind", RULES)
def test_step_runs_and_loss_finite(kind):
    st, outs = _steps(kind, n=3)
    for m in outs:
        assert np.isfinite(float(m["loss"]))
        assert np.isfinite(float(m["dtheta_sq"]))
    assert st.step == 3
    assert isinstance(st, DistTrainState)
    assert (st.comm is None) == (kind == "always")


def test_cada2_c0_equals_always():
    """c = 0 ⇒ every worker uploads ⇒ the trajectory is distributed
    AMSGrad's."""
    st_c, outs = _steps("cada2", n=3, c=0.0)
    st_a, _ = _steps("always", n=3, c=0.0)
    assert all(int(m["uploads"]) == 4 for m in outs)
    _params_close(st_c, st_a, 2e-2, 2e-4)


def test_microbatch_invariance():
    """Gradient accumulation does not change the trajectory (same data)."""
    st1, _ = _steps("always", n=2, microbatches=1)
    st2, _ = _steps("always", n=2, microbatches=2)
    _params_close(st1, st2, 2e-2, 2e-4)


def test_huge_c_skips_everything_after_warmup():
    hp = TrainHParams(rule=CommRule(kind="cada2", c=1e12, d_max=4,
                                    max_delay=100))
    m = 4
    step = make_train_step(CFG, hp, m)
    st = init_train_state(CFG, hp, m, 0, "cpu")
    rng = np.random.default_rng(1)
    st, mets0 = step(st, worker_split(_batch(rng), m))
    assert int(mets0["uploads"]) == m  # staleness init forces round 0
    st, mets1 = step(st, worker_split(_batch(rng), m))
    assert int(mets1["uploads"]) == 0
    assert float(mets1["skip_rate"]) == 1.0


def test_worker_split_shapes():
    for zeros in (np.zeros, torch.zeros):
        b = {"tokens": zeros((8, 33)), "positions": zeros((3, 8, 32))}
        out = worker_split(b, 4)
        assert tuple(out["tokens"].shape) == (4, 2, 33)
        assert tuple(out["positions"].shape) == (4, 3, 2, 32)
    toks = torch.arange(8 * 3).reshape(8, 3)
    assert torch.equal(worker_split({"tokens": toks}, 4)["tokens"][1],
                       toks[2:4])


def test_state_follows_the_hyper_parameters():
    hp = TrainHParams(rule=CommRule(kind="cada2"), moments_dtype="bfloat16",
                      cada_dtype="bfloat16")
    st = init_train_state(CFG, hp, 3, 0, "cpu")
    assert st.h.dtype == st.vhat.dtype == torch.bfloat16
    assert st.h.ndim == 1 and st.h.data_ptr() != st.vhat.data_ptr()
    assert st.comm.worker_grads.shape == (3, st.h.shape[0])
    assert st.comm.nabla.dtype == torch.bfloat16
    assert set(st.comm.extras) == {"ring", "slot", "ring_version"}
    ring = tree_leaves(st.comm.extras["ring"])[0]
    assert ring.shape[0] == 4     # R = min(M, max_delay) + 1


@pytest.mark.parametrize("field,value", [
    ("fsdp", True), ("fsdp_axes", ("data", "pod")),
    ("state_fsdp_axes", ("data",)), ("shard_cada_state", True)])
def test_unported_hyper_parameters_are_refused_by_name(field, value):
    """The hyper-parameters once refused on the pytree plane (the state
    knobs with ``fused=False``, and the pytree plane on the mesh) are
    ported: each builds with ``fused=False``, the mesh-free step ignores
    it (one process holds the whole state, as in the reference), the mesh
    runtime builds with it, and its state specs honour it: the
    parameters cut as on the flat plane, the moments over the state
    axes, ∇ over "data" under ``shard_cada_state``."""
    hp = TrainHParams(**{field: value}, fused=False)
    make_train_step(CFG, hp, 2)
    make_train_step(CFG, TrainHParams(**{field: value}), 2)
    make, specs, m = jit_train_step(CFG, Mesh((1, 1), ("data", "model")), hp)
    assert m == 1 and callable(make) and isinstance(specs.h, dict)
    stub = type("Stub", (), {"shape": {"data": 2, "model": 2}})()
    got = train_state_specs(CFG, stub, hp)
    plain = train_state_specs(CFG, stub, TrainHParams(fused=False))
    assert got.params == train_state_specs(
        CFG, stub, TrainHParams(**{field: value})).params
    changed = {"fsdp": got.params != plain.params,
               "fsdp_axes": got.params == plain.params,
               "state_fsdp_axes": got.h != plain.h,
               "shard_cada_state": got.comm.nabla != plain.comm.nabla}
    assert changed[field], field


# ------------------------------------------------ engine against trainer

@pytest.mark.parametrize("kind", RULES)
def test_engine_and_trainer_identical_per_iteration(kind):
    """The port's engine (vmapped workers, stacked second evaluation) and
    its trainer (a loop over workers) on stablelm's smoke config, M = 2,
    the reference parity test's rule settings: masks and staleness equal
    at every iteration."""
    m, lr = 2, 1e-3
    rule = CommRule(kind=kind, c=20.0, d_max=4, max_delay=10)
    hp = TrainHParams(rule=rule, lr=lr)
    st = init_train_state(ENGINE_CFG, hp, m, 0, "cpu")
    step = make_train_step(ENGINE_CFG, hp, m)
    eng = CADAEngine(
        lambda p, b: TM.lm_loss(ENGINE_CFG, p, {"tokens": b[0]},
                                train=True)[0],
        FusedAMSGrad(lr=lr), rule, m, device="cpu")
    es = eng.init(st.params)
    rng = np.random.default_rng(0)
    uploads = 0
    for i in range(6):
        batch = worker_split(_batch(rng, ENGINE_CFG, b=4), m)
        st, tm = step(st, batch)
        es, em = eng.step(es, (batch["tokens"],))
        assert torch.equal(tm["upload_mask"], em["upload_mask"]), i
        assert torch.equal(tm["staleness"], em["staleness"]), i
        uploads += int(tm["uploads"])
    assert uploads > 0
    if kind not in ("cinn", "laq"):
        for a, b in zip(tree_leaves(st.params), tree_leaves(es.params)):
            torch.testing.assert_close(
                a, b, rtol=0, atol=ENGINE_TOL * float(b.abs().max()))


# ---------------------------------------------------- CLI and example

def test_cli_trains_on_the_cpu(capsys):
    history = train_cli.main(
        ["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu", "--workers",
         "2", "--steps", "3", "--global-batch", "4", "--seq", "16",
         "--log-every", "1", "--rule", "laq"])
    out = capsys.readouterr().out
    assert "loss=" in out and "uploads=" in out and "skip=" in out
    assert len(history) == 3
    assert all(np.isfinite(h["loss"]) for h in history)


def test_token_batches_are_the_reference_stream():
    """``make_token_batches`` (and ``lm_tokens`` under it) give the JAX
    package's tokens, bit for bit."""
    kw = dict(global_batch=4, seq=16, steps=3, seed=5)
    toks = train_cli.make_token_batches(CFG, **kw)
    want = jax_token_batches(CFG, **kw)
    assert toks.shape == (3, 4, 17) and toks.dtype == want.dtype
    assert np.array_equal(toks, want)


def test_example_lowers_the_loss_on_the_cpu(monkeypatch, capsys):
    """``examples/train_lm_cada_torch.py --tiny`` asserts its own loss
    decrease (the mean of the first 10 steps against the last 10)."""
    example = (pathlib.Path(__file__).resolve().parents[1] / "examples"
               / "train_lm_cada_torch.py")
    monkeypatch.setattr(sys, "argv", [str(example), "--tiny", "--device",
                                      "cpu", "--steps", "20"])
    runpy.run_path(str(example), run_name="__main__")
    assert "skipped)" in capsys.readouterr().out
