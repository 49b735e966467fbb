"""The port's entry points run on the card unless the caller asks for the
CPU, and the engine refuses a state or a batch that lies elsewhere than it.

Without a CUDA device every entry point that takes ``device`` raises when
given none, and ``CADAEngine.step`` raises on a state or batch on another
device (here ``meta``) instead of running the round there.
"""
import numpy as np
import pytest
import torch

from repro_torch import convert
import repro_torch.configs as TC
from repro_torch.core.engine import CADAEngine, make_sampler
from repro_torch.core.rules import CommRule
from repro_torch.distributed.trainer import TrainHParams, init_train_state
from repro_torch.launch import train as train_cli
from repro_torch.models.small import logreg_init, logreg_loss, mlp_init
from repro_torch.optim.fused import FusedAMSGrad

torch.set_num_threads(1)


def numpy_state(state):
    """A port ``EngineState`` with every tensor as a numpy array: the form
    ``convert.engine_state_from_numpy`` reads."""
    if isinstance(state, torch.Tensor):
        return state.numpy()
    if isinstance(state, dict):
        return {k: numpy_state(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(numpy_state(v) for v in state))
    return state


def _engine(kind="cada2"):
    return CADAEngine(logreg_loss, FusedAMSGrad(lr=0.01),
                      CommRule(kind=kind, max_delay=5), 4, device="cpu")


def _batch(device="cpu"):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 5, 6, generator=gen)
    y = torch.randint(0, 2, (4, 5), generator=gen)
    return x.to(device), y.to(device)


ENTRY_POINTS = {
    "tensor_from_numpy": lambda: convert.tensor_from_numpy(np.ones(3)),
    "params_from_numpy": lambda: convert.params_from_numpy(
        {"w": np.ones((2, 2))}),
    "engine_state_from_numpy": lambda: convert.engine_state_from_numpy(
        numpy_state(_engine().init(logreg_init(None, 6, 2, device="cpu")))),
    "logreg_init": lambda: logreg_init(None, 6, 2),
    "mlp_init": lambda: mlp_init(torch.Generator().manual_seed(0), 6, 4, 2),
    "init_flat": lambda: FusedAMSGrad(lr=0.1).init_flat(8),
    "make_sampler": lambda: make_sampler(
        np.ones((8, 3), np.float32), np.zeros(8, np.int32),
        np.arange(8).reshape(2, 4), 2),
    "init_train_state": lambda: init_train_state(
        TC.get_smoke_config("stablelm-1.6b"), TrainHParams(), 2, 0),
    "train_state_from_numpy": lambda: convert.train_state_from_numpy(
        numpy_state(init_train_state(TC.get_smoke_config("stablelm-1.6b"),
                                     TrainHParams(), 2, 0, "cpu"))),
    "launch.train": lambda: train_cli.main(
        ["--arch", "stablelm-1.6b", "--smoke", "--steps", "1"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_refuses_the_cpu_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("where", ["state", "batch"])
def test_step_refuses_a_state_or_batch_on_another_device(where):
    eng = _engine()
    state = eng.init(logreg_init(None, 6, 2, device="cpu"))
    batch = _batch()
    if where == "state":
        state = state._replace(params_flat=state.params_flat.to("meta"))
    else:
        batch = _batch("meta")
    with pytest.raises(ValueError, match="lies on meta"):
        eng.step(state, batch)
