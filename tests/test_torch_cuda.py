"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (as on a
CPU-only machine). On the card, with no JAX installed there, run:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package.

Tolerances: θ', h', v̂' within 2⁻²⁰ · max|plain| (the kernel rounds each
operation as the plain version does; only the compiler's and PyTorch's
kernels stand between them); Σupd² and the difference-norm rows rtol 1e-5,
the one-operand rows and the scalar ‖a−b‖² rtol 1e-6 (summation order);
run-to-run results bitwise identical. The wire compressors are plain
PyTorch on both devices and must give the same bits on the card as on the
CPU.
"""
import pytest
import torch

import numpy as np

from repro_torch import convert
from repro_torch.core import flat
from repro_torch.core.engine import CADAEngine
from repro_torch.core.rules import CommRule
from repro_torch.kernels import cada_update, ops, ref
from repro_torch.models.small import logreg_init, logreg_loss
from repro_torch.optim.fused import FusedAMSGrad

pytestmark = pytest.mark.cuda

ULP_SCALE = 2.0 ** -20


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("n", [1, 48, 255, 101_776, 300_001])
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_amsgrad_kernel_matches_plain(gen, n, moments):
    theta = torch.randn(n, generator=gen, device="cuda")
    h = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(moments)
    vhat = (0.01 * torch.randn(n, generator=gen, device="cuda")).abs().to(
        moments)
    g = torch.randn(n, generator=gen, device="cuda")
    k = ops.fused_amsgrad_flat(theta, h, vhat, g, 0.01, b1=0.8, b2=0.99,
                               eps=1e-6)
    again = ops.fused_amsgrad_flat(theta, h, vhat, g, 0.01, b1=0.8, b2=0.99,
                                   eps=1e-6)
    p = ref.amsgrad_ref(theta, h, vhat, g, 0.01, b1=0.8, b2=0.99, eps=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    for a, b in zip(k[:3], p[:3]):
        assert a.dtype == b.dtype
        d = (a.float() - b.float()).abs().max()
        assert float(d) <= ULP_SCALE * float(b.float().abs().max())
    torch.testing.assert_close(k[3], p[3], rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", [(1, 8), (10, 48), (10, 101_776),
                                   (3, 1_000_003)])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.float32, torch.bfloat16)])
def test_batched_diff_kernel_matches_plain(gen, shape, dtypes):
    a = torch.randn(shape, generator=gen, device="cuda").to(dtypes[0])
    b = torch.randn(shape, generator=gen, device="cuda").to(dtypes[1])
    k = ops.batched_diff_sq_norm(a, b)
    assert torch.equal(k, ops.batched_diff_sq_norm(a, b))
    torch.testing.assert_close(k, ref.batched_diff_sq_norm_ref(a, b),
                               rtol=1e-5, atol=0)
    if shape[0] > 1:
        assert torch.equal(k[1:], ops.batched_diff_sq_norm(
            a[1:].contiguous(), b[1:].contiguous()))


@pytest.mark.parametrize("shape", [(1, 8), (10, 48), (10, 101_776),
                                   (3, 1_000_003)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_sq_kernel_matches_plain(gen, shape, dtype):
    a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k = ops.batched_sq_norm(a)
    assert k.dtype == torch.float32 and k.shape == (shape[0],)
    assert torch.equal(k, ops.batched_sq_norm(a))
    torch.testing.assert_close(k, ref.batched_sq_norm_ref(a), rtol=1e-6,
                               atol=0)


def test_batched_sq_rows_do_not_depend_on_r(gen):
    """A 3-row call gives the same rows, bit for bit, as the 10-row call."""
    a = torch.randn(10, 101_776, generator=gen, device="cuda")
    full = ops.batched_sq_norm(a)
    assert torch.equal(full[4:7], ops.batched_sq_norm(a[4:7].contiguous()))


@pytest.mark.parametrize("n", [1, 48, 101_776, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_diff_sq_kernel_matches_plain(gen, n, dtype):
    a = torch.randn(n, generator=gen, device="cuda").to(dtype)
    b = torch.randn(n, generator=gen, device="cuda").to(dtype)
    before = cada_update.batched_diff_sq_norm_flat.launches
    k = ops.diff_sq_norm_flat(a, b)
    assert k.dtype == torch.float32 and k.shape == ()
    assert torch.equal(k, ops.diff_sq_norm_flat(a, b))
    torch.testing.assert_close(k, ref.diff_sq_norm_ref(a, b), rtol=1e-6,
                               atol=0)
    # the one-row launch has a count of its own
    assert cada_update.batched_diff_sq_norm_flat.launches == before
    tree = ops.diff_sq_norm({"x": a[: n // 2], "y": a[n // 2:]},
                            {"x": b[: n // 2], "y": b[n // 2:]})
    torch.testing.assert_close(tree, k, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bits", [2, 8, 16])
def test_wire_compressors_same_bits_on_card_and_cpu(gen, bits):
    """The b-bit quantizer, top-k sparsifier and the sparse wire round trip
    on the paper MLP's layout (M = 10): the card's results equal the CPU's
    bit for bit."""
    params = {"w1": torch.zeros(784, 128), "b1": torch.zeros(128),
              "w2": torch.zeros(128, 10), "b2": torch.zeros(10)}
    layout = flat.layout_of(params)
    x = torch.randn(10, layout.n_flat, generator=gen, device="cuda")
    q = flat.per_worker_quantize_dequantize_flat(layout, x, bits)
    want = flat.per_worker_quantize_dequantize_flat(layout, x.cpu(), bits)
    assert torch.equal(q.cpu().view(torch.int32), want.view(torch.int32))
    sp = flat.per_worker_topk_sparsify_flat(layout, x, 0.1)
    assert torch.equal(sp.cpu().view(torch.int32),
                       flat.per_worker_topk_sparsify_flat(
                           layout, x.cpu(), 0.1).view(torch.int32))
    sp[:, layout.n:] = 0.0
    vals, idx = flat.per_worker_topk_extract_flat(layout, sp, 0.1)
    back = flat.sparse_rows_to_dense(idx, vals, layout.n_flat)
    assert torch.equal(back.view(torch.int32), sp.view(torch.int32))


def test_wrappers_count_launches_and_check_operands(gen):
    x = torch.randn(64, generator=gen, device="cuda")
    before = cada_update.fused_amsgrad_flat.launches
    ops.fused_amsgrad_flat(x, x, x.abs(), x, 0.1)
    assert cada_update.fused_amsgrad_flat.launches == before + 1
    ops.fused_amsgrad_flat(x, x, x.abs(), x, 0.1, impl="plain")
    assert cada_update.fused_amsgrad_flat.launches == before + 1
    with pytest.raises(NotImplementedError):
        ops.fused_amsgrad_flat(x.bfloat16(), x, x, x, 0.1)
    with pytest.raises(ValueError):
        ops.batched_diff_sq_norm(x[None], x[None, :32])
    with pytest.raises(ValueError):
        ops.batched_diff_sq_norm(x.view(8, 8).t(), x.view(8, 8))


def test_engine_defaults_to_the_card_and_launches_each_round(gen):
    eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.01),
                     CommRule(kind="cada2", max_delay=5), 4)
    assert eng.device.type == "cuda"
    state = eng.init(logreg_init(None, 6, 2))
    x = torch.randn(3, 4, 5, 6, generator=gen, device="cuda")
    y = torch.randint(0, 2, (3, 4, 5), generator=gen, device="cuda")
    before = (cada_update.fused_amsgrad_flat.launches,
              cada_update.batched_diff_sq_norm_flat.launches)
    state, metrics = eng.run(state, (x, y))
    assert (cada_update.fused_amsgrad_flat.launches,
            cada_update.batched_diff_sq_norm_flat.launches) == (
        before[0] + 3, before[1] + 3)
    assert state.params_flat.is_cuda and metrics["loss"].shape == (3,)


def test_laq_engine_launches_one_norm_and_one_step_per_round(gen):
    """laq's gate is the one-operand norm: one batched_sq launch and one
    AMSGrad launch per round, and no difference norm."""
    eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.01),
                     CommRule(kind="laq", max_delay=5), 4)
    state = eng.init(logreg_init(None, 6, 2))
    x = torch.randn(3, 4, 5, 6, generator=gen, device="cuda")
    y = torch.randint(0, 2, (3, 4, 5), generator=gen, device="cuda")
    counters = (cada_update.fused_amsgrad_flat,
                cada_update.batched_sq_norm_flat,
                cada_update.batched_diff_sq_norm_flat,
                cada_update.diff_sq_norm_flat)
    before = [f.launches for f in counters]
    state, metrics = eng.run(state, (x, y))
    assert [f.launches - b for f, b in zip(counters, before)] == [3, 3, 0, 0]
    assert state.comm.extras["residual"].is_cuda
    assert bool(torch.isfinite(state.params_flat).all())


def _numpy(state):
    """Every tensor of a port state as a numpy array: the form
    ``convert.engine_state_from_numpy`` reads."""
    if isinstance(state, torch.Tensor):
        return state.cpu().numpy()
    if isinstance(state, dict):
        return {k: _numpy(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_numpy(v) for v in state))
    return state


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def test_converted_state_defaults_to_the_card(gen):
    """``engine_state_from_numpy`` with no device lands on the card, and a
    card engine steps it through the kernels."""
    eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.01),
                     CommRule(kind="cada2", max_delay=5), 4)
    got = convert.engine_state_from_numpy(
        _numpy(eng.init(logreg_init(None, 6, 2))))
    assert got.params_flat.device == eng.device
    assert got.comm.worker_grads.is_cuda and got.opt_state.h.is_cuda
    assert all(t.is_cuda for t in _leaves(got.comm.extras))
    assert convert.tensor_from_numpy(np.ones(3)).is_cuda
    x = torch.randn(4, 5, 6, generator=gen, device="cuda")
    y = torch.randint(0, 2, (4, 5), generator=gen, device="cuda")
    before = cada_update.fused_amsgrad_flat.launches
    eng.step(got, (x, y))
    assert cada_update.fused_amsgrad_flat.launches == before + 1
