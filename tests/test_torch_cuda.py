"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (as on a
CPU-only machine). On the card, with no JAX installed there, run:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package.

Tolerances: θ', h', v̂' bit-equal to the plain version for θ and g in fp32
or bf16 and moments in fp32 or bf16 (the kernel rounds each operation as
the plain version does, in its order); Σupd² and the difference-norm rows
rtol 1e-5,
the one-operand rows and the scalar ‖a−b‖² rtol 1e-6 (summation order);
run-to-run results bitwise identical. Eq. (3)'s row mean is bit-equal to
its plain version (the rows added in the same order from +0.0, one rounded
add each, then one multiply), with its zero rows dropped too. The wire
compressors are plain
PyTorch on both devices and must give the same bits on the card as on the
CPU. The selective scan: within 1e-5 of each array's scale, max |plain|
(fp32 on both sides; y_t's N-sum runs in another order, and its rounding
scales with the terms summed, not with y_t, which can cancel to near 0).
fp32 flash attention within 1e-5 of max(1, |plain|) per element (sums
over hd and over keys in other orders); bf16 flash attention (the
tensor-core kernel) within 2⁻⁸ · max(1, |plain|) per element, or else a
single rounding flip: within one bf16 ULP of the plain result computed in
fp32 from the same bf16 inputs (above |o| = 1 a flip exceeds 2⁻⁸ of |o|).
"""
import pytest
import torch

import numpy as np

from repro_torch import convert
from repro_torch.core import flat
from repro_torch.core.engine import CADAEngine
from repro_torch.core.rules import CommRule
from repro_torch import configs as TC
from repro_torch.distributed.trainer import (TrainHParams, init_train_state,
                                             make_train_step, worker_split)
from repro_torch.kernels import cada_update, ops, ref, ssm_scan
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import frontends as tfront
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.small import logreg_init, logreg_loss
from repro_torch.optim.fused import FusedAMSGrad

pytestmark = pytest.mark.cuda

@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _amsgrad_operands(gen, n, theta_dtype, moments, grad_dtype, offset=0):
    """θ, h, v̂, g of length n; with ``offset`` > 0 each is a contiguous
    view that starts ``offset`` elements into a larger buffer."""
    def draw(scale, dtype, nonneg=False):
        x = scale * torch.randn(n + offset, generator=gen, device="cuda")
        return (x.abs() if nonneg else x).to(dtype)[offset:]
    return (draw(1.0, theta_dtype), draw(0.1, moments),
            draw(0.01, moments, nonneg=True), draw(1.0, grad_dtype))


_F32_BF16 = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("n", [1, 48, 255, 101_776, 300_001])
@pytest.mark.parametrize("moments", _F32_BF16)
@pytest.mark.parametrize("theta_dtype", _F32_BF16)
@pytest.mark.parametrize("grad_dtype", _F32_BF16)
def test_amsgrad_kernel_matches_plain(gen, n, moments, theta_dtype,
                                      grad_dtype):
    theta, h, vhat, g = _amsgrad_operands(gen, n, theta_dtype, moments,
                                          grad_dtype)
    before = cada_update.fused_amsgrad_flat.launches
    k = ops.fused_amsgrad_flat(theta, h, vhat, g, 0.01, b1=0.8, b2=0.99,
                               eps=1e-6)
    assert cada_update.fused_amsgrad_flat.launches == before + 1
    again = ops.fused_amsgrad_flat(theta, h, vhat, g, 0.01, b1=0.8, b2=0.99,
                                   eps=1e-6)
    p = ref.amsgrad_ref(theta, h, vhat, g, 0.01, b1=0.8, b2=0.99, eps=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    for a, b in zip(k[:3], p[:3]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    torch.testing.assert_close(k[3], p[3], rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [48, 101_776, 300_001])
@pytest.mark.parametrize("moments", _F32_BF16)
@pytest.mark.parametrize("theta_dtype", _F32_BF16)
def test_amsgrad_kernel_at_an_unaligned_offset(gen, n, moments, theta_dtype):
    """Views one element into their buffers (no operand on 16 bytes: the
    scalar loads) give the plain version's θ', h', v̂' bit for bit, and
    the same Σupd², bit for bit, as aligned copies (the vector loads):
    the split of the elements depends on n alone."""
    ops_ = _amsgrad_operands(gen, n, theta_dtype, moments, torch.bfloat16,
                             offset=1)
    assert not cada_update.vector_ok(*ops_)
    copies = tuple(t.clone() for t in ops_)
    assert cada_update.vector_ok(*copies)
    k = ops.fused_amsgrad_flat(*ops_, 0.01)
    p = ref.amsgrad_ref(*ops_, 0.01)
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a, b)
    aligned = ops.fused_amsgrad_flat(*copies, 0.01)
    assert all(torch.equal(a, b) for a, b in zip(k, aligned))
    torch.testing.assert_close(k[3], p[3], rtol=1e-5, atol=0)


def test_fused_cada_update_on_a_pytree_matches_plain(gen):
    """The pytree entry (``ops.fused_cada_update``: the leaves packed into
    one fp32 buffer padded to a multiple of 1024) launches the AMSGrad
    kernel once and gives its plain route's θ', h', v̂' bit for bit, leaf
    for leaf (a bf16 leaf included), and its Σupd² within rtol 1e-5."""
    def tree(scale, nonneg=False):
        out = {}
        for name, shape in (("a", (37, 5)), ("b", (1031,)),
                            ("c", (3, 3, 3)), ("d", ())):
            x = scale * torch.randn(shape, generator=gen, device="cuda")
            out[name] = x.abs() if nonneg else x
        return out
    params = tree(1.0)
    params["b"] = params["b"].to(torch.bfloat16)
    h, vhat, grads = tree(0.1), tree(0.01, nonneg=True), tree(1.0)
    before = cada_update.fused_amsgrad_flat.launches
    k = ops.fused_cada_update(params, h, vhat, grads, 0.01)
    assert cada_update.fused_amsgrad_flat.launches == before + 1
    p = ops.fused_cada_update(params, h, vhat, grads, 0.01, impl="plain")
    assert cada_update.fused_amsgrad_flat.launches == before + 1
    for got, want in zip(k[:3], p[:3]):
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].shape == want[name].shape, name
            assert torch.equal(got[name], want[name]), name
    assert k[0]["b"].dtype == torch.bfloat16
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


@pytest.mark.parametrize("n", [48, 101_776, 101_777, 1_000_003])
@pytest.mark.parametrize("dtype", _F32_BF16)
def test_row_norms_do_not_depend_on_r_or_alignment(gen, n, dtype):
    """Each row of an (R, n) plane gives, bit for bit, what it gives alone
    as a (1, n) plane, for both norms: with n odd the plane's rows are not
    on 16 bytes (scalar loads) while each row alone is (vector loads)."""
    a = torch.randn(10, n, generator=gen, device="cuda").to(dtype)
    b = torch.randn(10, n, generator=gen, device="cuda").to(dtype)
    assert cada_update.rows_vector_ok(a) == (n * a.element_size() % 16 == 0)
    sq, diff = ops.batched_sq_norm(a), ops.batched_diff_sq_norm(a, b)
    for r in (0, 3, 9):
        one_a, one_b = a[r:r + 1].clone(), b[r:r + 1].clone()
        assert cada_update.rows_vector_ok(one_a, one_b)
        assert torch.equal(sq[r:r + 1], ops.batched_sq_norm(one_a))
        assert torch.equal(diff[r:r + 1],
                           ops.batched_diff_sq_norm(one_a, one_b))
    torch.testing.assert_close(sq, ref.batched_sq_norm_ref(a), rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(diff, ref.batched_diff_sq_norm_ref(a, b),
                               rtol=1e-5, atol=0)


def _kernels_per_call(fn, calls=5):
    """Names of the CUDA kernels that ``calls`` calls of ``fn`` launched,
    from the profiler, one list entry per kernel launch (the profiler may
    miss a launch at its start, never add one)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):    # a window that recorded nothing says nothing
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


@pytest.mark.parametrize("which", ["amsgrad", "amsgrad_bf16", "batched_sq",
                                   "batched_diff_sq", "diff_sq"])
def test_cada_kernels_launch_once_per_call(gen, which):
    """Each call is one kernel launch: the last block adds the partials
    (no second pass), and the workspace is not zeroed per call."""
    x = torch.randn(10, 101_776, generator=gen, device="cuda")
    y, vh, t16 = x * 2, x[2].abs(), x[0].bfloat16()
    fn = {"amsgrad": lambda: ops.fused_amsgrad_flat(x[0], x[1], vh, x[3],
                                                    0.01),
          "amsgrad_bf16": lambda: ops.fused_amsgrad_flat(t16, x[1], vh, t16,
                                                         0.01),
          "batched_sq": lambda: ops.batched_sq_norm(x),
          "batched_diff_sq": lambda: ops.batched_diff_sq_norm(x, y),
          "diff_sq": lambda: ops.diff_sq_norm_flat(x[0], x[1])}[which]
    kernel = "amsgrad_kernel" if which.startswith("amsgrad") else \
        "row_sq_kernel"
    names = _kernels_per_call(fn)
    assert 1 <= len(names) <= 5 and all(kernel in nm for nm in names), names


def test_workspace_is_per_stream_and_reused(gen):
    """Two streams running the kernels at once each get their own
    counters, and their results equal the default stream's; a stream's
    workspace is allocated once and reused."""
    a = torch.randn(10, 101_776, generator=gen, device="cuda")
    theta, h, vhat, g = a[0], a[1], a[2].abs(), a[3]
    want_sq = ops.batched_sq_norm(a)
    want_step = ops.fused_amsgrad_flat(theta, h, vhat, g, 0.01)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = {}
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            got[s] = [(ops.batched_sq_norm(a),
                       ops.fused_amsgrad_flat(theta, h, vhat, g, 0.01))
                      for _ in range(20)]
    torch.cuda.synchronize()
    for s in streams:
        for sq, step in got[s]:
            assert torch.equal(sq, want_sq)
            assert all(torch.equal(x, y) for x, y in zip(step, want_step))
    keys = {(a.device.index, s.cuda_stream) for s in streams}
    assert keys <= set(cada_update._WORKSPACES)
    bufs = {id(cada_update._WORKSPACES[k].buf) for k in keys}
    assert len(bufs) == 2
    before = {k: cada_update._WORKSPACES[k].buf.data_ptr() for k in keys}
    with torch.cuda.stream(streams[0]):
        ops.batched_sq_norm(a)
    assert {k: cada_update._WORKSPACES[k].buf.data_ptr()
            for k in keys} == before


def _eq3_equal(plane, m_total):
    got = cada_update.eq3_row_mean_flat(plane, m_total)
    want = ref.eq3_row_mean_ref(plane, m_total)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got


@pytest.mark.parametrize("shape", [(10, 101_776), (1, 101_776), (10, 48),
                                   (10, 101_777), (3, 1), (2, 1_000_003),
                                   (37, 4_099)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eq3_row_mean_kernel_matches_plain_bit_for_bit(gen, shape, dtype):
    plane = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    _eq3_equal(plane, shape[0])
    _eq3_equal(plane, 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eq3_row_mean_kernel_on_an_unaligned_view(gen, dtype):
    """A contiguous view that starts off 16 bytes takes the scalar loads and
    still gives the plain version's bits, and the aligned copy's."""
    buf = torch.randn(10 * 101_776 + 1, generator=gen,
                      device="cuda").to(dtype)
    plane = buf[1:].view(10, 101_776)
    assert not cada_update.vector_ok(plane)
    got = _eq3_equal(plane, 10)
    assert torch.equal(got, cada_update.eq3_row_mean_flat(plane.clone(), 10))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eq3_row_mean_kernel_drops_zero_rows_exactly(gen, dtype):
    """A masked plane (zero rows) and its nonzero rows alone give the same
    bits: the contract the cohort plane rests on."""
    plane = torch.randn(10, 101_776, generator=gen, device="cuda")
    plane[[1, 4, 5, 9]] = 0.0
    plane = plane.to(dtype)
    kept = plane[[0, 2, 3, 6, 7, 8]].contiguous()
    full = _eq3_equal(plane, 10)
    assert torch.equal(full, _eq3_equal(kept, 10))


def test_eq3_row_mean_kernel_launches_once_per_call(gen):
    plane = torch.randn(10, 101_776, generator=gen, device="cuda")
    names = _kernels_per_call(lambda: ops.eq3_row_mean(plane, 10))
    assert 1 <= len(names) <= 5 and all("row_mean_kernel" in nm
                                        for nm in names), names
    before = cada_update.eq3_row_mean_flat.launches
    ops.eq3_row_mean(plane, 10)
    ops.eq3_row_mean(plane, 10, impl="plain")
    assert cada_update.eq3_row_mean_flat.launches == before + 1
    with pytest.raises(ValueError):
        ops.eq3_row_mean(plane.double(), 10)
    with pytest.raises(ValueError):
        ops.eq3_row_mean(plane.t(), 10)


@pytest.mark.parametrize("kind", ["local_momentum", "fedadam"])
def test_delta_rule_engine_on_the_card(gen, kind):
    """The engine with a delta-payload rule on the card: the prescribed
    protocol server (no AMSGrad launch), eq. (3)'s kernel once per round
    and, for local momentum, once more for the momenta; no LHS norm; and
    the kernels' state within 1e-5 of scale of ``impl="plain"``'s (the
    same masks)."""
    rule = CommRule(kind=kind, local_steps=3, local_lr=0.05, max_delay=5)
    eng = CADAEngine(logreg_loss, None, rule, 4)
    state = eng.init(logreg_init(None, 6, 2))
    x = torch.randn(2, 3, 4, 5, 6, generator=gen, device="cuda")
    y = torch.randint(0, 2, (2, 3, 4, 5), generator=gen, device="cuda")
    counters = (cada_update.fused_amsgrad_flat,
                cada_update.batched_diff_sq_norm_flat,
                cada_update.batched_sq_norm_flat,
                cada_update.eq3_row_mean_flat)
    before = [f.launches for f in counters]
    st, mets = eng.run(state, (x, y))
    per_round = 2 if kind == "local_momentum" else 1
    assert [f.launches - b for f, b in zip(counters, before)] == [
        0, 0, 0, 2 * per_round]
    assert st.params_flat.is_cuda and bool(mets["uploads"].eq(4).all())
    assert mets["grad_evals"].tolist() == [12, 12]
    plain = CADAEngine(logreg_loss, None, rule, 4, impl="plain")
    pst, _ = plain.run(state, (x, y))
    _within_scale(st.params_flat, pst.params_flat, 1e-5)
    if kind == "local_momentum":
        _within_scale(st.comm.extras["momenta"], pst.comm.extras["momenta"],
                      1e-5)


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


def _cada_calls(x, y):
    """Each CADA wrapper on (n,) operands x and y (and their (1, n)
    planes)."""
    return {
        "fused_amsgrad_flat": lambda: cada_update.fused_amsgrad_flat(
            x, x, x.abs(), y, 0.1),
        "batched_diff_sq_norm_flat":
            lambda: cada_update.batched_diff_sq_norm_flat(x[None], y[None]),
        "diff_sq_norm_flat": lambda: cada_update.diff_sq_norm_flat(x, y),
        "batched_sq_norm_flat":
            lambda: cada_update.batched_sq_norm_flat(torch.stack([x, y])),
        "eq3_row_mean_flat":
            lambda: cada_update.eq3_row_mean_flat(torch.stack([x, y]), 2)}


def test_cada_wrappers_refuse_a_host_operand_by_name(gen):
    x = torch.randn(64, generator=gen, device="cuda")
    for name, call in _cada_calls(x, x.cpu()).items():
        if name in ("batched_sq_norm_flat", "eq3_row_mean_flat"):
            continue   # their one plane is stacked on one device
        with pytest.raises(RuntimeError, match=name):
            call()


def test_cada_wrappers_keep_to_their_operands_card(gen):
    """On a machine with two cards: operands on two cards raise by name,
    and operands on card 1 launch there while card 0 is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x0 = torch.randn(4096, generator=gen, device="cuda:0")
    x1 = x0.to("cuda:1")
    for name, call in _cada_calls(x0, x1).items():
        if name in ("batched_sq_norm_flat", "eq3_row_mean_flat"):
            continue
        with pytest.raises(ValueError, match=f"{name}.*one device"):
            call()
    with torch.cuda.device(0):
        for name, call in _cada_calls(x1, x1 * 0.5).items():
            on1 = call()
            outs = on1 if isinstance(on1, tuple) else (on1,)
            assert all(t.device == x1.device for t in outs), name
            with torch.cuda.device(1):
                again = call()
            again = again if isinstance(again, tuple) else (again,)
            assert all(torch.equal(a, b) for a, b in zip(outs, again)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_runs_the_same_bits_on_the_card(gen, dtype):
    """granite-moe's routing (32 experts, top 8) over 4096 tokens, forward
    and backward twice: the same bits (the expert gather and scatter go
    one expert at a time, so no index repeats inside an index_add)."""
    cfg = TC.get_config("granite-moe-1b-a400m").with_(
        n_layers=1, d_model=256, d_ff=128, dtype=str(dtype).split(".")[1])
    lp = TM.layer(TM.init_params(cfg, 0)["blocks"], 0)["mlp"]
    x = torch.randn(2, 2048, cfg.d_model, generator=gen,
                    device="cuda").to(dtype)
    runs = []
    for _ in range(2):
        leaves = {n: v.clone().requires_grad_() for n, v in lp.items()}
        xi = x.clone().requires_grad_()
        y, aux = tmoe.moe_ffn(leaves, cfg, xi)
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux,
                                    [xi, *leaves.values()])
        runs.append((y, aux, grads))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
    assert float(runs[0][1]) > 0.0


def test_wrappers_count_launches_and_check_operands(gen):
    x = torch.randn(64, generator=gen, device="cuda")
    before = cada_update.fused_amsgrad_flat.launches
    ops.fused_amsgrad_flat(x, x, x.abs(), x, 0.1)
    assert cada_update.fused_amsgrad_flat.launches == before + 1
    ops.fused_amsgrad_flat(x, x, x.abs(), x, 0.1, impl="plain")
    assert cada_update.fused_amsgrad_flat.launches == before + 1
    # bf16 θ and g launch the kernel; a dtype it does not take is named
    ops.fused_amsgrad_flat(x.bfloat16(), x, x.abs(), x.bfloat16(), 0.1)
    assert cada_update.fused_amsgrad_flat.launches == before + 2
    with pytest.raises(ValueError, match="float16"):
        ops.fused_amsgrad_flat(x.half(), x, x.abs(), x, 0.1)
    with pytest.raises(ValueError, match="float64"):
        ops.fused_amsgrad_flat(x, x, x.abs(), x.double(), 0.1)
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


# ------------------------------------------------ selective scan and flash

def _within(got, want, rtol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    bound = rtol * want.abs().clamp_min(1.0)
    assert bool(((got - want).abs() <= bound).all()), float(
        (got - want).abs().max())


def _within_bf16_flash(got, q, k, v, window):
    """The bf16 flash check: each element within 2⁻⁸·max(1, |plain|) of
    the plain bf16 output or, where not, a single rounding flip — within
    one bf16 ULP of the plain result computed in fp32 from the same bf16
    inputs, the ULP of an fp32 reference of 0 taken as 2⁻¹³³, bf16's
    least subnormal (the rule of ``chip_smoke.py``'s ``_bf16_ulps``).
    Above |o| = 1 a bf16 ULP is 2⁻⁷ of |o| or more, and the tensor-core
    kernel's fp32 result (bf16 q·k scaled after the product, P as two
    bf16 halves) can fall on the other side of a rounding boundary from
    the plain version's."""
    want = ops.flash_attention(q, k, v, window=window, impl="plain")
    want32 = ops.flash_attention(q.float(), k.float(), v.float(),
                                 window=window, impl="plain")
    got, wf = got.float(), want.float()
    assert got.shape == want.shape
    outside = (got - wf).abs() > 2.0 ** -8 * wf.abs().clamp_min(1.0)
    _, e = torch.frexp(want32)
    ulp = torch.where(want32 == 0, torch.full_like(want32, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(want32), e - 8))
    flip = (got - want32).abs() <= ulp
    assert bool((flip | ~outside).all()), (
        int(outside.sum()), int((outside & ~flip).sum()))


def _within_scale(got, want, rtol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), err


def _scan_operands(gen, g, s, d, n, lowp, shared_a=True):
    dev = "cuda"
    dt = (0.1 * torch.randn(g, s, d, generator=gen, device=dev)).abs()
    x = torch.randn(g, s, d, generator=gen, device=dev)
    a2 = -torch.randn(d, n, generator=gen, device=dev).abs()
    a = a2.expand(g, d, n) if shared_a else a2.expand(g, d, n).clone()
    b = torch.randn(g, s, n, generator=gen, device=dev)
    c = torch.randn(g, s, n, generator=gen, device=dev)
    if lowp:
        x, b, c = x.bfloat16(), b.bfloat16(), c.bfloat16()
    return dt, x, a, b, c


@pytest.mark.parametrize("shape", [(1, 64, 128, 16), (2, 100, 200, 8),
                                   (3, 37, 520, 64), (1, 40, 96, 128),
                                   (2, 300, 5120, 64)])
@pytest.mark.parametrize("lowp", [False, True])
def test_scan_kernel_matches_plain(gen, shape, lowp):
    """Shapes with S and D that are not multiples of the kernel's tiles,
    N from 8 to 128, bf16 x/B/C, one A shared by every group (a zero-stride
    view) and one per group."""
    ops_ = _scan_operands(gen, *shape, lowp, shared_a=shape[0] != 3)
    before = ssm_scan.selective_scan.launches
    y, h = ops.selective_scan(*ops_)
    assert ssm_scan.selective_scan.launches == before + 1
    y2, h2 = ops.selective_scan(*ops_)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    yp, hp = ops.selective_scan(*ops_, impl="plain")
    assert ssm_scan.selective_scan.launches == before + 2
    _within_scale(y, yp, 1e-5)
    _within_scale(h, hp, 1e-5)


def _mamba2_a(gen, g, d, n, hd=64):
    """Mamba2's A: one value per head of ``hd`` channels, a view with
    stride 0 on N and over G, as ``models/ssm.py`` passes it."""
    a_h = -(1.0 + 15.0 * torch.rand(-(-d // hd), generator=gen,
                                    device="cuda"))
    a = torch.repeat_interleave(a_h, hd)[:d, None].expand(d, n)
    return a[None].expand(g, d, n)


@pytest.mark.parametrize("shape", [(2, 333, 200, 16), (3, 100, 520, 64),
                                   (1, 45, 101, 128), (2, 77, 96, 64)])
@pytest.mark.parametrize("lowp", [False, True])
def test_scan_kernel_mamba2_form_matches_materialised(gen, shape, lowp):
    """A with stride 0 on N (one decay per channel) against the same call
    with A materialised (one exponential per state): h_final bit for bit
    (both write the state update as one fmaf of the same decay), y within
    1e-5 of its scale; both against the plain version. S and D are not
    multiples of the kernel's tiles; D = 101 leaves x's rows unaligned."""
    g, s, d, n = shape
    dt, x, _, b, c = _scan_operands(gen, g, s, d, n, lowp)
    a = _mamba2_a(gen, g, d, n)
    assert a.stride(2) == 0
    before = ssm_scan.selective_scan.launches
    y, h = ops.selective_scan(dt, x, a, b, c)
    assert ssm_scan.selective_scan.launches == before + 1
    y2, h2 = ops.selective_scan(dt, x, a, b, c)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    am = a[0].contiguous().expand(g, d, n)
    ym, hm = ops.selective_scan(dt, x, am, b, c)
    assert torch.equal(h, hm)
    _within_scale(y, ym, 1e-5)
    yp, hp = ops.selective_scan(dt, x, a, b, c, impl="plain")
    _within_scale(y, yp, 1e-5)
    _within_scale(h, hp, 1e-5)


@pytest.mark.parametrize("s", [1, 63, 65, 333, 2048])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("window", [0, 100])
def test_flash_bf16_tensor_core_kernel_matches_plain(gen, s, hd, window):
    """The bf16 instance (tensor cores) at lengths below, at and around
    the 64-row tiles, GQA 8/2, with and without a window of 100."""
    b = 1 if s == 2048 else 2
    q = torch.randn(b, s, 8, hd, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, s, 2, hd, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, s, 2, hd, generator=gen, device="cuda").bfloat16()
    before = tfa.flash_attention.launches
    out = ops.flash_attention(q, k, v, window=window)
    assert tfa.flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.equal(out, ops.flash_attention(q, k, v, window=window))
    _within_bf16_flash(out, q, k, v, window)


@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 96, 128])
@pytest.mark.parametrize("hq,hkv,window", [(4, 4, 0), (8, 2, 0),
                                           (4, 2, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(gen, hd, hq, hkv, window, dtype):
    """Every compiled head dim, and 48 and 96, which run zero-padded on the
    next instance (64, 128) at the scale of their own hd."""
    s = 333     # not a multiple of the 64-row tiles
    q = torch.randn(2, s, hq, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(2, s, hkv, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(2, s, hkv, hd, generator=gen, device="cuda").to(dtype)
    before = tfa.flash_attention.launches
    out = ops.flash_attention(q, k, v, window=window)
    assert tfa.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, ops.flash_attention(q, k, v, window=window))
    if dtype == torch.bfloat16:
        _within_bf16_flash(out, q, k, v, window)
    else:
        want = ops.flash_attention(q, k, v, window=window, impl="plain")
        _within(out, want, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_qwen2_vl_heads_matches_plain(gen, dtype):
    """hd 128 with 6-way GQA (12 query heads over 2 KV heads), qwen2-vl's
    attention, at a 2048-token prompt."""
    q = torch.randn(1, 2048, 12, 128, generator=gen, device="cuda").to(dtype)
    k = torch.randn(1, 2048, 2, 128, generator=gen, device="cuda").to(dtype)
    v = torch.randn(1, 2048, 2, 128, generator=gen, device="cuda").to(dtype)
    before = tfa.flash_attention.launches
    out = ops.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before + 1
    assert torch.equal(out, ops.flash_attention(q, k, v))
    if dtype == torch.bfloat16:
        _within_bf16_flash(out, q, k, v, 0)
    else:
        _within(out, ops.flash_attention(q, k, v, impl="plain"), 1e-5)


def test_lm_kernels_refuse_what_they_do_not_take(gen):
    q = torch.randn(1, 64, 4, 80, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim 192"):
        qh = torch.randn(1, 64, 4, 192, generator=gen, device="cuda")
        ops.flash_attention(qh, qh, qh)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            q, q)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, q[:, :, :3].contiguous(),
                            q[:, :, :3].contiguous())
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention(q, q.cpu(), q)
    qb = q.bfloat16()
    off = torch.empty(qb.numel() + 1, dtype=torch.bfloat16,
                      device="cuda")[1:].view(qb.shape)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(off, qb, qb)
    dt, x, a, b, c = _scan_operands(gen, 2, 16, 64, 16, False)
    a_pc = a[:, :, :1].expand(2, 64, 16)      # stride 0 on N: taken
    assert a_pc.stride(2) == 0
    ops.selective_scan(dt, x, a_pc, b, c)
    for i in (0, 1, 3, 4):                    # dt, x, b, c: contiguous only
        args = [dt, x, a, b, c]
        args[i] = args[i].transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            ops.selective_scan(*args)
    with pytest.raises(ValueError, match="fp32"):
        ops.selective_scan(dt.bfloat16(), x, a, b, c)
    with pytest.raises(ValueError, match="b and c"):
        ops.selective_scan(dt, x, a, b.bfloat16(), c)
    with pytest.raises(ValueError, match="N <="):
        big = torch.zeros(2, 16, 200, device="cuda")
        ops.selective_scan(dt, x, torch.zeros(2, 64, 200, device="cuda"),
                           big, big)
    with pytest.raises(ValueError, match="block of a"):
        ops.selective_scan(dt, x, a.transpose(1, 2).contiguous()
                           .transpose(1, 2), b, c)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssm_scan.selective_scan(dt, x.cpu(), a, b, c)
    with pytest.raises(NotImplementedError, match="h0"):
        tssm._scan(dt, x, a[0], b, c, torch.zeros(2, 64, 16, device="cuda"))
    # explicit positions take the reference's naive route, no kernel
    pos = torch.arange(64, device="cuda")
    before = tfa.flash_attention.launches
    out = tattn.causal_attention(q, q, q, positions_q=pos, positions_k=pos,
                                 dtype=torch.float32)
    assert tfa.flash_attention.launches == before
    _within(out, tattn.naive_attention(q, q, q, dtype=torch.float32), 1e-6)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "falcon-mamba-7b",
                                  "internlm2-1.8b", "granite-moe-1b-a400m",
                                  "grok-1-314b", "qwen2-vl-2b",
                                  "musicgen-medium"])
def test_prefill_launches_the_kernels_and_decode_none(gen, arch):
    """A prefill on the card runs every SSM layer through the scan kernel
    and every attention through the flash kernel (an M-RoPE prefill with
    the positions of an image plan too); a decode step launches neither.
    Its logits and cache agree with ``impl="plain"``."""
    cfg = TC.get_smoke_config(arch)
    params = TM.init_params(cfg, 0)
    if cfg.embed_input:
        toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                             device="cuda")
    else:
        toks = torch.randn(2, 40, cfg.d_model, generator=gen, device="cuda")
    kw = {"tokens" if cfg.embed_input else "embeds": toks}
    if cfg.mrope:
        kw["positions"] = tfront.mrope_positions(2, 40, (4, 4))
    n_ssm = cfg.n_layers if cfg.block in ("mamba1", "mamba2") else 0
    n_attn = TM._n_attn_layers(cfg)
    before = (ssm_scan.selective_scan.launches, tfa.flash_attention.launches)
    logits, cache = TM.prefill(cfg, params, max_seq=48, **kw)
    assert (ssm_scan.selective_scan.launches - before[0],
            tfa.flash_attention.launches - before[1]) == (n_ssm, n_attn)
    plain, pcache = TM.prefill(cfg, params, max_seq=48, impl="plain", **kw)
    assert (ssm_scan.selective_scan.launches - before[0],
            tfa.flash_attention.launches - before[1]) == (n_ssm, n_attn)
    _within(logits, plain, 1e-4)
    for f in ("k", "v", "conv", "ssm"):
        if getattr(cache, f) is not None:
            _within(getattr(cache, f), getattr(pcache, f), 1e-4)
    mid = (ssm_scan.selective_scan.launches, tfa.flash_attention.launches)
    if cfg.embed_input:
        out, _ = TM.decode_step(cfg, params, cache, torch.argmax(logits, -1))
    else:
        out, _ = TM.decode_step(cfg, params, cache,
                                embeds=torch.zeros(2, 1, cfg.d_model,
                                                   device="cuda"))
    assert (ssm_scan.selective_scan.launches,
            tfa.flash_attention.launches) == mid
    assert bool(torch.isfinite(out).all())


# --------------------------------------------------------------- trainer

@pytest.mark.parametrize("kind,norm", [("cada2", "batched_diff_sq_norm_flat"),
                                       ("laq", "batched_sq_norm_flat"),
                                       ("always", None)])
def test_trainer_step_launches_the_kernels_and_matches_plain(gen, kind,
                                                             norm):
    """A smoke-size trainer step on the card (stablelm smoke, M = 2): the
    state defaults to the card, the step launches one AMSGrad step and the
    rule's one LHS norm and no scan or flash kernel (the training route is
    plain PyTorch), and a step with ``impl="plain"`` from the same state
    launches nothing and gives the same masks and θ within 1e-5 of its
    scale (the two steps' backward passes may round differently)."""
    cfg = TC.get_smoke_config("stablelm-1.6b")
    hp = TrainHParams(rule=CommRule(kind=kind, c=20.0, d_max=4,
                                    max_delay=10), lr=1e-3)
    state = init_train_state(cfg, hp, 2, 0)
    assert state.h.is_cuda and all(t.is_cuda for t in _leaves(state.params))
    batch = worker_split({"tokens": torch.randint(
        0, cfg.vocab, (4, 33), generator=gen, device="cuda")}, 2)
    counters = {"amsgrad": cada_update.fused_amsgrad_flat,
                "batched_diff_sq_norm_flat":
                    cada_update.batched_diff_sq_norm_flat,
                "batched_sq_norm_flat": cada_update.batched_sq_norm_flat,
                "scan": ssm_scan.selective_scan,
                "flash": tfa.flash_attention}
    before = {k: f.launches for k, f in counters.items()}
    new, mets = make_train_step(cfg, hp, 2)(state, batch)
    torch.cuda.synchronize()
    got = {k: f.launches - before[k] for k, f in counters.items()}
    want = {k: int(k == "amsgrad" or k == norm) for k in counters}
    assert got == want
    mid = {k: f.launches for k, f in counters.items()}
    plain, pmets = make_train_step(cfg, hp, 2, impl="plain")(state, batch)
    assert {k: f.launches for k, f in counters.items()} == mid
    assert torch.equal(mets["upload_mask"], pmets["upload_mask"])
    for a, b in zip(_leaves(new.params), _leaves(plain.params)):
        assert a.is_cuda
        _within_scale(a, b, 1e-5)
    assert bool(torch.isfinite(mets["loss"]))


@pytest.mark.parametrize("kind", ["local_momentum", "fedadam"])
def test_trainer_delta_step_launches_the_kernels_and_matches_plain(gen,
                                                                   kind):
    """A smoke-size trainer step of a delta rule on the card (H = 2,
    M = 2): one AMSGrad launch, eq. (3) once (twice for local momentum),
    no LHS norm; ``impl="plain"`` from the same state launches nothing and
    gives θ within 1e-5 of its scale."""
    cfg = TC.get_smoke_config("stablelm-1.6b")
    hp = TrainHParams(rule=CommRule(kind=kind, local_steps=2, c=20.0,
                                    d_max=4, max_delay=10), lr=1e-3)
    state = init_train_state(cfg, hp, 2, 0)
    batch = worker_split({"tokens": torch.randint(
        0, cfg.vocab, (4, 33), generator=gen, device="cuda")}, 2,
        local_steps=2)
    counters = (cada_update.fused_amsgrad_flat,
                cada_update.batched_diff_sq_norm_flat,
                cada_update.batched_sq_norm_flat,
                cada_update.eq3_row_mean_flat)
    before = [f.launches for f in counters]
    new, mets = make_train_step(cfg, hp, 2)(state, batch)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [
        1, 0, 0, 2 if kind == "local_momentum" else 1]
    mid = [f.launches for f in counters]
    plain, pmets = make_train_step(cfg, hp, 2, impl="plain")(state, batch)
    assert [f.launches for f in counters] == mid
    assert int(mets["grad_evals"]) == 4 and bool(mets["upload_mask"].all())
    for a, b in zip(_leaves(new.params), _leaves(plain.params)):
        assert a.is_cuda
        _within_scale(a, b, 1e-5)


# ------------------------------------------------------ the cohort plane

def _cohort_problem(gen, m, c, rounds):
    """Logreg on random data at M workers: parameters, a (rounds, C)
    schedule and each round's cohort batch, on the card."""
    from repro_torch.core.engine import sample_cohorts
    cohorts = sample_cohorts(m, c, rounds, seed=3)
    batches = [(torch.randn((c, 8, 22), generator=gen, device="cuda"),
                torch.randint(0, 2, (c, 8), generator=gen, device="cuda"))
               for _ in range(rounds)]
    params = {"w": torch.zeros(22, 2, device="cuda"),
              "b": torch.zeros(2, device="cuda")}
    return params, cohorts, batches


def _cohort_runs(params, cohorts, batches, m, kind="laq", between=None):
    """Serial and pipelined runs of ``kind`` over the same rounds:
    {pipeline: (state, pool, metrics)}. ``between(i, cohort)`` runs before
    each round's batch is handed over."""
    out = {}
    for pipeline in (False, True):
        eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                         CommRule(kind=kind, c=5.0, d_max=4, max_delay=6),
                         m)
        st, pool = eng.init_cohort(params)

        def batch_fn(i, cohort):
            if between is not None:
                between(i, cohort)
            return batches[i]

        st, mets = eng.run_cohort(st, pool, batch_fn, cohorts,
                                  pipeline=pipeline, metrics_every=3)
        torch.cuda.synchronize()
        out[pipeline] = (st, pool, mets)
    return out


def _assert_runs_equal(runs):
    (sa, pa, ma), (sb, pb, mb) = runs[True], runs[False]
    for a, b in zip(_leaves(sa.params), _leaves(sb.params)):
        assert torch.equal(a, b)
    assert torch.equal(sa.params_flat, sb.params_flat)
    assert torch.equal(sa.server.nabla, sb.server.nabla)
    assert torch.equal(sa.server.staleness, sb.server.staleness)
    for name in pa.plane_order:
        assert torch.equal(pa.planes[name], pb.planes[name]), name
    for x, y in zip(ma, mb):
        for key in x:
            assert np.array_equal(x[key], y[key]), key


def test_cohort_pipeline_equals_serial_with_heavy_overlap(gen):
    """C = M − 1: every round forwards all but one row from the previous
    round's block, where a race between the copy streams, a pinned slot
    refilled too early or a block reused before its copy ended would show
    first. The pipelined run equals the serial one bit for bit."""
    m, rounds = 16, 30
    params, cohorts, batches = _cohort_problem(gen, m, m - 1, rounds)
    assert (flat.cohort_overlap_schedule(cohorts)[1:] >= 0).sum(
        axis=1).min() >= m - 2
    _assert_runs_equal(_cohort_runs(params, cohorts, batches, m))


def test_cohort_record_stream_holds_blocks_in_flight(gen):
    """Between rounds the caching allocator is emptied and a few blocks of
    a round's size are allocated and written: a block still read by a copy
    stream that was not ``record_stream``-ed to it would be handed out and
    overwritten, and the pool rows would differ from the serial run's."""
    m, rounds = 16, 20
    params, cohorts, batches = _cohort_problem(gen, m, 12, rounds)
    junk = []

    def churn(i, cohort):
        junk.clear()
        torch.cuda.empty_cache()
        junk.extend(torch.full((2, 12, 48), float(i), device="cuda")
                    for _ in range(4))

    _assert_runs_equal(_cohort_runs(params, cohorts, batches, m,
                                    between=churn))


def test_bf16_pool_round_trip_through_pinned_slots(gen):
    """A bf16 pool on the card: the two staging slots are pinned, a gather
    lands on the card bit for bit, a scatter of new rows writes exactly
    those rows (bf16 by its bits), the other rows untouched; alternating
    slots with the copies in flight do the same."""
    m, n_flat = 40, 1000
    planes = {name: torch.randn(m, n_flat, generator=gen,
                                device="cuda").to(torch.bfloat16).cpu()
              for name in ("worker_grads", "residual")}
    pool = flat.WorkerPool({k: v.clone() for k, v in planes.items()})
    assert pool.device.type == "cuda" and pool.plane_dtype == torch.bfloat16
    want = {k: v.clone() for k, v in planes.items()}
    for i in range(6):
        cohort = np.sort(np.random.default_rng(i).choice(m, 9,
                                                         replace=False))
        block = pool.gather_fused(cohort, slot=i)
        assert block.is_cuda and block.dtype == torch.bfloat16
        assert pool._stage.is_pinned()
        for p, name in enumerate(pool.plane_order):
            assert torch.equal(block[p].cpu(), want[name][cohort])
        new = torch.randn(block.shape, generator=gen,
                          device="cuda").to(torch.bfloat16)
        pool.land(pool.fetch(cohort, new, slot=i))
        for p, name in enumerate(pool.plane_order):
            want[name][cohort] = new[p].cpu()
    for name in pool.plane_order:
        assert torch.equal(pool.planes[name].view(torch.int16),
                           want[name].view(torch.int16))


# ------------------------------------------------------- the mesh runtime

def _mesh_on_card(tmp_path, backend: str, steps: int = 3):
    """The mesh runtime on 2 ranks at stablelm's smoke size (cada2,
    state_fsdp_axes=("data",), a (data=2, model=1) mesh) and the
    one-process trainer on the card from the same state and batches."""
    import mesh_ranks
    from repro_torch.utils.trees import tree_leaves
    cfg = TC.get_smoke_config("stablelm-1.6b")
    hp = TrainHParams(rule=CommRule(kind="cada2", c=20.0, d_max=4,
                                    max_delay=10), lr=1e-3,
                      state_fsdp_axes=("data",))
    state = init_train_state(cfg, hp, 2, 0, "cpu", shards=2)
    toks = torch.randint(0, cfg.vocab, (steps, 4, 33),
                         generator=torch.Generator().manual_seed(0))
    batches = [worker_split({"tokens": t}, 2) for t in toks]
    ranks = mesh_ranks.spawn(mesh_ranks.run_steps, 2, tmp_path, {
        "sizes": (2, 1), "axes": ("data", "model"), "device": "cuda",
        "backend": backend, "cases": [("mesh", cfg, hp, state, batches)]})
    step = make_train_step(cfg, hp, 2, shards=2)
    st = mesh_ranks._to(state, torch.device("cuda"))   # the ranks' state
    mets = []
    for b in batches:
        st, m = step(st, {k: v.cuda() for k, v in b.items()})
        mets.append(m)
    for r in ranks:
        got = r["mesh"]
        assert got["launches"] == {"amsgrad": steps,
                                   "batched_diff_sq": steps,
                                   "batched_sq": 0, "eq3_row_mean": 0}
        for k in range(steps):
            assert got["metrics"][k]["upload_mask"].tolist() == \
                mets[k]["upload_mask"].tolist()
            assert float(got["metrics"][k]["dtheta_sq"]) == pytest.approx(
                float(mets[k]["dtheta_sq"]), rel=1e-6)
        final = got["states"][-1]
        for a, b in ((final.h, st.h), (final.vhat, st.vhat),
                     (final.comm.nabla, st.comm.nabla),
                     (final.comm.worker_grads, st.comm.worker_grads)):
            assert torch.equal(a, b.cpu())
        for a, b in zip(tree_leaves(final.params), tree_leaves(st.params)):
            assert torch.equal(a, b.cpu())


def test_mesh_two_ranks_on_one_card_equal_one_process(gen, tmp_path):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one
    device): each launches the AMSGrad kernel on its half of the server
    plane and the row norm on its worker's row once a step, eq. (3) is a
    collective with no kernel, and the run equals the one-process trainer
    bit for bit (‖Δθ‖² within 1e-6: two partial sums)."""
    _mesh_on_card(tmp_path, "gloo")


def test_mesh_nccl_one_card_per_rank(gen, tmp_path):
    """NCCL, the backend for one card per rank: the same run and
    contract as the gloo test above."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (one per rank)")
    _mesh_on_card(tmp_path, "nccl")


# ------------------------------------ the mesh trainer: model axis, FSDP

TPT_TOL = 1e-5   # θ's update, h, ‖Δθ‖²: of scale (partial sums' order)


def _tp_fsdp_steps(tmp_path, device: str, steps: int = 3):
    """stablelm's smoke config (fp32), cada2 at c = 20, two cases on 2
    ranks sharing the device over gloo: tensor parallelism on a (data=1,
    model=2) mesh (M = 1) and parameter FSDP with remat on a (data=2,
    model=1) mesh (M = 2); each against the one-process trainer on the
    device from the same state and batches. Returns per case the ranks'
    results and the one-process metrics and final state."""
    import mesh_ranks
    rule = CommRule(kind="cada2", c=20.0, d_max=4, max_delay=10)
    cfg = TC.get_smoke_config("stablelm-1.6b")
    cases = {"tp": (cfg, TrainHParams(rule=rule, lr=1e-3), (1, 2)),
             "fsdp": (cfg.with_(remat=True),
                      TrainHParams(rule=rule, lr=1e-3, fsdp=True), (2, 1))}
    toks = torch.randint(0, cfg.vocab, (steps, 4, 33),
                         generator=torch.Generator().manual_seed(0))
    jobs, out = [], {}
    for name, (c, hp, sizes) in cases.items():
        m = sizes[0]
        state = init_train_state(c, hp, m, 0, "cpu", shards=m)
        batches = [worker_split({"tokens": t}, m) for t in toks]
        jobs.append((name, c, hp, state, batches,
                     (sizes, ("data", "model"))))
        step = make_train_step(c, hp, m, shards=m)
        st = mesh_ranks._to(state, torch.device(device))
        mets = []
        for b in batches:
            st, met = step(st, {k: v.to(device) for k, v in b.items()})
            mets.append(met)
        out[name] = (mets, mesh_ranks._host(st))
    ranks = mesh_ranks.spawn(mesh_ranks.run_steps, 2, tmp_path, {
        "sizes": (2, 1), "axes": ("data", "model"), "device": device,
        "cases": jobs})
    return {name: ([r[name] for r in ranks],) + out[name] for name in out}


def _share(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_tp_fsdp_trainer_on_one_card_equals_one_process(gen, tmp_path):
    """The mesh trainer with a model axis, and with parameter FSDP, on 2
    ranks sharing the card: per rank one shard-local AMSGrad and row-norm
    launch a step and no row-mean kernel (eq. (3) is an all-reduce);
    masks equal to the one-process trainer's; FSDP (the gathers are exact)
    gives its state bit for bit, tensor parallelism (partial sums of the
    blocks) within TPT_TOL of scale."""
    from repro_torch.utils.trees import tree_leaves
    for name, (ranks, mets, st) in _tp_fsdp_steps(tmp_path, "cuda").items():
        for got in ranks:
            assert got["launches"] == {"amsgrad": 3, "batched_diff_sq": 3,
                                       "batched_sq": 0, "eq3_row_mean": 0}
            for k, met in enumerate(mets):
                assert torch.equal(got["metrics"][k]["upload_mask"],
                                   met["upload_mask"].cpu()), (name, k)
                assert float(got["metrics"][k]["dtheta_sq"]) == \
                    pytest.approx(float(met["dtheta_sq"]), rel=TPT_TOL)
            final = got["states"][-1]
            pairs = [(final.h, st.h), (final.comm.nabla, st.comm.nabla)]
            pairs += list(zip(tree_leaves(final.params),
                              tree_leaves(st.params)))
            for a, b in pairs:
                if name == "fsdp":
                    assert torch.equal(a, b), name
                else:
                    assert _share(a, b) <= TPT_TOL, name


def test_vocab_parallel_loss_on_one_card(gen, tmp_path):
    """internlm2's smoke config on 2 ranks sharing the card, a (data=1,
    model=2) mesh: the loss of the vocab-parallel logits against the loss
    of the logits gathered whole (rtol 1e-6), and the rank's whole
    gradient against the one-process gradient on the card (TPT_TOL of
    each leaf's scale); the value and gradient gather no logits."""
    import mesh_ranks
    from repro_torch.distributed.trainer import make_worker_grad
    from repro_torch.utils.trees import tree_leaves
    cfg = TC.get_smoke_config("internlm2-1.8b")
    hp = TrainHParams()
    params = TM.init_params(cfg, 0, "cuda")
    toks = torch.randint(0, cfg.vocab, (1, 2, 33), generator=gen,
                         device="cuda")
    _, want = make_worker_grad(cfg, hp)(params, {"tokens": toks[0]})
    ranks = mesh_ranks.spawn(mesh_ranks.run_grads, 2, tmp_path, {
        "device": "cuda", "cases": [(
            "dense", (1, 2), cfg, hp, mesh_ranks._to(params,
                                                     torch.device("cpu")),
            {"tokens": toks.cpu()})]})
    for r in ranks:
        got = r["dense"]
        assert float(got["vocab_parallel_loss"]) == pytest.approx(
            float(got["gathered_logits_loss"]), rel=1e-6)
        assert not [op for op, _ in got["value_and_grad"]
                    if op == "all_gather"]
        for g, w in zip(tree_leaves(got["grads"]), tree_leaves(want)):
            assert _share(g[0], w.cpu()) <= TPT_TOL


# ------------------------------------------------- tensor-parallel serving

TP_BAND = 0.05   # of each array's scale: chip_smoke.py's TP_BAND (bf16)


def test_tp_serving_two_ranks_on_one_card_equal_one_process(gen, tmp_path):
    """zamba2's smoke config in bf16 served by ``distributed/serving.py``
    on 2 ranks sharing the card over gloo, a (data=1, model=2) mesh,
    against the one-process run on the card: the prefill's logits and
    cache and 8 decode steps teacher-forced on the one-process tokens
    within TP_BAND of scale (each row-parallel product's two bf16
    partials summed in fp32); per rank 2 scans and 1 flash launch per
    prefill, none per decode step, at the rank's shapes."""
    import mesh_ranks
    cfg = TC.get_smoke_config("zamba2-2.7b").with_(dtype="bfloat16")
    params = TM.init_params(cfg, 0, "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           device="cuda")
    logits, cache = TM.prefill(cfg, params, tokens)
    want = {"prefill": logits.cpu(), "cache": {
        f: getattr(cache, f).cpu() for f in ("k", "v", "conv", "ssm")},
        "steps": []}
    steps = []
    for _ in range(8):
        tok = torch.argmax(logits, dim=-1)
        steps.append({"tokens": tok.cpu()})
        logits, cache = TM.decode_step(cfg, params, cache, tok)
        want["steps"].append(logits.cpu())
    ranks = mesh_ranks.spawn(mesh_ranks.run_serving, 2, tmp_path, {
        "device": "cuda", "round_trip": [], "round_trip_sizes": (1, 2),
        "cases": [("zamba2", (1, 2), cfg, mesh_ranks._to(
            params, torch.device("cpu")), {"tokens": tokens.cpu()},
            steps)]})

    def share(got, ref):
        got, ref = got.double(), ref.double()
        return float((got - ref).abs().max() / ref.abs().max())

    for r in ranks:
        got = r["zamba2"]
        assert got["launches"] == ({"flash_attention": 1,
                                    "selective_scan": 2},
                                   {"flash_attention": 0,
                                    "selective_scan": 0})
        assert got["param_shapes"]["blocks/in_x"] == (2, 128, 128)
        assert share(got["prefill_logits"], want["prefill"]) <= TP_BAND
        for f, ref in want["cache"].items():
            assert share(getattr(got["prefill_cache"], f), ref) <= TP_BAND
        for a, b in zip(got["decode_logits"], want["steps"]):
            assert share(a, b) <= TP_BAND
        assert torch.equal(got["prefill_logits"],
                           ranks[0]["zamba2"]["prefill_logits"])
