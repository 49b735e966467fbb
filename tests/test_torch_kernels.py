"""The port's kernel modules against the JAX package's Pallas kernels.

Both sides get the same numpy inputs. The Pallas kernels run in interpret
mode, as the JAX package's own kernel tests run them on the CPU; the port's
dispatch sends CPU tensors to the plain PyTorch versions.

Tolerances:
  * fp32 outputs of the AMSGrad step: |Δ| ≤ 2⁻²⁰ · max|ref| per array
    (8 ULP at the array's scale). XLA contracts b1·h + (1−b1)·g into an
    FMA and PyTorch's eager ops round each product, so single elements
    differ by about one ULP of their operands (more, relative to the
    element, where h and g nearly cancel).
  * bf16 moments: that one-ULP fp32 gap can flip the bf16 rounding of an
    element. A flipped element differs by one bf16 ULP (2⁻⁸ relative) and
    at most 0.1% of elements may flip; θ is compared where the stored
    moments agree (the stored moment drives the update by contract).
  * Σupd², the row norms and the scalar ‖a−b‖²: rtol 1e-5. Both sides add
    up to 7·10⁴ fp32 terms in different orders (blocked sequential vs
    PyTorch's reduction); the differences measured here reach 1.0e-6
    relative.
  * eq. (3) row mean: bit-equal (the port copies the order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cada_update as jcu
from repro.kernels import ops as jops
from repro.kernels.cada_update import BLOCK
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import cada_update, ops, ref

torch.set_num_threads(1)

ULP_SCALE = 2.0 ** -20


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _amsgrad_inputs(rng, n, moment_dtype):
    theta = rng.normal(size=n).astype(np.float32)
    h = (rng.normal(size=n) * 0.1).astype(np.float32)
    vhat = np.abs(rng.normal(size=n) * 0.01).astype(np.float32)
    grad = rng.normal(size=n).astype(np.float32)
    # round the moments to their storage dtype once, on the JAX side
    h = np.asarray(jnp.asarray(h).astype(moment_dtype))
    vhat = np.asarray(jnp.asarray(vhat).astype(moment_dtype))
    return theta, h, vhat, grad


@pytest.mark.parametrize("n", [48, BLOCK + 8, 2 * BLOCK + 4464])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_amsgrad_ref_matches_pallas(rng, n, moment_dtype):
    """amsgrad_ref vs the Pallas _amsgrad_kernel on lengths that are not a
    multiple of its 32768-element block."""
    mdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    theta, h, vhat, grad = _amsgrad_inputs(rng, n, mdt)
    lr = 0.01
    j_theta, j_h, j_vhat, j_sq = jops.fused_amsgrad_flat(
        jnp.asarray(theta), jnp.asarray(h), jnp.asarray(vhat),
        jnp.asarray(grad), lr, interpret=True)
    t_theta, t_h, t_vhat, t_sq = ops.fused_amsgrad_flat(
        *(tensor_from_numpy(a, "cpu") for a in (theta, h, vhat, grad)), lr)
    assert t_h.dtype == t_vhat.dtype == (
        torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)
    assert t_theta.dtype == torch.float32
    same = np.ones(n, bool)
    for j, t in ((j_h, t_h), (j_vhat, t_vhat)):
        j, t = _f32(j), t.float().numpy()
        if moment_dtype == "bfloat16":
            diff = j != t
            assert diff.mean() <= 1e-3
            np.testing.assert_allclose(t, j, rtol=2.0 ** -7, atol=0)
            same &= ~diff
        else:
            np.testing.assert_allclose(
                t, j, rtol=0, atol=ULP_SCALE * np.abs(j).max())
    jt = _f32(j_theta)
    np.testing.assert_allclose(t_theta.numpy()[same], jt[same], rtol=0,
                               atol=ULP_SCALE * np.abs(jt).max())
    if same.all():
        np.testing.assert_allclose(float(t_sq), float(j_sq), rtol=1e-5)


@pytest.mark.parametrize("shape", [(10, 48), (3, BLOCK + 8), (1, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_diff_sq_norm_ref_matches_pallas(rng, shape, dtype):
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    a = np.asarray(jnp.asarray(rng.normal(size=shape)).astype(dt))
    b = np.asarray(jnp.asarray(rng.normal(size=shape)).astype(dt))
    want = np.asarray(jops.batched_diff_sq_norm(jnp.asarray(a),
                                                jnp.asarray(b),
                                                interpret=True))
    got = ops.batched_diff_sq_norm(tensor_from_numpy(a, "cpu"),
                                   tensor_from_numpy(b, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_batched_diff_sq_norm_rows_independent(rng):
    """A row's norm does not depend on the other rows or on R."""
    a = torch.from_numpy(rng.normal(size=(6, 4000)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(6, 4000)).astype(np.float32))
    full = ops.batched_diff_sq_norm(a, b)
    part = ops.batched_diff_sq_norm(a[2:5], b[2:5])
    assert torch.equal(full[2:5], part)


@pytest.mark.parametrize("shape", [(10, 48), (3, BLOCK + 8), (1, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_sq_norm_ref_matches_pallas(rng, shape, dtype):
    """batched_sq_norm's plain version vs the Pallas _batched_sq_kernel
    (interpret mode; its wrapper wants whole blocks, so the JAX side pads
    the plane with zero columns, which add nothing)."""
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    a = np.asarray(jnp.asarray(rng.normal(size=shape)).astype(dt))
    pad = (-shape[1]) % BLOCK
    want = np.asarray(jcu.batched_sq_norm_flat(
        jnp.pad(jnp.asarray(a), ((0, 0), (0, pad))), interpret=True))
    got = ops.batched_sq_norm(tensor_from_numpy(a, "cpu"))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.batched_sq_norm(jnp.asarray(a))),
        rtol=1e-5)


def test_batched_sq_norm_rows_independent(rng):
    """A row's norm does not depend on the other rows or on R."""
    a = torch.from_numpy(rng.normal(size=(6, 4000)).astype(np.float32))
    full = ops.batched_sq_norm(a)
    assert torch.equal(full[2:5], ops.batched_sq_norm(a[2:5]))
    assert torch.equal(full[3:4], ops.batched_sq_norm(a[3:4]))


@pytest.mark.parametrize("n", [48, BLOCK + 8, 2 * BLOCK + 4464])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_diff_sq_norm_matches_pallas(rng, n, dtype):
    """diff_sq_norm_flat and the dict form diff_sq_norm vs the Pallas
    _diff_sq_kernel (interpret mode) on lengths that are not whole
    blocks."""
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    a = np.asarray(jnp.asarray(rng.normal(size=n)).astype(dt))
    b = np.asarray(jnp.asarray(rng.normal(size=n)).astype(dt))
    want = float(jops.diff_sq_norm_flat(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    got = ops.diff_sq_norm_flat(tensor_from_numpy(a, "cpu"),
                                tensor_from_numpy(b, "cpu"))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # the dict form: leaves packed in sorted-key order on both sides
    cut = n // 3
    ta = {"y": a[cut:], "x": a[:cut]}
    tb = {"y": b[cut:], "x": b[:cut]}
    want_tree = float(jops.diff_sq_norm(
        {k: jnp.asarray(v) for k, v in ta.items()},
        {k: jnp.asarray(v) for k, v in tb.items()}, interpret=True))
    got_tree = ops.diff_sq_norm(
        {k: tensor_from_numpy(v, "cpu") for k, v in ta.items()},
        {k: tensor_from_numpy(v, "cpu") for k, v in tb.items()})
    np.testing.assert_allclose(float(got_tree), want_tree, rtol=1e-5)


@pytest.mark.parametrize("rows", [1, 3, 7, 10])
def test_eq3_row_mean_bit_equal(rng, rows):
    plane = rng.normal(size=(rows, 1001)).astype(np.float32)
    plane[rows // 2] = 0.0          # a masked-out worker row
    want = np.asarray(jops.eq3_row_mean(jnp.asarray(plane), 10))
    got = ops.eq3_row_mean(torch.from_numpy(plane), 10).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_eq3_row_mean_drops_zero_rows_exactly(rng):
    """Dropping all-zero rows leaves the result bit-identical."""
    plane = torch.from_numpy(rng.normal(size=(8, 333)).astype(np.float32))
    plane[[1, 4, 6]] = 0.0
    kept = plane[[0, 2, 3, 5, 7]]
    assert torch.equal(ref.eq3_row_mean_ref(plane, 8),
                       ref.eq3_row_mean_ref(kept, 8))


def _launch_counts():
    return (cada_update.fused_amsgrad_flat.launches,
            cada_update.batched_diff_sq_norm_flat.launches,
            cada_update.batched_sq_norm_flat.launches,
            cada_update.diff_sq_norm_flat.launches)


def test_cpu_tensors_take_the_plain_route(rng):
    before = _launch_counts()
    x = torch.ones(16)
    ops.fused_amsgrad_flat(x, x, x, x, 0.1)
    ops.batched_diff_sq_norm(x[None], x[None])
    ops.batched_sq_norm(x[None])
    ops.diff_sq_norm_flat(x, x)
    ops.diff_sq_norm({"x": x}, {"x": x})
    assert _launch_counts() == before


def test_kernel_route_refuses_cpu_tensors():
    """impl='kernel' and the CUDA wrappers raise on a CPU tensor: there is
    no silent fallback to the plain version."""
    x = torch.ones(16)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.fused_amsgrad_flat(x, x, x, x, 0.1, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.batched_diff_sq_norm(x[None], x[None], impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cada_update.fused_amsgrad_flat(x, x, x, x, 0.1)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cada_update.batched_diff_sq_norm_flat(x[None], x[None])
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.batched_sq_norm(x[None], impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.diff_sq_norm_flat(x, x, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cada_update.batched_sq_norm_flat(x[None])
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cada_update.diff_sq_norm_flat(x, x)
    with pytest.raises(ValueError, match="impl"):
        ops.batched_diff_sq_norm(x[None], x[None], impl="auto")


def test_plain_impl_is_honoured_on_cpu(rng):
    a = torch.from_numpy(rng.normal(size=(2, 24)).astype(np.float32))
    assert torch.equal(ops.batched_diff_sq_norm(a, a * 2, impl="plain"),
                       ref.batched_diff_sq_norm_ref(a, a * 2))


def test_launch_geometry_depends_on_n_only():
    """The kernels' partial-sum layout is a function of n alone (row
    independence and run-to-run determinism rest on it), within the caps
    the fixed-order second pass assumes."""
    for n in (1, 48, 101_776, 10 ** 9):
        assert 1 <= cada_update.amsgrad_blocks(n) <= \
            cada_update.AMSGRAD_MAX_BLOCKS
        assert 1 <= cada_update.row_chunks(n) <= cada_update.ROW_MAX_CHUNKS
    assert cada_update.amsgrad_blocks(101_776) == 398
    assert cada_update.row_chunks(101_776) == 100
