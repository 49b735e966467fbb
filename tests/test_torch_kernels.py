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
  * bf16 moments, and θ' where θ is bf16: that one-ULP fp32 gap can flip
    the bf16 rounding of an element. A flipped element differs by one bf16
    ULP (at most 2⁻⁷ relative; for θ' also at most the fp32 θ's 2⁻²⁰ ·
    max|ref|, which covers a θ + upd that cancels to near 0, where the
    gap is all of θ') and at most 0.1% of the moments' elements
    may flip; θ is compared where the stored moments agree (the stored
    moment drives the update by contract). bf16 g is upcast exactly on
    both sides, but with h and g both bf16 the fp32 value of
    β1·h + (1−β1)·g lands within that FMA gap of a bf16 rounding boundary
    far more often (measured 0.17–0.23% of h' flipped, at n = 65,536 over
    4 seeds, against ≤ 0.005% with fp32 g), so there the flip budget is
    0.5%. Where β1·h and (1−β1)·g cancel to near 0 the FMA gap is all of
    h' (seen: 3e-9 against 0 with bf16 g, 9e-10 against 4e-8 with fp32 g),
    so in the cases with bf16 θ or g a bf16 moment may also differ by the
    fp32 moments' band, 2⁻²⁰ · max|ref|.
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


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _amsgrad_inputs(rng, n, moment_dtype, theta_dtype=jnp.float32,
                    grad_dtype=jnp.float32):
    theta = rng.normal(size=n).astype(np.float32)
    h = (rng.normal(size=n) * 0.1).astype(np.float32)
    vhat = np.abs(rng.normal(size=n) * 0.01).astype(np.float32)
    grad = rng.normal(size=n).astype(np.float32)
    # round each operand to its storage dtype once, on the JAX side
    theta = np.asarray(jnp.asarray(theta).astype(theta_dtype))
    h = np.asarray(jnp.asarray(h).astype(moment_dtype))
    vhat = np.asarray(jnp.asarray(vhat).astype(moment_dtype))
    grad = np.asarray(jnp.asarray(grad).astype(grad_dtype))
    return theta, h, vhat, grad


# (moments, θ, g) dtypes; the fp32 θ and g cases keep their ids
_AMSGRAD_DTYPES = [
    pytest.param(m, t, g, id=m if (t, g) == ("float32", "float32")
                 else f"{m}-theta_{t}-grad_{g}")
    for m in ("float32", "bfloat16")
    for t in ("float32", "bfloat16") for g in ("float32", "bfloat16")]


@pytest.mark.parametrize("n", [48, BLOCK, BLOCK + 8, 2 * BLOCK + 4464])
@pytest.mark.parametrize("moment_dtype,theta_dtype,grad_dtype",
                         _AMSGRAD_DTYPES)
def test_amsgrad_ref_matches_pallas(n, moment_dtype, theta_dtype,
                                    grad_dtype):
    """amsgrad_ref vs the Pallas _amsgrad_kernel on a whole 32768-element
    block and on lengths that are not a multiple of it, with θ and g each
    fp32 or bf16 (the reference's trainer steps bf16 parameters). Each case
    draws its own inputs, whatever runs before it."""
    rng = np.random.default_rng([n, len(moment_dtype), len(theta_dtype),
                                 len(grad_dtype)])
    theta, h, vhat, grad = _amsgrad_inputs(
        rng, n, _JDT[moment_dtype], _JDT[theta_dtype], _JDT[grad_dtype])
    lr = 0.01
    j_theta, j_h, j_vhat, j_sq = jops.fused_amsgrad_flat(
        jnp.asarray(theta), jnp.asarray(h), jnp.asarray(vhat),
        jnp.asarray(grad), lr, interpret=True)
    t_theta, t_h, t_vhat, t_sq = ops.fused_amsgrad_flat(
        *(tensor_from_numpy(a, "cpu") for a in (theta, h, vhat, grad)), lr)
    assert t_h.dtype == t_vhat.dtype == _TDT[moment_dtype]
    assert t_theta.dtype == _TDT[theta_dtype]
    assert j_theta.dtype == _JDT[theta_dtype]
    same = np.ones(n, bool)
    for j, t in ((j_h, t_h), (j_vhat, t_vhat)):
        j, t = _f32(j), t.float().numpy()
        if moment_dtype == "bfloat16":
            diff = j != t
            low = "bfloat16" in (theta_dtype, grad_dtype)
            assert diff.mean() <= (
                5e-3 if grad_dtype == "bfloat16" else 1e-3)
            np.testing.assert_allclose(
                t, j, rtol=2.0 ** -7,
                atol=ULP_SCALE * np.abs(j).max() if low else 0)
            same &= ~diff
        else:
            np.testing.assert_allclose(
                t, j, rtol=0, atol=ULP_SCALE * np.abs(j).max())
    jt, tt = _f32(j_theta), t_theta.float().numpy()
    if theta_dtype == "bfloat16":
        # one bf16 ULP, or the fp32 θ's band where θ + upd cancels
        np.testing.assert_allclose(tt[same], jt[same], rtol=2.0 ** -7,
                                   atol=ULP_SCALE * np.abs(jt).max())
    else:
        np.testing.assert_allclose(tt[same], jt[same], rtol=0,
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


def test_eq3_row_mean_bf16_plane_bit_equal(rng):
    """A bf16 wire plane (bf16 CADA state) widens exactly and sums in the
    same order: the same bits as the reference."""
    plane = rng.normal(size=(5, 777)).astype(np.float32)
    plane[2] = 0.0
    jplane = jnp.asarray(plane, jnp.bfloat16)
    want = np.asarray(jops.eq3_row_mean(jplane, 5))
    got = ops.eq3_row_mean(
        torch.from_numpy(plane).to(torch.bfloat16), 5).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_eq3_row_mean_takes_the_plain_route_on_cpu_and_no_fallback(rng):
    """A CPU plane takes the plain loop and launches nothing;
    ``impl="kernel"`` and the CUDA wrapper raise on it."""
    plane = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    before = cada_update.eq3_row_mean_flat.launches
    assert torch.equal(ops.eq3_row_mean(plane, 4),
                       ref.eq3_row_mean_ref(plane, 4))
    assert torch.equal(ops.eq3_row_mean(plane, 4, impl="plain"),
                       ref.eq3_row_mean_ref(plane, 4))
    assert cada_update.eq3_row_mean_flat.launches == before
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.eq3_row_mean(plane, 4, impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cada_update.eq3_row_mean_flat(plane, 4)


def test_eq3_row_mean_grid_covers_every_column():
    """One pack of ROW_PACK columns per thread until the cap, then a
    grid-stride loop: every column has a thread."""
    threads, pack = cada_update.THREADS, cada_update.ROW_PACK
    for n in (1, 8, 9, 101_776, 616_581_120, 10 ** 10):
        blocks = cada_update.mean_blocks(n)
        assert 1 <= blocks <= cada_update.MEAN_MAX_BLOCKS
        packs = -(-n // pack)
        assert blocks == min(-(-packs // threads),
                             cada_update.MEAN_MAX_BLOCKS)


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
    under which the last block adds every partial in one pass: at most 4
    per thread for AMSGrad's Σupd², at most 1 per thread for a row."""
    threads = cada_update.THREADS
    assert cada_update.AMSGRAD_MAX_BLOCKS <= 4 * threads
    assert cada_update.ROW_MAX_CHUNKS <= threads
    for n in (1, 8, 9, 48, 2048, 2049, 101_776, 2 ** 24, 2 ** 28, 10 ** 9):
        blocks, chunks = (cada_update.amsgrad_blocks(n),
                          cada_update.row_chunks(n))
        assert 1 <= blocks <= cada_update.AMSGRAD_MAX_BLOCKS
        assert 1 <= chunks <= cada_update.ROW_MAX_CHUNKS
        # one pack per thread until the cap, then a grid-stride loop: no
        # block is left without a pack
        packs = -(-n // cada_update.AMSGRAD_PACK)
        assert blocks == min(-(-packs // threads),
                             cada_update.AMSGRAD_MAX_BLOCKS)
        packs = -(-n // cada_update.ROW_PACK)
        assert chunks == min(-(-packs // threads),
                             cada_update.ROW_MAX_CHUNKS)
    # the main path's n_flat: every thread one pack; LM widths: the caps
    assert cada_update.amsgrad_blocks(101_776) == 100
    assert cada_update.row_chunks(101_776) == 50
    assert cada_update.amsgrad_blocks(2 ** 28) == 1024
    assert cada_update.row_chunks(2 ** 24) == 256


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_flags_follow_alignment(dtype):
    """A pack moves as 16-byte vectors only where every operand (and every
    row of a plane) starts on 16 bytes; views at other offsets take the
    scalar loads, which add the same elements in the same order."""
    es = torch.empty((), dtype=dtype).element_size()
    step = 16 // es                  # elements per 16 bytes
    base = torch.zeros(4096 + 64, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    whole = base[:4096]
    assert cada_update.vector_ok(whole)
    assert cada_update.vector_ok(base[step:step + 4096])
    for off in range(1, step):
        view = base[off:off + 4096]
        assert view.is_contiguous() and not cada_update.vector_ok(view)
        assert not cada_update.vector_ok(whole, view)
    # planes: a row of n elements starts on 16 bytes iff n·size does
    assert cada_update.rows_vector_ok(whole.view(4, 1024))
    assert not cada_update.rows_vector_ok(base[:4 * 1025 - 1][:4 * 1023]
                                          .view(4, 1023))
    assert cada_update.rows_vector_ok(base[:1023].view(1, 1023))
    assert not cada_update.rows_vector_ok(base[1:1024].view(1, 1023))
    assert not cada_update.rows_vector_ok(whole.view(4, 1024),
                                          base[1:4097].view(4, 1024))
