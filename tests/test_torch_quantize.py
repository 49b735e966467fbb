"""The port's wire compressors against the JAX package's, bit for bit.

``repro_torch.core.quantize`` (the dict forms) and the flat twins of
``repro_torch.core.flat`` get the same numpy inputs as ``repro.core.quantize``
and ``repro.core.flat``. Contract: every output is BIT-equal (compared as
uint32 words; int64 positions against the reference's int32 as integers).
That holds because the port writes the quantizer in the reference's
expression order (``round(x / s · L) · s / L``, half to even) with an exact
max-abs scale, and breaks top-k ties toward the lower index with a stable
sort, as ``lax.top_k`` does. The tie-heavy cases use small integers, so most
magnitudes tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as jflat
from repro.core import quantize as jq
from repro_torch.convert import params_from_numpy
from repro_torch.core import flat as tflat
from repro_torch.core import quantize as tq

torch.set_num_threads(1)

BITS = [2, 4, 8, 16]
MLP = {"w1": (784, 128), "b1": (128,), "w2": (128, 10), "b2": (10,)}
SMALL = {"w": (22, 3), "b": (3,), "s": ()}        # n = 72 → no padding
ODD = {"w": (7, 5), "b": (5,), "z": {"c": (3,)}}  # n = 43 → 5 padding lanes


def _same_bits(got, want):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        f"{int((got.view(np.uint32) != want.view(np.uint32)).sum())} "
        "entries differ")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _tree(rng, spec, m=None, ties=False):
    if isinstance(spec, dict):
        return {k: _tree(rng, v, m, ties) for k, v in spec.items()}
    shape = spec if m is None else (m,) + spec
    if ties:
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return (rng.normal(size=shape) * rng.uniform(0.1, 10.0)).astype(
        np.float32)


def _layouts(spec):
    zeros = jax.tree.map(lambda s: np.zeros(s, np.float32), spec,
                         is_leaf=lambda s: isinstance(s, tuple))
    return (jflat.layout_of(jax.tree.map(jnp.asarray, zeros)),
            tflat.layout_of(params_from_numpy(zeros, "cpu")))


def _plane(rng, layout, m, ties=False):
    """An (M, n_flat) plane with a NONZERO padding tail, so pass-through of
    the tail is checked too."""
    shape = (m, layout.n_flat)
    if ties:
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------- dict forms

@pytest.mark.parametrize("bits", [0] + BITS + [32])
def test_quantize_dequantize_bit_equal(bits):
    rng = np.random.default_rng(bits)
    tree = _tree(rng, SMALL)
    want = jq.quantize_dequantize(jax.tree.map(jnp.asarray, tree), bits)
    got = tq.quantize_dequantize(params_from_numpy(tree, "cpu"), bits)
    for g, w in zip(_leaves(got), _leaves(want)):
        _same_bits(g, w)


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("bits", BITS)
def test_per_worker_quantize_dequantize_bit_equal(bits, ties):
    rng = np.random.default_rng(bits + 10 * ties)
    tree = _tree(rng, SMALL, m=4, ties=ties)     # "s" is an (M,) leaf
    tree["w"][2] = 0.0                           # an all-zero worker row
    want = jq.per_worker_quantize_dequantize(
        jax.tree.map(jnp.asarray, tree), bits)
    got = tq.per_worker_quantize_dequantize(params_from_numpy(tree, "cpu"),
                                            bits)
    for g, w in zip(_leaves(got), _leaves(want)):
        _same_bits(g, w)


@pytest.mark.parametrize("frac", [1e-6, 0.05, 0.1, 1 / 3, 0.5, 1.0])
def test_topk_count_matches(frac):
    for size in (1, 2, 3, 10, 97, 101_770):
        assert tq.topk_count(size, frac) == jq.topk_count(size, frac)


@pytest.mark.parametrize("k", [1, 3, 7, 16, 40])
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
def test_topk_threshold_mask_exact_k_and_ties(k, ties):
    rng = np.random.default_rng(k + 100 * ties)
    x = (rng.integers(-3, 4, size=(6, 40)) if ties
         else rng.normal(size=(6, 40))).astype(np.float32)
    x[1] = 0.0                                   # a row of pure ties
    want = np.asarray(jq.topk_threshold_mask(jnp.asarray(x), k))
    got = tq.topk_threshold_mask(torch.from_numpy(x), k).numpy()
    assert np.array_equal(got, want)
    assert (got.sum(axis=1) == min(k, 40)).all()


@pytest.mark.parametrize("frac", [0.05, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
def test_per_worker_topk_sparsify_bit_equal(frac, ties):
    rng = np.random.default_rng(int(frac * 100) + ties)
    tree = _tree(rng, SMALL, m=3, ties=ties)
    want = jq.per_worker_topk_sparsify(jax.tree.map(jnp.asarray, tree), frac)
    got = tq.per_worker_topk_sparsify(params_from_numpy(tree, "cpu"), frac)
    for g, w in zip(_leaves(got), _leaves(want)):
        _same_bits(g, w)


@pytest.mark.parametrize("form", ["tree", "plane"])
def test_error_feedback_transitions_bit_equal(form):
    rng = np.random.default_rng(7)
    spec = SMALL if form == "tree" else (24,)
    delta, residual, wire = (_tree(rng, spec, m=5) for _ in range(3))
    upload = np.array([True, False, True, True, False])

    def j(t):
        return jax.tree.map(jnp.asarray, t)

    def t(x):
        return params_from_numpy(x, "cpu")

    want_c = jq.ef_correct(j(delta), j(residual))
    got_c = tq.ef_correct(t(delta), t(residual))
    want_r = jq.ef_residual(want_c, j(wire), jnp.asarray(upload), j(residual))
    got_r = tq.ef_residual(got_c, t(wire), torch.from_numpy(upload),
                           t(residual))
    for g, w in zip(_leaves(got_c) + _leaves(got_r),
                    _leaves(want_c) + _leaves(want_r)):
        _same_bits(g, w)


# -------------------------------------------------------------- flat twins

@pytest.mark.parametrize("spec", [MLP, ODD], ids=["mlp", "odd"])
def test_segment_ids_match(spec):
    j_layout, t_layout = _layouts(spec)
    assert np.array_equal(tflat._segment_ids(t_layout),
                          jflat._segment_ids(j_layout))


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("spec", [MLP, ODD], ids=["mlp", "odd"])
def test_flat_quantizer_bit_equal(spec, bits, ties):
    """One max-abs scale per (worker, leaf segment), the padding tail passed
    through: the paper MLP's full layout (M = 10) and a padded one."""
    rng = np.random.default_rng(bits + 50 * ties)
    j_layout, t_layout = _layouts(spec)
    m = 10 if spec is MLP else 4
    for _ in range(2):
        x = _plane(rng, j_layout, m, ties)
        want = jflat.per_worker_quantize_dequantize_flat(
            j_layout, jnp.asarray(x), bits)
        got = tflat.per_worker_quantize_dequantize_flat(
            t_layout, torch.from_numpy(x), bits)
        _same_bits(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_flat_quantizer_equals_its_dict_form(bits):
    """Inside the port: the flat quantizer equals the dict form leaf by
    leaf (the reference pins the same pair)."""
    rng = np.random.default_rng(bits)
    tree = params_from_numpy(_tree(rng, ODD, m=3), "cpu")
    layout = tflat.layout_of({k: v[0] if torch.is_tensor(v)
                              else {kk: vv[0] for kk, vv in v.items()}
                              for k, v in tree.items()})
    flat = tflat.per_worker_quantize_dequantize_flat(
        layout, layout.pack_worker(tree), bits)
    _same_bits(flat, layout.pack_worker(
        tq.per_worker_quantize_dequantize(tree, bits)))


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("spec", [MLP, ODD], ids=["mlp", "odd"])
def test_flat_topk_sparsify_bit_equal(spec, frac, ties):
    rng = np.random.default_rng(int(frac * 100) + ties)
    j_layout, t_layout = _layouts(spec)
    m = 10 if spec is MLP else 4
    x = _plane(rng, j_layout, m, ties)
    want = jflat.per_worker_topk_sparsify_flat(j_layout, jnp.asarray(x),
                                               frac)
    got = tflat.per_worker_topk_sparsify_flat(t_layout, torch.from_numpy(x),
                                              frac)
    _same_bits(got, want)


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("spec", [MLP, ODD], ids=["mlp", "odd"])
def test_flat_topk_extract_and_scatter_round_trip(spec, ties):
    """The sparse wire of a sparsified plane: the same (values, positions)
    as the reference's, and scattered back it is the plane bit for bit."""
    rng = np.random.default_rng(3 + ties)
    j_layout, t_layout = _layouts(spec)
    frac = 0.1
    m = 10 if spec is MLP else 4
    x = _plane(rng, j_layout, m, ties)
    x[:, j_layout.n:] = 0.0          # a compressor output's tail is zero
    sp_j = jflat.per_worker_topk_sparsify_flat(j_layout, jnp.asarray(x),
                                               frac)
    sp_t = tflat.per_worker_topk_sparsify_flat(t_layout, torch.from_numpy(x),
                                               frac)
    jv, ji = jflat.per_worker_topk_extract_flat(j_layout, sp_j, frac)
    tv, ti = tflat.per_worker_topk_extract_flat(t_layout, sp_t, frac)
    assert ti.dtype == torch.int64
    assert np.array_equal(ti.numpy(), np.asarray(ji).astype(np.int64))
    _same_bits(tv, jv)
    dense_t = tflat.sparse_rows_to_dense(ti, tv, t_layout.n_flat)
    _same_bits(dense_t, jflat.sparse_rows_to_dense(ji, jv, j_layout.n_flat))
    _same_bits(dense_t, sp_t)
