"""The port's flat layout against the reference's ``layout_of``, and
pack/unpack round trips."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flat import layout_of as jax_layout_of
from repro_torch.convert import params_from_numpy
from repro_torch.core.flat import PAD_ALIGN, layout_of

torch.set_num_threads(1)

TREES = {
    "logreg": {"w": (22, 2), "b": (2,)},
    "mlp": {"w1": (784, 16), "b1": (16,), "w2": (16, 10), "b2": (10,)},
    "nested": {"z": {"b": (3, 5), "a": ()}, "a": (7,)},
}


def _tree(rng, spec):
    if isinstance(spec, dict):
        return {k: _tree(rng, v) for k, v in spec.items()}
    return rng.normal(size=spec).astype(np.float32)


@pytest.mark.parametrize("name", sorted(TREES))
def test_offsets_match_reference(rng, name):
    tree = _tree(rng, TREES[name])
    ours = layout_of(params_from_numpy(tree, "cpu"))
    ref = jax_layout_of(jax.tree.map(jnp.asarray, tree))
    assert ours.offsets == ref.offsets
    assert ours.sizes == ref.sizes
    assert ours.shapes == ref.shapes
    assert (ours.n, ours.n_flat) == (ref.n, ref.n_flat)
    assert ours.n_flat % PAD_ALIGN == 0
    # the packed planes line up element for element
    buf = ours.pack(params_from_numpy(tree, "cpu"))
    assert np.array_equal(buf.numpy(),
                          np.asarray(ref.pack(jax.tree.map(jnp.asarray,
                                                           tree))))


@pytest.mark.parametrize("name", sorted(TREES))
def test_pack_unpack_roundtrip(rng, name):
    tree = params_from_numpy(_tree(rng, TREES[name]), "cpu")
    layout = layout_of(tree)
    buf = layout.pack(tree)
    assert buf.shape == (layout.n_flat,)
    assert torch.equal(buf[layout.n:], torch.zeros(layout.n_flat - layout.n))
    back = layout.unpack(buf)
    assert torch.equal(layout.pack(back), buf)
    flat_a = [v for _, v in sorted(_items(back))]
    flat_b = [v for _, v in sorted(_items(tree))]
    assert all(torch.equal(a, b) for a, b in zip(flat_a, flat_b))


def _items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_pack_worker_and_bf16_cast_roundtrip(rng):
    m = 3
    tree = {"w": torch.from_numpy(rng.normal(size=(m, 4, 5)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(m, 5)).astype(
            np.float32))}
    layout = layout_of({k: v[0] for k, v in tree.items()})
    plane = layout.pack_worker(tree)
    assert plane.shape == (m, layout.n_flat)
    for r in range(m):
        assert torch.equal(plane[r], layout.pack({k: v[r]
                                                  for k, v in tree.items()}))
    mixed = {"w": tree["w"][0].to(torch.bfloat16), "b": tree["b"][0]}
    ml = layout_of(mixed)
    buf = ml.pack(mixed)
    buf[:ml.n] += 1e-3          # off the bf16 grid; the zero tail stays
    rt = ml.cast_roundtrip(buf)
    assert torch.equal(ml.pack(ml.unpack(rt)), rt)
    assert not torch.equal(rt, buf)
    assert ml.unpack(rt)["w"].dtype == torch.bfloat16
