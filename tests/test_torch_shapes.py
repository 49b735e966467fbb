"""The port's input shapes and spec builders (``configs/base.py``) against
the JAX package's, and sliding-window decode in lockstep with the
reference.

* ``SHAPES``, ``LONG_CONTEXT_WINDOW`` and ``adapt_for_shape`` equal the
  reference's for all ten configs at full size × the four shapes.
* ``input_specs`` gives the reference's shapes and dtypes leaf for leaf,
  the decode cache included, at full size: the port's tensors lie on the
  ``meta`` device (they allocate nothing), the reference's are
  ``ShapeDtypeStruct``s. The one leaf that is not a tensor in the port is
  the cache's ``index``, a Python int (the reference's is a () int32).
* Sliding-window decode: internlm2-1.8b's and zamba2-2.7b's smoke configs
  with ``sliding_window`` W ∈ {8, 16, 40}, a prompt of 48 tokens (longer
  than every W) and 12 decode steps, which wrap the W-slot ring cache.
  Each step loads the reference's cache into the port
  (``convert.decode_cache_from_numpy``) and feeds both the same token.
  Contract: every float array (the prefill's and each step's logits, the
  K/V, conv and SSM caches) within 1e-5 of its own scale (max |ref|),
  ``slot_pos`` and ``index`` equal, the greedy tokens equal. Both sides are
  fp32 and differ by a few ULP of scale (``tests/test_torch_lm.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs import base as jbase
from repro.models import model as JM
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.models import model as TM

torch.set_num_threads(1)

ARCHS = sorted(JC.list_archs())
RTOL = 1e-5
PROMPT, STEPS = 48, 12


def test_shapes_and_window_equal_the_reference():
    assert tbase.LONG_CONTEXT_WINDOW == jbase.LONG_CONTEXT_WINDOW
    assert (tbase.TRAIN, tbase.PREFILL, tbase.DECODE) == (
        jbase.TRAIN, jbase.PREFILL, jbase.DECODE)
    assert sorted(tbase.SHAPES) == sorted(jbase.SHAPES)
    for name, shape in jbase.SHAPES.items():
        assert dataclasses.asdict(tbase.SHAPES[name]) == \
            dataclasses.asdict(shape)
    assert TC.list_archs() == ARCHS


@pytest.mark.parametrize("shape", sorted(jbase.SHAPES))
def test_adapt_for_shape_equals_the_reference(shape):
    windowed = []
    for arch in ARCHS:
        j = jbase.adapt_for_shape(JC.get_config(arch), jbase.SHAPES[shape])
        t = tbase.adapt_for_shape(TC.get_config(arch), tbase.SHAPES[shape])
        assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
        assert t.subquadratic == j.subquadratic, arch
        if t.sliding_window:
            windowed.append(arch)
    if shape == "long_500k":
        # every full-attention arch, and no SSM or hybrid one
        assert windowed and "falcon-mamba-7b" not in windowed
        assert "zamba2-2.7b" not in windowed
    else:
        assert windowed == []


def _port_leaves(tree, path=()):
    """(path, tensor or int) of a spec tree in the reference's leaf order:
    dicts by sorted key, a DecodeCache by field, None skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k],
                                                             path + (k,))]
    if isinstance(tree, TM.DecodeCache):
        return [x for f in tree._fields
                for x in _port_leaves(getattr(tree, f), path + (f,))]
    if tree is None:
        return []
    return [(path, tree)]


@pytest.mark.parametrize("shape", sorted(jbase.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    want = jbase.input_specs(JC.get_config(arch), jbase.SHAPES[shape])
    got = tbase.input_specs(TC.get_config(arch), tbase.SHAPES[shape])
    w_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    g_leaves = _port_leaves(got)
    assert len(w_leaves) == len(g_leaves), (arch, shape)
    for (w_path, w), (g_path, g) in zip(w_leaves, g_leaves):
        if g_path[-1] == "index":
            assert isinstance(g, int) and g == 0
            assert w.shape == () and w.dtype == jnp.int32
            continue
        assert g.device.type == "meta", g_path
        assert tuple(g.shape) == w.shape, (g_path, w_path)
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g_path, w_path)


def _close(got, want, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max |Δ| {err} > {RTOL} · {scale}"


def _close_cache(t_cache, j_cache, what):
    assert t_cache.index == int(j_cache.index), what
    assert np.array_equal(t_cache.slot_pos.numpy(),
                          np.asarray(j_cache.slot_pos)), what
    for field in ("k", "v", "conv", "ssm"):
        want, got = getattr(j_cache, field), getattr(t_cache, field)
        assert (want is None) == (got is None), (what, field)
        if want is not None:
            _close(got, want, f"{what} cache.{field}")


@pytest.mark.parametrize("window", [8, 16, 40])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b"])
def test_sliding_window_decode_in_lockstep(arch, window):
    jcfg = JC.get_smoke_config(arch).with_(remat=False,
                                           sliding_window=window)
    tcfg = TC.get_smoke_config(arch).with_(sliding_window=window)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(window).integers(
        0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    max_seq = PROMPT + STEPS

    j_last, j_cache = JM.prefill(jcfg, jp, tokens=jnp.asarray(toks),
                                 max_seq=max_seq)
    t_last, t_cache = TM.prefill(tcfg, tp,
                                 torch.as_tensor(toks, dtype=torch.long),
                                 max_seq=max_seq)
    assert t_cache.slot_pos.shape[0] == window
    _close(t_last, j_last, "prefill logits")
    _close_cache(t_cache, j_cache, "prefill")
    for step in range(STEPS):
        tok = np.array(jnp.argmax(j_last, -1))
        assert np.array_equal(torch.argmax(t_last, -1).numpy(), tok), step
        t_cache = convert.decode_cache_from_numpy(
            jax.tree.map(np.asarray, j_cache), "cpu")
        j_last, j_cache = JM.decode_step(jcfg, jp, j_cache,
                                         tokens=jnp.asarray(tok))
        t_last, t_cache = TM.decode_step(
            tcfg, tp, t_cache, torch.as_tensor(tok, dtype=torch.long))
        _close(t_last, j_last, f"decode step {step} logits")
        _close_cache(t_cache, j_cache, f"decode step {step}")
    # the ring wrapped: the oldest live position is max_seq - W
    assert int(t_cache.slot_pos.min()) == max_seq - window
