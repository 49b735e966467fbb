"""The port's checkpoints against the JAX package's: the same format
(``arrays.npz`` and a version-1 ``manifest.json`` with the same paths,
shapes, dtypes and flat layout), so a checkpoint written by either package
restores into the other.

States: engine states of cada2 (the stale-iterate ring), laq (the residual
plane) and local_momentum (the momenta plane, the SGD server's bare count)
on logreg, and a trainer state of stablelm's smoke config with bf16
moments and CADA state. Round trips port → port, JAX → port and port → JAX
must give every leaf back bit for bit (bf16 by its bits), the step as a
Python int in the port and an int32 0-d array in the reference.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.checkpoint import io as jax_ckpt
from repro.core.engine import CADAEngine as JaxEngine
from repro.core.rules import CommRule as JaxRule
from repro.distributed import trainer as JT
from repro.models.small import logreg_loss as jax_logreg_loss
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.checkpoint import io as ckpt
from repro_torch.core.engine import CADAEngine
from repro_torch.core.rules import CommRule
from repro_torch.data import ijcnn1_like, pad_to_matrix, uniform_partition
from repro_torch.distributed import trainer as TT
from repro_torch.models.small import logreg_loss

torch.set_num_threads(1)

M = 3
KINDS = ["cada2", "laq", "local_momentum"]


def _batches(rounds=3):
    ds = ijcnn1_like(n=200)
    mtx = pad_to_matrix(uniform_partition(ds.n, M, seed=0))
    rng = np.random.default_rng(0)
    ids = mtx[np.arange(M)[None, :, None],
              rng.integers(0, mtx.shape[1], (rounds, M, 8))]
    return ds.x[ids], ds.y[ids]


def _rule(kind):
    return dict(kind=kind, c=0.5, d_max=4, max_delay=6, local_lr=0.05)


def _jax_engine_state(kind, rounds=3):
    """The JAX engine's state after ``rounds`` rounds, and its engine."""
    eng = JaxEngine(jax_logreg_loss, None, JaxRule(**_rule(kind)), M)
    params = {"w": jnp.zeros((22, 2)), "b": jnp.zeros((2,))}
    st = eng.init(params)
    bx, by = _batches(rounds)
    step = jax.jit(eng.step)
    for i in range(rounds):
        st, _ = step(st, (jnp.asarray(bx[i]), jnp.asarray(by[i])))
    return eng, st


def _port_engine_state(kind, rounds=3):
    eng = CADAEngine(logreg_loss, None, CommRule(**_rule(kind)), M,
                     device="cpu")
    st = eng.init({"w": torch.zeros(22, 2), "b": torch.zeros(2)})
    bx, by = _batches(rounds)
    for i in range(rounds):
        st, _ = eng.step(st, (torch.from_numpy(bx[i]),
                              torch.from_numpy(by[i])))
    return eng, st


def _bits(x):
    """A leaf as comparable numpy bits (bf16 as its uint16 pattern)."""
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a


def _assert_same_leaves(port_state, jax_state):
    paths, leaves = ckpt._flatten_with_paths(port_state)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jax_state)
    assert paths == ["/".join(str(k) for k in p) for p, _ in jflat]
    for p, a, (_, b) in zip(paths, leaves, jflat):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape and a.dtype == b.dtype, p
        assert np.array_equal(a, b), p


def _zeros_like(state):
    """A port state of the same structure with every tensor zeroed and
    every int 0: a fresh ``like``."""
    paths, leaves = ckpt._flatten_with_paths(state)
    return ckpt._unflatten(state, iter(
        torch.zeros_like(x) if torch.is_tensor(x) else 0 for x in leaves))


@pytest.mark.parametrize("kind", KINDS)
def test_engine_state_port_to_port(tmp_path, kind):
    eng, st = _port_engine_state(kind)
    ckpt.save(str(tmp_path / "step_3"), st, step=3)
    back, step = ckpt.restore(str(tmp_path / "step_3"), _zeros_like(st))
    assert step == 3 and back.step == 3 and isinstance(back.step, int)
    for (p, a), b in zip(zip(*ckpt._flatten_with_paths(st)),
                         ckpt._flatten_with_paths(back)[1]):
        assert type(a) is type(b), p
        assert np.array_equal(_bits(a), _bits(b)), p
    # the restored state resumes as the saved one does
    bx, by = _batches(4)
    batch = (torch.from_numpy(bx[3]), torch.from_numpy(by[3]))
    (s1, m1), (s2, m2) = eng.step(st, batch), eng.step(back, batch)
    assert torch.equal(m1["upload_mask"], m2["upload_mask"])
    assert torch.equal(s1.params_flat, s2.params_flat)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_state_jax_to_port(tmp_path, kind):
    _, jst = _jax_engine_state(kind)
    jax_ckpt.save(str(tmp_path / "j"), jst, step=3)
    like = _zeros_like(convert.engine_state_from_numpy(
        jax.tree.map(np.asarray, jst), "cpu"))
    back, step = ckpt.restore(str(tmp_path / "j"), like)
    assert step == 3 and back.step == 3
    _assert_same_leaves(back, jst)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_state_port_to_jax(tmp_path, kind):
    _, st = _port_engine_state(kind)
    ckpt.save(str(tmp_path / "t"), st, step=3)
    jeng, jst = _jax_engine_state(kind, rounds=0)
    back, step = jax_ckpt.restore(str(tmp_path / "t"), jst)
    assert step == 3 and int(back.step) == 3
    _assert_same_leaves(st, back)
    # the JAX engine resumes from the port's state
    bx, by = _batches(4)
    jax.jit(jeng.step)(back, (jnp.asarray(bx[3]), jnp.asarray(by[3])))


def test_manifest_is_the_references(tmp_path):
    """The same state written by both packages: the same manifest."""
    jeng, jst = _jax_engine_state("local_momentum")
    st = convert.engine_state_from_numpy(jax.tree.map(np.asarray, jst),
                                         "cpu")
    jax_ckpt.save(str(tmp_path / "j"), jst, step=3)
    ckpt.save(str(tmp_path / "t"), st, step=3)
    man = [json.load(open(tmp_path / d / "manifest.json")) for d in "jt"]
    assert man[0] == man[1]
    assert ".comm/.extras/['momenta']" in man[1]["paths"]


def _trainer_states():
    """(JAX state, port state) of stablelm's smoke trainer after one step,
    bf16 moments and CADA state, fp32 params; the port's converted from
    the reference's."""
    hp_kw = dict(moments_dtype="bfloat16", cada_dtype="bfloat16", lr=1e-3)
    rule_kw = dict(kind="cada2", c=0.5, d_max=4, max_delay=10)
    cfg = JC.get_smoke_config("stablelm-1.6b")
    jhp = JT.TrainHParams(rule=JaxRule(**rule_kw), **hp_kw)
    st = JT.init_train_state(cfg, jhp, 2, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 33))
    st, _ = jax.jit(JT.make_train_step(cfg, jhp, 2))(
        st, JT.worker_split({"tokens": jnp.asarray(toks, jnp.int32)}, 2))
    return st, convert.train_state_from_numpy(jax.tree.map(np.asarray, st),
                                              "cpu")


def test_trainer_state_crosses_both_ways(tmp_path):
    jst, st = _trainer_states()
    assert st.h.dtype == torch.bfloat16
    assert st.comm.worker_grads.dtype == torch.bfloat16
    jax_ckpt.save(str(tmp_path / "j"), jst, step=1)
    back, _ = ckpt.restore(str(tmp_path / "j"), _zeros_like(st))
    _assert_same_leaves(back, jst)
    ckpt.save(str(tmp_path / "t"), back, step=1)
    jback, _ = jax_ckpt.restore(str(tmp_path / "t"),
                                jax.tree.map(jnp.zeros_like, jst))
    _assert_same_leaves(back, jback)
    # the port's trainer resumes from it
    cfg = TC.get_smoke_config("stablelm-1.6b")
    hp = TT.TrainHParams(rule=CommRule(kind="cada2", c=0.5, d_max=4,
                                       max_delay=10), lr=1e-3,
                         moments_dtype="bfloat16", cada_dtype="bfloat16")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 33)))
    _, mets = TT.make_train_step(cfg, hp, 2)(back, TT.worker_split(
        {"tokens": toks}, 2))
    assert torch.isfinite(mets["loss"])


def test_bf16_leaf_bits_survive(tmp_path):
    """Every finite bf16 bit pattern (normals, subnormals, ±0, ±inf) is
    stored widened to fp32 and narrowed back to the same bits, in the port
    and through the reference's restore."""
    bits = np.arange(-2 ** 15, 2 ** 15, dtype=np.int32).astype(np.int16)
    t = torch.from_numpy(bits).view(torch.bfloat16)
    t = t[~torch.isnan(t)]
    ckpt.save(str(tmp_path / "b"), {"x": t})
    stored = np.load(tmp_path / "b" / "arrays.npz")["leaf_0"]
    assert stored.dtype == np.float32
    back, _ = ckpt.restore(str(tmp_path / "b"), {"x": torch.zeros_like(t)})
    assert back["x"].dtype == torch.bfloat16
    assert torch.equal(back["x"].view(torch.int16), t.view(torch.int16))
    jback, _ = jax_ckpt.restore(str(tmp_path / "b"),
                                {"x": jnp.zeros(t.shape, jnp.bfloat16)})
    assert np.array_equal(np.asarray(jback["x"]).view(np.int16),
                          t.view(torch.int16).numpy())


def test_dtype_mismatch_names_the_leaf(tmp_path):
    ckpt.save(str(tmp_path / "s"), {"ok": torch.zeros(2),
                                    "m": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtype mismatch") as ours:
        ckpt.restore(str(tmp_path / "s"),
                     {"ok": torch.zeros(2),
                      "m": torch.zeros(4, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="dtype mismatch") as ref:
        jax_ckpt.restore(str(tmp_path / "s"),
                         {"ok": jnp.zeros(2), "m": jnp.zeros(4, jnp.bfloat16)})
    assert str(ours.value) == str(ref.value)
    assert "['m']" in str(ours.value)


def test_structure_and_shape_mismatches_raise(tmp_path):
    ckpt.save(str(tmp_path / "s"), {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore(str(tmp_path / "s"), {"zz": torch.zeros(3)})
    with pytest.raises(ValueError, match=r"shape mismatch at \['a'\]"):
        ckpt.restore(str(tmp_path / "s"), {"a": torch.zeros(4)})
    _, st = _port_engine_state("cada2", rounds=1)
    ckpt.save(str(tmp_path / "e"), st)
    _, other = _port_engine_state("laq", rounds=0)
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore(str(tmp_path / "e"), other)


def test_flat_reshard_of_a_sharded_jax_state(tmp_path):
    """A JAX trainer state saved on a 3-shard layout (its n_flat padded
    further) restores into the port's one-device layout: the true entries
    of every plane kept, the zero padding re-cut."""
    cfg = JC.get_smoke_config("stablelm-1.6b")
    jhp = JT.TrainHParams(rule=JaxRule(kind="laq", c=0.5, d_max=4,
                                       max_delay=10), lr=1e-3)
    lay3 = JT.flat_layout(cfg, shards=3)
    jst = JT.init_train_state(cfg, jhp, 2, jax.random.PRNGKey(0), shards=3)
    jst = jst._replace(h=jst.h.at[:lay3.n].set(0.5))
    jax_ckpt.save(str(tmp_path / "j"), jst, step=0, flat_meta=lay3)
    thp = TT.TrainHParams(rule=CommRule(kind="laq", c=0.5, d_max=4,
                                        max_delay=10), lr=1e-3)
    like = TT.init_train_state(TC.get_smoke_config("stablelm-1.6b"), thp, 2,
                               0, "cpu")
    n, n_flat = lay3.n, like.h.shape[0]
    assert lay3.n_flat > n_flat >= n
    back, _ = ckpt.restore(str(tmp_path / "j"), like)
    assert back.h.shape == (n_flat,)
    assert bool((back.h[:n] == 0.5).all()) and bool((back.h[n:] == 0).all())
    assert back.comm.extras["residual"].shape == (2, n_flat)


def test_flat_reshard_refuses_a_nonzero_tail(tmp_path):
    plane = np.zeros((2, 16), np.float32)
    plane[:, :10] = 1.0
    ckpt.save(str(tmp_path / "ok"), {"p": torch.from_numpy(plane)},
              flat_meta={"n": 10, "n_flat": 16})
    back, _ = ckpt.restore(str(tmp_path / "ok"), {"p": torch.zeros(2, 12)})
    assert torch.equal(back["p"][:, :10], torch.ones(2, 10))
    assert torch.equal(back["p"][:, 10:], torch.zeros(2, 2))
    plane[1, 13] = 3.0
    ckpt.save(str(tmp_path / "bad"), {"p": torch.from_numpy(plane)},
              flat_meta={"n": 10, "n_flat": 16})
    with pytest.raises(ValueError, match=r"padding tail.*") as ours:
        ckpt.restore(str(tmp_path / "bad"), {"p": torch.zeros(2, 12)})
    assert "['p']" in str(ours.value)
    with pytest.raises(ValueError, match="only 8 lanes"):
        ckpt.restore(str(tmp_path / "ok"), {"p": torch.zeros(2, 8)})


def test_restore_places_leaves_on_the_device_asked_for(tmp_path):
    """Each tensor goes to ``like``'s device, or to ``device`` where one is
    given; an int leaf stays an int."""
    ckpt.save(str(tmp_path / "s"), {"a": torch.ones(2), "k": 7})
    like = {"a": torch.zeros(2, device="meta"), "k": 0}
    back, _ = ckpt.restore(str(tmp_path / "s"), like)
    assert back["a"].device.type == "meta" and back["k"] == 7
    back, _ = ckpt.restore(str(tmp_path / "s"), like, device="cpu")
    assert back["a"].device.type == "cpu" and back["k"] == 7
    assert torch.equal(back["a"], torch.ones(2))


def test_latest_step_dir(tmp_path):
    assert ckpt.latest_step_dir(str(tmp_path / "none")) is None
    assert ckpt.latest_step_dir(str(tmp_path)) is None
    for s in (1, 10, 2):
        os.makedirs(tmp_path / f"step_{s}")
    assert ckpt.latest_step_dir(str(tmp_path)).endswith("step_10")
    assert ckpt.latest_step_dir(str(tmp_path)) == jax_ckpt.latest_step_dir(
        str(tmp_path))
