"""The port's sharding tables, mesh, policy and bootstrap against the JAX
package's, with no process spawned.

The spec functions read a mesh through its ``.shape`` dict only, so both
packages' are held against each other on stub meshes at production shapes
without 512 devices: (data 16, model 16), (pod 2, data 16, model 16),
(data 4, model 1) and (pod 2, data 2, model 1), for all ten configs at
full size. Equality is exact: every PartitionSpec dim (an axis name, a
tuple of them or None) of every leaf, compared as tuples.

  * ``param_pspecs`` (fsdp off, on and resolved by ``wants_fsdp``; FSDP
    over "data" and over ("data", "pod")), ``wants_fsdp``,
    ``batch_pspecs`` of the train and prefill inputs, ``cache_pspecs`` of
    the decode cache;
  * the trainer's ``flat_state_axes``, ``flat_state_shards``, the fused
    ``train_state_specs`` (every rule kind), ``train_batch_specs`` at
    H = 1 and 2, and ``worker_split_abstract``;
  * ``train_policy`` for every config × mesh × rule kind, field for field;
  * ``layout_of(shards=1, 2, 4, 8)``: the reference's ``n_flat``, the
    shard split and merge (``tests/test_flat_plane.py``'s case);
  * ``bootstrap`` without a rendezvous in the environment, ``assert_fleet``
    and ``make_production_mesh`` refusing a one-process world, and the
    mesh's row-major coordinates.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs import base as jbase
from repro.core import flat as JF
from repro.core.rules import CommRule as JaxRule
from repro.distributed import sharding as JS
from repro.distributed import trainer as JT
from repro.launch import policy as JP
import repro_torch.configs as TC
from repro_torch.configs import base as tbase
from repro_torch.core import flat as TF
from repro_torch.core.comm import strategy_kinds
from repro_torch.core.rules import CommRule
from repro_torch.distributed import sharding as TS
from repro_torch.distributed import trainer as TT
from repro_torch.launch import mesh as TM
from repro_torch.launch import multihost
from repro_torch.launch import policy as TP
from repro_torch.utils.trees import tree_leaves, tree_paths

ARCHS = sorted(JC.list_archs())
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x1": {"data": 4, "model": 1},
          "2x2x1": {"pod": 2, "data": 2, "model": 1}}


class Stub:
    """A mesh as the tables read it: its ``.shape`` dict."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _key(k):
    return getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))


def _jax_specs(tree) -> dict:
    """{path: tuple spec} of a tree of jax PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(_key(k) for k in path): tuple(spec)
            for path, spec in flat}


def _port_specs(tree) -> dict:
    """{path: tuple spec} of a dict tree of the port's P (a P is a tuple,
    so the walk stops at it)."""
    return {tuple(p): tuple(spec) for p, spec in zip(tree_paths(tree),
                                                     tree_leaves(tree))}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_and_wants_fsdp_equal_the_reference(arch, mesh):
    stub = Stub(MESHES[mesh])
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert TS.wants_fsdp(tcfg, stub) == JS.wants_fsdp(jcfg, stub)
    for fsdp in (None, False, True):
        for axes in (("data",), ("data", "pod")):
            want = _jax_specs(JS.param_pspecs(jcfg, stub, fsdp, axes))
            got = _port_specs(TS.param_pspecs(tcfg, stub, fsdp, axes))
            assert got == want, (arch, mesh, fsdp, axes)


def _cache_specs(tree) -> dict:
    """{field: tuple spec or None} of a DecodeCache of specs."""
    return {k: (None if v is None else tuple(v))
            for k, v in tree._asdict().items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_equal_the_reference(arch, mesh):
    stub = Stub(MESHES[mesh])
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for shape in ("train_4k", "prefill_32k"):
        jin = jbase.input_specs(jcfg, jbase.SHAPES[shape])
        tin = tbase.input_specs(tcfg, tbase.SHAPES[shape])
        jin, tin = jin.get("batch", jin), tin.get("batch", tin)
        assert _port_specs(TS.batch_pspecs(tin, stub)) == _jax_specs(
            JS.batch_pspecs(jin, stub)), shape
    for shape in ("decode_32k", "long_500k"):
        jc = jbase.input_specs(jcfg, jbase.SHAPES[shape])["cache"]
        tc = tbase.input_specs(tcfg, tbase.SHAPES[shape])["cache"]
        assert _cache_specs(TS.cache_pspecs(tcfg, tc, stub)) == \
            _cache_specs(JS.cache_pspecs(jcfg, jc, stub)), shape


STATE_KNOBS = (dict(), dict(state_fsdp_axes=("data",)),
               dict(state_fsdp_axes=("data", "pod")),
               dict(state_fsdp_axes=("pod", "data")),
               dict(shard_cada_state=True), dict(fsdp=True),
               dict(fsdp=False))


def _hparams(kind: str, knobs=STATE_KNOBS) -> list:
    """Pairs (reference, port) of TrainHParams over the state knobs."""
    return [(JT.TrainHParams(rule=JaxRule(kind=kind), **kw),
             TT.TrainHParams(rule=CommRule(kind=kind), **kw))
            for kw in knobs]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_flat_state_tables_equal_the_reference(arch, mesh):
    """The state axes for every knob; the state's specs for every kind
    with the state unsharded, ZeRO'd over ("data", "pod") and over the
    worker planes' columns (``shard_cada_state``)."""
    stub = Stub(MESHES[mesh])
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert TT.worker_axis_name(stub) == JT.worker_axis_name(stub)
    for jhp, thp in _hparams("cada2"):
        assert TT.flat_state_axes(tcfg, stub, thp) == \
            JT.flat_state_axes(jcfg, stub, jhp)
        assert TT.flat_state_shards(tcfg, stub, thp) == \
            JT.flat_state_shards(jcfg, stub, jhp)
        fs, jfs = (TT.flat_sharding(tcfg, stub, thp),
                   JT.flat_sharding(jcfg, stub, jhp))
        assert (fs.col_axes, fs.plane_axes) == (jfs.col_axes,
                                                jfs.plane_axes)
        assert tuple(fs.server_spec()) == tuple(jfs.server_spec())
        assert tuple(fs.worker_spec()) == tuple(jfs.worker_spec())
    for kind in strategy_kinds():
        for jhp, thp in _hparams(kind, STATE_KNOBS[0:5:2]):
            want = JT.train_state_specs(jcfg, stub, jhp)
            got = TT.train_state_specs(tcfg, stub, thp)
            assert got.step == tuple(want.step) == ()
            assert _port_specs(got.params) == _jax_specs(want.params)
            assert (tuple(got.h), tuple(got.vhat)) == (tuple(want.h),
                                                       tuple(want.vhat))
            if want.comm is None:
                assert got.comm is None
                continue
            for field in ("nabla", "worker_grads", "staleness",
                          "diff_hist"):
                assert tuple(getattr(got.comm, field)) == tuple(
                    getattr(want.comm, field)), (kind, field)
            assert _port_specs(got.comm.extras) == _jax_specs(
                dict(want.comm.extras)), kind


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_and_abstract_split_equal_the_reference(mesh):
    stub = Stub(MESHES[mesh])
    for h in (1, 2):
        jspec, tspec = (JT.train_batch_specs(stub, h),
                        TT.train_batch_specs(stub, h))
        lead = int(h > 1)
        for key, ndim in (("tokens", 3), ("embeds", 4), ("labels", 3),
                          ("positions", 5)):
            assert tspec(key, ndim + lead) == tuple(jspec(key, ndim + lead))
    m = stub.shape.get("pod", stub.shape["data"])
    batch = {"tokens": (8 * m, 33), "positions": (3, 8 * m, 32)}
    for h in (1, 2):
        want = JT.worker_split_abstract(
            {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in batch.items()},
            m, h)
        got = TT.worker_split_abstract(
            {k: torch.empty(s, dtype=torch.int32, device="meta")
             for k, s in batch.items()}, m, h)
        for key in batch:
            assert tuple(got[key].shape) == want[key].shape
            assert got[key].device.type == "meta"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_policy_equals_the_reference(arch, mesh):
    stub = Stub(MESHES[mesh])
    for kind in strategy_kinds():
        want = JP.train_policy(JC.get_config(arch), stub, kind)
        got = TP.train_policy(TC.get_config(arch), stub, kind)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kind
    with pytest.raises(ValueError, match="unknown rule kind"):
        TP.train_policy(TC.get_config(arch), stub, "nope")


def _mixed_tree():
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "c": {"d": rng.normal(size=(2, 2, 3)).astype(np.float32)}}


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_layout_shards_equal_the_reference(shards):
    tree = _mixed_tree()
    want = JF.layout_of(tree, shards=shards)
    ttree = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                 {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in tree.items()}
    got = TF.layout_of(ttree, shards=shards)
    assert (got.n, got.n_flat, got.shards, got.shard_len) == (
        want.n, want.n_flat, want.shards, want.shard_len)
    assert got.offsets == want.offsets and got.sizes == want.sizes
    assert TF.layout_of(ttree, shards=1).n_flat == TF.layout_of(ttree).n_flat
    buf = got.pack(ttree)
    np.testing.assert_array_equal(
        got.shard_split(buf).numpy(),
        np.asarray(want.shard_split(want.pack(tree))))
    assert torch.equal(got.shard_merge(got.shard_split(buf)), buf)
    plane = torch.stack([buf, 2 * buf])
    assert got.shard_split(plane).shape == (2, shards, got.shard_len)
    assert torch.equal(got.shard_merge(got.shard_split(plane)), plane)
    with pytest.raises(ValueError):
        TF.layout_of(ttree, shards=0)


def test_spec_dim_and_partition_spec():
    for axes in ((), ("data",), ("data", "pod")):
        assert TF.spec_dim(axes) == JF.spec_dim(axes)
    assert TS.P("data", None) == ("data", None)
    assert tuple(TS.P()) == tuple(jax.sharding.PartitionSpec())


def test_bootstrap_without_a_rendezvous_is_a_no_op(monkeypatch):
    for var in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
                "REPRO_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.bootstrap() is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_coordinator()
    # torchrun's variables for a one-process world: still no group
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert multihost.bootstrap() is False
    assert not torch.distributed.is_initialized()


def test_fleet_and_production_mesh_refuse_a_small_world():
    assert multihost.EXPECTED == {"16x16": 256, "2x16x16": 512}
    for name in multihost.EXPECTED:
        with pytest.raises(RuntimeError, match="ranks"):
            multihost.assert_fleet(name)
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="ranks"):
            TM.make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError):
        TM.make_production_mesh(model_par=3)


def test_host_mesh_of_one_process_and_coordinates():
    mesh = TM.make_host_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.coordinate() == {"data": 0, "model": 0}
    assert mesh.group(("data",)) is None
    assert TM.mesh_axis_size(mesh, "pod") == 1
    assert TM.mesh_axis_size(mesh, "data") == 1
    # row-major coordinates and shard indices, as init_device_mesh lays
    # ranks out (read without a process group on a 2x2x1 layout)
    lay = object.__new__(TM.Mesh)
    lay.axes, lay.sizes = ("pod", "data", "model"), (2, 2, 1)
    lay.shape, lay.rank = dict(zip(lay.axes, lay.sizes)), 0
    assert [lay.coordinate(r) for r in range(4)] == [
        {"pod": p, "data": d, "model": 0} for p in (0, 1) for d in (0, 1)]
    assert [lay.index(("data", "pod"), r) for r in range(4)] == [0, 2, 1, 3]
    assert lay.group_ranks(("data",), 2) == [2, 3]
    assert lay.group_ranks(("pod",), 1) == [1, 3]
    with pytest.raises(ValueError, match="ranks"):
        TM.Mesh((2, 1), ("data", "model"))


def test_restore_makes_each_leaf_through_the_hook(tmp_path):
    """``restore(device_put_fn=)``: the hook gets each leaf's path and the
    stored array, and its return value is the leaf; here it cuts the
    server planes of a state saved at 2 state shards to the second
    shard's slice, as a rank of the mesh runtime restores its part."""
    from repro_torch.checkpoint import io as ckpt
    cfg = TC.get_smoke_config("stablelm-1.6b")
    hp = TT.TrainHParams(state_fsdp_axes=("data",))
    st = TT.init_train_state(cfg, hp, 2, 0, "cpu", shards=2)
    st = st._replace(h=torch.arange(st.h.numel(), dtype=torch.float32))
    layout = TF.layout_of(st.params, shards=2)
    ckpt.save(str(tmp_path), st, step=3, flat_meta=layout)
    seen = []

    def put(path, a):
        seen.append(path)
        if path in (".h", ".vhat", ".comm/.nabla"):
            return torch.from_numpy(layout.shard_split(
                torch.from_numpy(a)).numpy()[1].copy())
        return torch.from_numpy(np.asarray(a)).to(torch.float32) \
            if a.ndim else int(a)

    got, step = ckpt.restore(str(tmp_path), st, device_put_fn=put)
    assert step == 3 and ".h" in seen and ".comm/.nabla" in seen
    assert torch.equal(got.h, st.h[layout.shard_len:])
    assert got.vhat.shape == (layout.shard_len,)
