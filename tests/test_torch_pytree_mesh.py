"""The pytree plane (``fused=False``) on the mesh runtime, in lockstep with
the JAX package's mesh-free pytree ``make_train_step``, and its specs
against the reference's table.

``jit_train_step`` runs on 4 gloo ranks spawned by
``torch.multiprocessing`` (``mesh_ranks.run_steps``): stablelm-1.6b's
smoke config (fp32), M = 2 workers, STEPS steps of a (4, 33) token batch,
``test_torch_tp_trainer.py``'s rule settings and c. Cases:

  * (data=2, model=2): cada2 with both state knobs
    (``state_fsdp_axes=("data",)``: the moments over data and model;
    ``shard_cada_state``: ∇ over data and model, the worker trees over
    model); laq 8-bit with ``state_fsdp_axes=("model", "data")`` (its
    scales completed over the model axis); topk (the exact top-k of each
    worker's whole leaf); local_momentum at H = 2 with
    ``shard_cada_state`` (the local steps at whole parameters, the momenta
    gathered and cut back); ``always``;
  * the multi-pod mesh (pod=2, data=1, model=2): cada2 with ``fsdp=True``
    over ``fsdp_axes=("data", "pod")``;
  * FSDP over the worker axis with points that differ between workers:
    fedadam at H = 2 with ``fsdp=True`` (each worker's local parameters)
    and cada2 with ``fsdp=True`` at a c where the workers upload apart
    (each worker's stale iterate): each rank evaluates its own worker's
    point, the FSDP gathers kept off the worker axis.

Each step starts from the reference's state of that step (reloaded), and
both sides take the same batch. Contract, ``test_torch_tp_trainer.py``'s:
masks, staleness and avp's periods exact (a worker whose reference-side
margin is within MARGIN_BAND · RHS may flip: that step's floats are not
compared, at most one such step a case); every float array within
STATE_TOL of its scale, θ's update within UPDATE_TOL, a b-bit or top-k
wire's differences checked and counted (``lockstep_pytree.py``). Every
rank's metrics are equal, and each step's masks equal the port's flat
mesh step's on the same ranks (the same case on ``fused=True``, in
lockstep with the reference's flat step from the same init). A rank that
took a cut leaf's max or top-k over its own block alone fails a case
(``mesh_ranks._block_local_selection``). The gaps print with
``pytest -s``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from lockstep_pytree import Packer, Tally, check_tally, compare_round, np32
import repro.configs as JC
from repro.core.rules import CommRule as JaxRule
from repro.distributed import trainer as JT
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core.comm import strategy_kinds
from repro_torch.core.rules import CommRule
from repro_torch.distributed import sharding as TS
from repro_torch.distributed import trainer as TT
from repro_torch.utils.trees import tree_leaves, tree_paths

torch.set_num_threads(1)

ARCH = "stablelm-1.6b"
M, BATCH, SEQ1, LR, STEPS, H = 2, 4, 33, 1e-3, 3, 2
RULE = dict(d_max=4, max_delay=10)
STATE_TOL = 1e-5        # of each array's scale (the TP trainer test's)
UPDATE_TOL = 2e-5       # θ's update, of its scale (the TP trainer test's)
DATA_MODEL = ((2, 2), ("data", "model"))
POD_MODEL = ((2, 1, 2), ("pod", "data", "model"))
BOTH_KNOBS = dict(state_fsdp_axes=("data",), shard_cada_state=True)
# name: (rule, TrainHParams fields, mesh)
CASES = {
    "cada2-state": (dict(kind="cada2", c=20.0), BOTH_KNOBS, DATA_MODEL),
    "laq-state": (dict(kind="laq", c=1000.0),
                  dict(state_fsdp_axes=("model", "data")), DATA_MODEL),
    "topk": (dict(kind="topk", c=20.0), {}, DATA_MODEL),
    "local_momentum": (dict(kind="local_momentum", c=20.0, local_steps=H),
                       dict(shard_cada_state=True), DATA_MODEL),
    "always": (dict(kind="always"), dict(shard_cada_state=True), DATA_MODEL),
    "cada2-pod-fsdp": (dict(kind="cada2", c=20.0),
                       dict(fsdp=True, fsdp_axes=("data", "pod")),
                       POD_MODEL),
    "fedadam-fsdp": (dict(kind="fedadam", c=20.0, local_steps=H),
                     dict(fsdp=True), DATA_MODEL),
    "cada2-fsdp-skew": (dict(kind="cada2", c=16.0), dict(fsdp=True),
                        DATA_MODEL),
}
# a case's seed, where it is not its place in CASES: the one at which the
# skew case's workers upload apart at step 1
SEEDS = {"cada2-fsdp-skew": 4}
# the deliberately wrong rank (block-local maxima and top-k) on laq's case
MUTANT = "laq-state/block-local"


class _Stub:
    def __init__(self, sizes, axes):
        self.shape = dict(zip(axes, sizes))


def _reference(i, rule, fused, mesh):
    """The reference's trajectory from PRNGKey(i) (its states and metrics)
    and the port's worker-split batches."""
    jcfg = JC.get_smoke_config(ARCH)
    h = rule.get("local_steps", 1)
    jhp = JT.TrainHParams(rule=JaxRule(**rule, **RULE), lr=LR, fused=fused)
    thp = TT.TrainHParams(rule=CommRule(**rule, **RULE), lr=LR, fused=fused)
    shards = TT.flat_state_shards(TC.get_smoke_config(ARCH), _Stub(*mesh),
                                  thp) if fused else 1
    j_step = jax.jit(JT.make_train_step(jcfg, jhp, M, shards=shards))
    j_state = JT.init_train_state(jcfg, jhp, M, jax.random.PRNGKey(i),
                                  shards=shards)
    rng = np.random.default_rng(i)
    states, mets, batches = [], [], []
    for _ in range(STEPS):
        toks = rng.integers(0, jcfg.vocab, (BATCH, SEQ1)).astype(np.int32)
        states.append(jax.tree.map(np.asarray, j_state))
        j_state, jm = j_step(j_state, JT.worker_split(
            {"tokens": jnp.asarray(toks)}, M, local_steps=h))
        mets.append(jax.tree.map(np.asarray, jm))
        batches.append(TT.worker_split(
            {"tokens": torch.from_numpy(toks).long()}, M, local_steps=h))
    states.append(jax.tree.map(np.asarray, j_state))
    return states, mets, batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's pytree and flat trajectories of every case, and
    the ranks' steps of both planes from each of their states."""
    tcfg = TC.get_smoke_config(ARCH)
    cases, refs = [], {}
    for i, (name, (rule, hp_kw, mesh)) in enumerate(CASES.items()):
        i = SEEDS.get(name, i)
        for fused in (False, True):
            hp = TT.TrainHParams(rule=CommRule(**rule, **RULE), lr=LR,
                                 fused=fused, **hp_kw)
            states, mets, batches = _reference(i, rule, fused, mesh)
            key = name if not fused else name + "/flat"
            refs[key] = (hp, states, mets)
            starts = [convert.train_state_from_numpy(s, "cpu")
                      for s in states[:-1]]
            cases.append((key, tcfg, hp, starts, batches, mesh))
            if name == MUTANT.split("/")[0] and not fused:
                refs[MUTANT] = refs[key]
                cases.append((MUTANT, tcfg, hp, starts, batches, mesh,
                              {"block_local": True}))
    ranks = mesh_ranks.spawn(mesh_ranks.run_steps, 4,
                             tmp_path_factory.mktemp("pytree_mesh"), {
                                 "sizes": DATA_MODEL[0],
                                 "axes": DATA_MODEL[1], "cases": cases})
    return ranks, refs


def _compare(ranks, refs, name):
    """Holds the ranks' steps of a pytree case against the reference's
    (the module docstring's contract). Returns the steps' upload masks,
    None at a step with an in-band flip."""
    hp, j_states, j_mets = refs[name]
    got = ranks[0][name]
    tally, masks = Tally(), []
    for k in range(STEPS):
        tm, jm = got["metrics"][k], j_mets[k]
        for r in ranks[1:]:
            for key in ("upload_mask", "staleness", "loss", "dtheta_sq"):
                assert torch.equal(r[name]["metrics"][k][key], tm[key]), (
                    name, k, key)
        j_prev, j = j_states[k], j_states[k + 1]
        t = got["states"][k]
        pk = Packer(j_prev.params)
        server = [("h", pk.one(j.h), pk.one(t.h)),
                  ("vhat", pk.one(j.vhat), pk.one(t.vhat))]
        if j.comm is None:
            assert t.comm is None and bool(tm["upload_mask"].all())
            cols = np.zeros(pk.layout.n_flat, bool)
            for key, a, b in server + [("loss", jm["loss"], tm["loss"])]:
                a, b = np32(a), np32(b)
                np.testing.assert_allclose(
                    b, a, rtol=0, atol=STATE_TOL * max(np.abs(a).max(),
                                                       1e-30),
                    err_msg=f"{name}: {key} at step {k}")
            tally.uploads += M
        else:
            cols = compare_round(k, hp.rule, pk, j_prev.comm, j.comm,
                                 t.comm, jm, tm, None, tally, STATE_TOL,
                                 server)
            if cols is False:
                masks.append(None)
                continue
        masks.append(tm["upload_mask"].tolist())
        theta = pk.one(j_prev.params)
        d_ref, d_port = pk.one(j.params) - theta, pk.one(t.params) - theta
        spacing = np.spacing(np.abs(theta + d_ref))
        gap = (np.abs(d_port - d_ref) - spacing)[~cols]
        scale = np.abs(d_ref).max()
        assert (gap <= UPDATE_TOL * scale).all(), (name, k,
                                                   gap.max() / scale)
        tally.worst = max(tally.worst, (float(gap.max() / scale),
                                        "θ update"))
        d_ref, d_port = d_ref.astype(np.float64), d_port.astype(np.float64)
        slack = float(np.abs(d_port ** 2 - d_ref ** 2)[cols].sum()) * 1.01
        dsq = float(jm["dtheta_sq"])
        assert abs(float(tm["dtheta_sq"]) - dsq) <= STATE_TOL * dsq + slack
    kind = hp.rule.kind
    check_tally("always" if kind == "topk" else kind, tally,
                f"pytree mesh {name}")
    return masks


@pytest.mark.parametrize("name", list(CASES))
def test_pytree_mesh_steps_match_the_reference(runs, name):
    """Lockstep with the reference's pytree step, and each step's masks
    equal to the flat mesh step's on the same ranks."""
    ranks, refs = runs
    masks = _compare(ranks, refs, name)
    if name in SEEDS:
        assert any(m[0] != m[1] for m in masks[:-1] if m is not None), (
            "the workers never uploaded apart")
    flat = ranks[0][name + "/flat"]["metrics"]
    j_flat = refs[name + "/flat"][2]
    for k, mask in enumerate(masks):
        if mask is None:
            continue
        jm = j_flat[k]
        if not np.array_equal(jm["upload_mask"], np.array(mask)):
            # the flat reference's gate sits at a near-tie here
            margin = np.abs(jm["lhs"] - jm["rhs"])
            assert (margin <= 1e-3 * jm["rhs"]).any(), (name, k)
            continue
        assert flat[k]["upload_mask"].tolist() == mask, (name, k)


def test_a_block_local_selection_fails_the_lockstep(runs):
    """The same laq case on a rank that takes each cut leaf's 8-bit scale
    over its own block alone (and top-k within it) leaves the reference:
    the contract must catch it, or the cut leaves' completion is
    untested."""
    ranks, refs = runs
    _compare(ranks, refs, MUTANT.split("/")[0])
    with pytest.raises(AssertionError) as caught:
        _compare(ranks, refs, MUTANT)
    print(f"\nthe block-local rank fails: {str(caught.value)[:300]}")


@pytest.mark.parametrize("name", list(CASES))
def test_pytree_ranks_hold_their_blocks(runs, name):
    """Each rank's moments are its blocks by the moments' specs (the
    state axes' share of the parameter count), and its parameters own
    their storage after a step (no view of a gathered leaf)."""
    ranks, refs = runs
    hp = refs[name][0]
    cfg = TC.get_smoke_config(ARCH)
    sizes, axes = CASES[name][2]
    stub = _Stub(sizes, axes)
    ts = TT.tree_sharding(cfg, stub, hp)
    shapes = TT.abstract_train_state(cfg, hp, M).h
    want = sum(x.numel() // int(np.prod([stub.shape[a] for a in
                                         TS.leaf_axes(sp)]))
               for x, sp in zip(tree_leaves(shapes), tree_leaves(ts.msp)))
    for r, rank in enumerate(ranks):
        assert rank[name]["local_h"] == want, (name, r)
        storage, own = rank[name]["param_storage"]
        assert storage == own, (name, r, storage, own)


# ------------------------------------------------------------ the table

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
KNOBS = (dict(state_fsdp_axes=("data",)), dict(shard_cada_state=True))


def _jax_specs(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(getattr(k, "key", getattr(k, "name", k)) for k in path):
            tuple(spec) for path, spec in flat}


def _port_specs(tree) -> dict:
    return {tuple(p): tuple(spec) for p, spec in zip(tree_paths(tree),
                                                     tree_leaves(tree))}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JC.list_archs()))
def test_pytree_state_specs_equal_the_reference(arch, mesh):
    """``train_state_specs(fused=False)`` is the reference's for every
    rule kind under each state knob (a ``.shape``-dict mesh)."""
    stub = _Stub(tuple(MESHES[mesh].values()), tuple(MESHES[mesh]))
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for kind in strategy_kinds():
        for kw in KNOBS:
            want = JT.train_state_specs(jcfg, stub, JT.TrainHParams(
                rule=JaxRule(kind=kind), fused=False, **kw))
            got = TT.train_state_specs(tcfg, stub, TT.TrainHParams(
                rule=CommRule(kind=kind), fused=False, **kw))
            assert got.step == tuple(want.step) == ()
            for field in ("params", "h", "vhat"):
                assert _port_specs(getattr(got, field)) == _jax_specs(
                    getattr(want, field)), (kind, kw, field)
            if want.comm is None:
                assert got.comm is None
                continue
            for field in ("nabla", "worker_grads", "extras"):
                assert _port_specs(getattr(got.comm, field)) == _jax_specs(
                    dict(getattr(want.comm, field))
                    if field == "extras" else getattr(want.comm, field)), (
                        kind, kw, field)
            for field in ("staleness", "diff_hist"):
                assert tuple(getattr(got.comm, field)) == tuple(
                    getattr(want.comm, field)) == (None,)


def test_state_knobs_are_accepted_on_the_pytree_plane():
    """The state knobs build with ``fused=False``; the mesh-free step
    ignores them (one process holds the whole state), as the
    reference's does."""
    hp = TT.TrainHParams(fused=False, **BOTH_KNOBS)
    assert dataclasses.replace(hp, fsdp=True).state_fsdp_axes == ("data",)
    assert TT.flat_state_axes(TC.get_smoke_config(ARCH),
                              _Stub(*DATA_MODEL), hp) == ()
