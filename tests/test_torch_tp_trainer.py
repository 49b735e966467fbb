"""The mesh trainer with a model axis and parameter FSDP, in lockstep with
the JAX package's mesh-free ``make_train_step``.

``jit_train_step`` runs on 4 gloo ranks spawned by
``torch.multiprocessing`` (``mesh_ranks.run_steps``): stablelm-1.6b's
smoke config (fp32), M = 2 workers, STEPS steps of a (4, 33) token batch,
the trainer lockstep test's rule settings (d_max = 4, max_delay = 10,
lr = 1e-3) at a c at which the gated rules upload and skip (20, and 1000
for laq, whose quantized LHS runs higher). Cases:

  * (data=2, model=2): cada2; cada2 with ``fsdp=True`` (remat on, so the
    per-layer gathers run in the checkpointed bodies); laq with
    ``fsdp=True`` and ``state_fsdp_axes=("model", "data")`` (the worker
    planes' columns over "model": the 8-bit wire's scales are completed
    over the column group); topk on ``state_fsdp_axes=("data",)``;
  * the multi-pod mesh (pod=2, data=1, model=2): cada2 with ``fsdp=True``
    over ``fsdp_axes=("data", "pod")`` (the FSDP dim over the pods, which
    are the workers);
  * cada2 with ``fsdp=True`` at a c where one worker uploads and the
    other skips, so that the two workers' stale iterates differ at the
    next step: each rank's second evaluation must be at its own worker's
    point, whose FSDP dim the worker axis cuts in the ring
    (``FlatSharding.worker_points``); and the same with ``group_evals``,
    where every rank evaluates every occupied ring row (each
    evaluation's FSDP gathers span the other worker's ranks).

Each step starts from the reference's state of that step (reloaded, so
a near-threshold gate flip cannot snowball), and both sides take the
same batch. Contract, as ``test_torch_trainer_lockstep.py``'s: upload
masks, staleness and cada2's slots and ring versions exact, except for a
worker whose reference-side margin |LHS − RHS| is within MARGIN_BAND ·
RHS (that step's floats are then not compared); θ's update, h, v̂, ∇, the
worker plane, the ring, the finite LHS, the loss and ‖Δθ‖² within
STATE_TOL of each array's scale, a b-bit or top-k wire's differences checked and counted
(``lockstep_wire.py``), an error-feedback residual at the wire's scale.
θ's update is held to UPDATE_TOL: AMSGrad's normalized step divides a
gradient entry by a root near √ε, which takes the gradients' gap to about
five times itself in the update (5.3e-6 of scale one process against
the JAX package, ``test_torch_trainer_lockstep.py``), and the ranks' sums
of partial products double the gradients' gap (1.8e-6 against 1.0e-6,
``test_torch_tp_grads.py``). Every rank's metrics must be equal. The
measured gaps print with ``pytest -s``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from lockstep_wire import wire_differences
import repro.configs as JC
from repro.core.rules import CommRule as JaxRule
from repro.distributed import trainer as JT
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core import flat as F
from repro_torch.core.rules import CommRule
from repro_torch.distributed import trainer as TT
from repro_torch.launch.mesh import Mesh
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

ARCH = "stablelm-1.6b"
M, BATCH, SEQ1, LR, STEPS = 2, 4, 33, 1e-3, 3
RULE = dict(d_max=4, max_delay=10)
STATE_TOL = 1e-5        # of each array's scale (the trainer lockstep's)
UPDATE_TOL = 2e-5       # θ's update, of its scale (module docstring)
MARGIN_BAND = 1e-3      # gate margin |LHS − RHS| / RHS where masks may flip
DATA_MODEL = ((2, 2), ("data", "model"))
POD_MODEL = ((2, 1, 2), ("pod", "data", "model"))
# name: (rule, TrainHParams fields, config change, mesh)
CASES = {
    "cada2": (dict(kind="cada2", c=20.0), {}, {}, DATA_MODEL),
    "cada2-fsdp": (dict(kind="cada2", c=20.0), dict(fsdp=True),
                   {"remat": True}, DATA_MODEL),
    "laq-fsdp-state": (dict(kind="laq", c=1000.0),
                       dict(fsdp=True, state_fsdp_axes=("model", "data")),
                       {}, DATA_MODEL),
    "topk": (dict(kind="topk", c=20.0), dict(state_fsdp_axes=("data",)), {},
             DATA_MODEL),
    "cada2-pod-fsdp": (dict(kind="cada2", c=20.0),
                       dict(fsdp=True, fsdp_axes=("data", "pod")), {},
                       POD_MODEL),
    "cada2-fsdp-skew": (dict(kind="cada2", c=16.0), dict(fsdp=True), {},
                        DATA_MODEL),
    "cada2-fsdp-skew-grouped": (dict(kind="cada2", c=16.0),
                                dict(fsdp=True, group_evals=True), {},
                                DATA_MODEL),
}
# a case's seed, where it is not its place in CASES: the one at which the
# skew cases' workers upload apart at step 1
SEEDS = {"cada2-fsdp-skew": 4, "cada2-fsdp-skew-grouped": 4}
INT_EXTRAS = ("slot", "ring_version")


class _Stub:
    def __init__(self, sizes, axes):
        self.shape = dict(zip(axes, sizes))


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's trajectory of every case (its states and metrics),
    and the ranks' steps from each of its states."""
    jcfg0, tcfg0 = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    cases, refs = [], {}
    for i, (name, (rule, hp_kw, change, mesh)) in enumerate(CASES.items()):
        i = SEEDS.get(name, i)
        jcfg, tcfg = jcfg0.with_(**change), tcfg0.with_(**change)
        hp = TT.TrainHParams(rule=CommRule(**rule, **RULE), lr=LR, **hp_kw)
        shards = TT.flat_state_shards(tcfg, _Stub(*mesh), hp)
        jhp = JT.TrainHParams(rule=JaxRule(**rule, **RULE), lr=LR)
        j_step = jax.jit(JT.make_train_step(jcfg, jhp, M, shards=shards))
        j_state = JT.init_train_state(jcfg, jhp, M, jax.random.PRNGKey(i),
                                      shards=shards)
        rng = np.random.default_rng(i)
        states, mets, batches = [], [], []
        for _ in range(STEPS):
            toks = rng.integers(0, jcfg.vocab, (BATCH, SEQ1)).astype(np.int32)
            states.append(jax.tree.map(np.asarray, j_state))
            j_state, jm = j_step(j_state, JT.worker_split(
                {"tokens": jnp.asarray(toks)}, M))
            mets.append(jax.tree.map(np.asarray, jm))
            batches.append(TT.worker_split(
                {"tokens": torch.from_numpy(toks).long()}, M))
        states.append(jax.tree.map(np.asarray, j_state))
        refs[name] = (hp, shards, states, mets)
        cases.append((name, tcfg, hp, [convert.train_state_from_numpy(
            s, "cpu") for s in states[:-1]], batches, mesh))
    ranks = mesh_ranks.spawn(mesh_ranks.run_steps, 4,
                             tmp_path_factory.mktemp("tp_steps"), {
                                 "sizes": DATA_MODEL[0],
                                 "axes": DATA_MODEL[1], "cases": cases})
    return ranks, refs


def _float_pairs(j, t):
    """(name, reference, port, where) of the stored float arrays; ``where``
    says what a wire difference leaves out: its column ("col"), its entry
    ("entry") or nothing (None)."""
    pairs = [("h", j.h, t.h, "col"), ("vhat", j.vhat, t.vhat, "col")]
    if j.comm is None:
        return pairs
    pairs += [("nabla", j.comm.nabla, t.comm.nabla, "col"),
              ("worker_grads", j.comm.worker_grads, t.comm.worker_grads,
               "entry")]
    for name, v in dict(j.comm.extras).items():
        if name in INT_EXTRAS:
            continue
        port = t.comm.extras[name]
        if isinstance(v, dict):   # a parameter tree (the ring)
            pairs += [(f"{name}[{i}]", a, b, None) for i, (a, b) in
                      enumerate(zip(jax.tree.leaves(v), tree_leaves(port)))]
        else:
            pairs.append((name, v, port, "entry"))
    return pairs


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_the_reference(runs, name):
    ranks, refs = runs
    hp, shards, j_states, j_mets = refs[name]
    got = ranks[0][name]
    flips = uploads = skips = wire = 0
    worst = (0.0, "")
    for k in range(STEPS):
        mm, jm = got["metrics"][k], j_mets[k]
        for r in ranks[1:]:
            for key in ("upload_mask", "staleness", "loss", "dtheta_sq"):
                assert torch.equal(r[name]["metrics"][k][key], mm[key]), (
                    name, k, key)
        j_up, t_up = jm["upload_mask"], mm["upload_mask"].numpy()
        uploads += int(j_up.sum())
        skips += int((~j_up).sum())
        if not np.array_equal(j_up, t_up):
            margin = np.abs(jm["lhs"] - jm["rhs"])
            flipped = j_up != t_up
            assert (margin[flipped] <= MARGIN_BAND * jm["rhs"]).all(), (
                name, k, j_up, t_up, jm["lhs"], jm["rhs"])
            flips += 1
            continue
        assert np.array_equal(mm["staleness"].numpy(), jm["staleness"])
        j_prev = convert.train_state_from_numpy(j_states[k], "cpu")
        j = convert.train_state_from_numpy(j_states[k + 1], "cpu")
        t = got["states"][k]
        for key in INT_EXTRAS:
            if key in j.comm.extras:
                assert torch.equal(t.comm.extras[key], j.comm.extras[key])
        layout = F.layout_of(j.params, shards=shards)
        flagged, _ = wire_differences(
            hp.rule, layout, STATE_TOL, _np(j_prev.comm.worker_grads),
            _np(j.comm.worker_grads), _np(t.comm.worker_grads))
        wire += int(flagged.sum())
        wire_scale = float(np.abs(_np(j.comm.worker_grads)
                                  - _np(j_prev.comm.worker_grads)).max())
        cols = flagged.any(axis=0)
        theta = _np(layout.pack(j_prev.params))
        d_ref = _np(layout.pack(j.params)) - theta
        d_port = _np(layout.pack(t.params)) - theta
        spacing = np.spacing(np.abs(theta + d_ref))
        finite = np.isfinite(jm["lhs"])
        assert np.array_equal(finite, np.isfinite(mm["lhs"].numpy()))
        pairs = [("params update", d_ref, d_port, "col")] + _float_pairs(
            j, t) + [("loss", jm["loss"], mm["loss"], None),
                     ("lhs", jm["lhs"][finite], mm["lhs"].numpy()[finite],
                      None)]
        for key, a, b, where in pairs:
            a, b = _np(a), _np(b)
            assert a.shape == b.shape, key
            keep = {None: np.ones(a.shape, bool), "col": ~cols,
                    "entry": ~flagged}[where]
            scale = max(np.abs(a).max(), 1e-30,
                        wire_scale if key == "residual" else 0.0)
            update = key == "params update"
            gap = np.abs(b - a) - (spacing if update else 0)
            bad = ~(gap <= (UPDATE_TOL if update else STATE_TOL) * scale
                    ) & keep
            assert not bad.any(), (name, k, key, int(bad.sum()),
                                   float((gap[bad] / scale).max()))
            worst = max(worst, (float(gap[keep].max(initial=0.0) / scale),
                                key))
        if not flagged.any():
            assert float(mm["dtheta_sq"]) == pytest.approx(
                float(jm["dtheta_sq"]), rel=STATE_TOL), (name, k)
    print(f"\n{name}: largest gap {worst[0]:.3g} of scale ({worst[1]}), "
          f"{flips} in-band flip steps, {uploads} uploads, {skips} skips, "
          f"{wire} wire differences")
    assert flips <= 1 and uploads > 0
    if hp.rule.kind != "topk":
        assert skips > 0, "the gate never skipped: the test is vacuous"
    if name in SEEDS:
        assert any(jm["upload_mask"][0] != jm["upload_mask"][1]
                   for jm in j_mets[:-1]), "the workers never uploaded apart"


def test_ranks_hold_their_parameter_shards(runs):
    """Each rank's parameters are its blocks by ``param_pspecs``: the
    model axis halves the sharded leaves, and FSDP halves them again."""
    ranks, _ = runs
    whole = TC.get_smoke_config(ARCH)
    d, ff = whole.d_model, whole.d_ff
    shapes = {n: ranks[0][n]["param_shapes"] for n in CASES}
    assert shapes["cada2"]["blocks/mlp/w_up"] == (whole.n_layers, d, ff // 2)
    assert shapes["cada2-fsdp"]["blocks/mlp/w_up"] == (whole.n_layers,
                                                       d // 2, ff // 2)
    assert shapes["cada2"]["embed"] == (whole.vocab // 2, d)
    assert shapes["cada2-fsdp"]["embed"] == (whole.vocab // 2, d // 2)
    assert shapes["cada2-pod-fsdp"]["lm_head"] == (d // 2, whole.vocab // 2)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_parameters_own_their_storage(runs, name):
    """After a step the rank's parameters hold their own bytes: a leaf no
    axis cuts is a copy, not a view that keeps the whole gathered θ plane
    (n_flat fp32) alive in the state beside the rank's shards."""
    ranks, _ = runs
    for r, rank in enumerate(ranks):
        storage, own = rank[name]["param_storage"]
        assert storage == own, (f"rank {r}: {storage} bytes behind "
                                f"{own} bytes of parameters")


@pytest.mark.parametrize("hp_kw", [dict(fused=False),
                                   dict(fused=False, fsdp=True)],
                         ids=["pytree", "pytree-fsdp"])
def test_remaining_refusals_raise_by_name(hp_kw):
    """The pytree plane on the mesh, refused until the per-leaf sharded
    state was ported, now builds with or without FSDP and is honoured: on
    a one-rank mesh its step is the mesh-free pytree step bit for bit, and
    its state specs are the per-leaf ones. The flat plane's FSDP knobs
    build as before."""
    cfg = TC.get_smoke_config(ARCH)
    mesh = Mesh((1, 1), ("data", "model"))
    hp = TT.TrainHParams(rule=CommRule(kind="cada2", c=20.0, **RULE),
                         lr=LR, **hp_kw)
    make, specs, m = TT.jit_train_step(cfg, mesh, hp)
    assert m == 1 and isinstance(specs.h, dict)
    batch = TT.worker_split({"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))).long()}, 1)
    whole = TT.init_train_state(cfg, hp, 1, 0, "cpu")
    ts = TT.state_sharding(cfg, mesh, hp)
    got, gm = make(batch)(TT.shard_train_state(whole, ts, hp), batch)
    want, wm = TT.make_train_step(cfg, hp, 1)(whole, batch)
    got = TT.unshard_train_state(got, ts, hp)
    for a, b in zip(tree_leaves(got.params) + tree_leaves(got.h),
                    tree_leaves(want.params) + tree_leaves(want.h)):
        assert torch.equal(a, b)
    assert torch.equal(gm["dtheta_sq"], wm["dtheta_sq"])
    make, specs, m = TT.jit_train_step(cfg, mesh, TT.TrainHParams(
        fsdp=True, fsdp_axes=("data", "pod")))
    assert m == 1 and callable(make)
