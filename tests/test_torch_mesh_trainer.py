"""The mesh runtime on the CPU: ``jit_train_step`` over gloo ranks spawned
by ``torch.multiprocessing`` (``mesh_ranks.py``), held against the port's
mesh-free step and the JAX package's.

stablelm-1.6b's smoke config (fp32), a (4, 33) token batch a step, the
rule settings of the trainer lockstep test (d_max = 4, max_delay = 10,
lr = 1e-3). Three spawns:

  (a) 2 ranks, mesh (data=2, model=1): M = 2, one worker a rank; cada2
      with ``state_fsdp_axes=("data",)``, so each rank holds half of θ's
      server plane, h, v̂ and ∇ and its worker's row of the stale plane;
      3 steps. Against the port's mesh-free step from the same state:
      masks exact; θ, h, v̂, ∇ and the worker plane bit-equal (the worker's
      gradient is the same program, eq. (3) over two rows commutes, the
      AMSGrad step is elementwise); ‖Δθ‖² (two partial sums against one)
      within NORM_RTOL. Against the JAX mesh-free fused step from the same
      numpy state and batches: masks exact, floats within STATE_TOL of
      each array's scale, the trainer lockstep test's band.
  (b) 4 ranks, mesh (pod=2, data=2, model=1), ``shard_cada_state=True``:
      the worker is a pod (M = 2), whose gradient is the mean of its two
      data ranks' halves of its samples; the server planes shard over
      "data" and the worker planes pod × data (their columns over
      "data", so the b-bit wire's scales and top-k's selection are
      completed over the column group). Every kind for 2 steps at
      c = 1000 (step 0 uploads at the staleness cap, the gated rules skip
      step 1), cada2 with an 8-bit wire, topk with its sparse wire, cada2
      with the grouped second evaluation, and local momentum at H = 2
      (its batches lead with the replicated local-step axis).
      Against the port's mesh-free step: masks exact (outside
      MARGIN_BAND, as the lockstep tests hold them), floats within
      STATE_TOL of scale (a half-batch mean of gradients against the
      whole batch's; measured at most 7.0e-6, fedadam's worker plane),
      every rank's metrics equal; a b-bit wire's level flips are checked
      and counted as the lockstep tests do (2 entries in cinn, laq and
      the 8-bit cada2).
  (c) ``python -m repro_torch.launch.train --runtime mesh`` on 2 ranks
      (the process group from REPRO_COORDINATOR, REPRO_NUM_PROCESSES,
      REPRO_PROCESS_ID) against the one-process launcher with
      ``--workers 2``: the same history.json rows (‖Δθ‖² and the RHS
      within NORM_RTOL) and bit-equal saved parameters, written by rank 0
      alone.
"""
import json
import os

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
from repro_torch.checkpoint import io as ckpt
from repro_torch.core import flat as F
from repro_torch.core.rules import LOCAL_RULES, RULES, CommRule
from repro_torch.distributed import trainer as TT
from repro_torch.launch import train as train_cli
from repro_torch.utils.trees import tree_leaves

ARCH = "stablelm-1.6b"
M, BATCH, SEQ1, LR = 2, 4, 33, 1e-3
RULE = dict(d_max=4, max_delay=10)
NORM_RTOL = 1e-6        # ‖Δθ‖²: per-shard partial sums added, one order
STATE_TOL = 1e-5        # of each array's scale (test_torch_trainer_lockstep)
MARGIN_BAND = 1e-3      # gate margin |LHS − RHS| / RHS where masks may flip


def _batches(steps: int, seed: int, batch: int = BATCH) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JC.get_smoke_config(ARCH).vocab,
                         (batch, SEQ1)).astype(np.int32)
            for _ in range(steps)]


def _split(tokens, local_steps: int = 1) -> dict:
    return TT.worker_split({"tokens": torch.from_numpy(tokens).long()}, M,
                           local_steps=local_steps)


def _reference(cfg, hp, state, batches, shards):
    """The port's mesh-free trainer on one CPU thread, as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        step = TT.make_train_step(cfg, hp, M, shards=shards)
        mets = []
        for b in batches:
            state, m = step(state, b)
            mets.append(m)
        return state, mets
    finally:
        torch.set_num_threads(threads)


def _scale_gap(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _float_arrays(st) -> dict:
    out = {"h": st.h, "vhat": st.vhat}
    out.update({f"params{i}": p for i, p in enumerate(tree_leaves(
        st.params))})
    if st.comm is not None:
        out["nabla"] = st.comm.nabla
        out["worker_grads"] = st.comm.worker_grads
    return out


def test_two_ranks_zero_sharded_cada2_equals_the_mesh_free_step(tmp_path):
    """(a): bit-equal to the port's mesh-free step, and within the
    lockstep band of the JAX package's."""
    steps = 3
    rule_kw = dict(kind="cada2", c=20.0, **RULE)
    jcfg, cfg = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    jhp = JT.TrainHParams(rule=JaxRule(**rule_kw), lr=LR)
    hp = TT.TrainHParams(rule=CommRule(**rule_kw), lr=LR,
                         state_fsdp_axes=("data",))
    j_state = JT.init_train_state(jcfg, jhp, M, jax.random.PRNGKey(0),
                                  shards=2)
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, j_state), "cpu")
    toks = _batches(steps, 1)
    batches = [_split(t) for t in toks]

    ranks = mesh_ranks.spawn(mesh_ranks.run_steps, 2, tmp_path, {
        "sizes": (2, 1), "axes": ("data", "model"),
        "cases": [("a", cfg, hp, state, batches)]})
    got = ranks[0]["a"]
    assert got["local_h"] * 2 == state.h.numel()    # half the server plane
    ref, ref_mets = _reference(cfg, hp, state, batches, shards=2)

    j_step = jax.jit(JT.make_train_step(jcfg, jhp, M, shards=2))
    for k in range(steps):
        mesh_m = got["metrics"][k]
        for r in ranks[1:]:
            assert torch.equal(r["a"]["metrics"][k]["upload_mask"],
                               mesh_m["upload_mask"])
        assert torch.equal(mesh_m["upload_mask"],
                           ref_mets[k]["upload_mask"]), k
        assert torch.equal(mesh_m["lhs"], ref_mets[k]["lhs"]), k
        assert torch.equal(mesh_m["loss"], ref_mets[k]["loss"]), k
        assert float(mesh_m["dtheta_sq"]) == pytest.approx(
            float(ref_mets[k]["dtheta_sq"]), rel=NORM_RTOL)
        j_state, jm = j_step(j_state, JT.worker_split(
            {"tokens": jnp.asarray(toks[k])}, M))
        assert np.array_equal(mesh_m["upload_mask"].numpy(),
                              np.asarray(jm["upload_mask"])), k
    mesh_st = got["states"][-1]
    for name, want in _float_arrays(ref).items():
        assert torch.equal(_float_arrays(mesh_st)[name], want), name
    j_port = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, j_state), "cpu")
    gaps = {}
    for name, want in _float_arrays(j_port).items():
        have = _float_arrays(mesh_st)[name]
        if name.startswith("params"):
            # θ as its update from θ^0, which may also differ by the
            # spacing of fp32 numbers at θ once a step (θ + upd rounds),
            # as the lockstep test allows
            start = _float_arrays(state)[name].float()
            spacing = steps * torch.from_numpy(np.spacing(
                want.float().abs().numpy()))
            have, want = have.float() - start, want.float() - start
            if not want.abs().max():
                continue
            gap = ((have - want).abs() - spacing).clamp_min(0)
            gaps[name] = float(gap.max() / want.abs().max())
            continue
        gaps[name] = _scale_gap(have, want)
    print(f"\n(a) largest gap against the JAX step, of scale: "
          f"{max(gaps.values()):.3g} ({max(gaps, key=gaps.get)})")
    assert max(gaps.values()) <= STATE_TOL, gaps


# name: (rule, hyper-parameters beyond the state knob)
POD_CASES = {**{kind: (dict(kind=kind), {}) for kind in RULES + LOCAL_RULES},
             "cada2-8bit": (dict(kind="cada2", quantize_bits=8), {}),
             "topk-sparse-wire": (dict(kind="topk", sparse_wire=True), {}),
             "cada2-group-evals": (dict(kind="cada2"),
                                   dict(group_evals=True)),
             # H = 2 local steps: the batches lead with a replicated (H,)
             # axis, (2, M, b_m, 33) of a global batch of 2·BATCH
             "local_momentum-h2": (dict(kind="local_momentum",
                                        local_steps=2), {})}


def _planes(st) -> dict:
    """The worker-plane arrays of a flat state, as numpy."""
    out = {"worker_grads": st.comm.worker_grads.float().numpy()}
    out.update({k: v.float().numpy() for k, v in st.comm.extras.items()
                if torch.is_tensor(v) and v.dim() == 2})
    return out


def test_pod_mesh_every_kind_matches_the_mesh_free_step(tmp_path):
    """(b): the multi-pod mesh with worker planes sharded pod × data. A
    b-bit or top-k wire may turn the gradients' rounding gap into a level
    flip or a support swap at a few entries: they are checked and counted
    as in the lockstep tests (``lockstep_wire.py``), and the columns they
    touch are left out of the server-side arrays. An error-feedback
    residual is held at the wire's scale."""
    steps = 2
    cfg = TC.get_smoke_config(ARCH)
    cases = []
    for name, (kw, hp_kw) in POD_CASES.items():
        hp = TT.TrainHParams(rule=CommRule(**kw, c=1000.0, **RULE), lr=LR,
                             shard_cada_state=True, **hp_kw)
        h = hp.rule.local_steps
        batches = [_split(t, h) for t in _batches(steps, 2, h * BATCH)]
        cases.append((name, cfg, hp, TT.init_train_state(
            cfg, hp, M, 0, "cpu", shards=2), batches))
    ranks = mesh_ranks.spawn(mesh_ranks.run_steps, 4, tmp_path, {
        "sizes": (2, 2, 1), "axes": ("pod", "data", "model"),
        "cases": cases})
    worst, flips = (0.0, ""), {}
    for name, _, hp, state, batches in cases:
        got = ranks[0][name]
        assert got["local_h"] * 2 == state.h.numel(), name
        layout = F.layout_of(state.params, shards=2)
        flagged = np.zeros((M, layout.n_flat), bool)
        wire_scale = 0.0
        ref = state
        for k in range(steps):
            ref_prev = ref
            ref, (rm,) = _reference(cfg, hp, ref, batches[k:k + 1], 2)
            mm, mesh = got["metrics"][k], got["states"][k]
            for r in ranks[1:]:
                for key in ("upload_mask", "dtheta_sq", "loss"):
                    assert torch.equal(r[name]["metrics"][k][key],
                                       mm[key]), (name, k, key)
            flip = mm["upload_mask"] != rm["upload_mask"]
            if flip.any():
                margin = (rm["lhs"] - rm["rhs"]).abs()
                assert (margin[flip] <= MARGIN_BAND * rm["rhs"]).all(), (
                    name, k, mm["upload_mask"], rm["upload_mask"])
                break
            assert torch.equal(mm["staleness"], rm["staleness"]), (name, k)
            if ref.comm is not None:
                # the step's own wire: the mesh's increment of the plane
                # laid on the reference's previous plane (an earlier
                # step's difference is flagged already)
                before = _planes(ref_prev)["worker_grads"]
                mesh_prev = got["states"][k - 1] if k else state
                step_flags, _ = wire_differences(
                    hp.rule, layout, STATE_TOL, before,
                    _planes(ref)["worker_grads"],
                    before + (_planes(mesh)["worker_grads"]
                              - _planes(mesh_prev)["worker_grads"]))
                flagged |= step_flags
                wire_scale = max(wire_scale, float(np.abs(
                    _planes(ref)["worker_grads"] - before).max()))
            if not flagged.any():
                for key in ("loss", "dtheta_sq"):
                    assert float(mm[key]) == pytest.approx(
                        float(rm[key]), rel=STATE_TOL), (name, k, key)
            cols = flagged.any(axis=0)
            server = {"h": (mesh.h, ref.h),
                      "theta": (layout.pack(mesh.params),
                                layout.pack(ref.params))}
            if ref.comm is not None:
                server["nabla"] = (mesh.comm.nabla, ref.comm.nabla)
            pairs = [(key, a.float().numpy(), b.float().numpy(), ~cols)
                     for key, (a, b) in server.items()]
            pairs.append(("vhat", mesh.vhat.float().numpy(),
                          ref.vhat.float().numpy(), ~cols))
            if ref.comm is not None:
                mine = _planes(mesh)
                pairs += [(key, mine[key], want, ~flagged)
                          for key, want in _planes(ref).items()]
            for key, a, b, keep in pairs:
                # a residual is held at the wire's scale, as the trainer
                # lockstep test holds it
                scale = max(np.abs(b).max(), 1e-30,
                            wire_scale if key == "residual" else 0.0)
                gap = float(np.abs(a - b)[keep].max(initial=0.0)) / scale
                assert gap <= STATE_TOL, (name, k, key, gap)
                worst = max(worst, (gap, f"{name} {key}"))
        if hp.rule.kind in ("lag", "cada1", "cada2", "cinn", "laq", "topk"):
            assert got["metrics"][0]["upload_mask"].all(), name
            assert not got["metrics"][1]["upload_mask"].any(), name
        flips[name] = int(flagged.sum())
    print(f"\n(b) largest gap of scale: {worst[0]:.3g} ({worst[1]}); "
          f"wire differences per case: {flips}")


def test_launcher_mesh_runtime_on_two_ranks(tmp_path):
    """(c): ``--runtime mesh`` on a process group of 2 against the
    one-process launcher at M = 2."""
    common = ["--arch", ARCH, "--smoke", "--device", "cpu", "--rule",
              "cada2", "--steps", "4", "--global-batch", "4", "--seq",
              "32", "--log-every", "1", "--c", "1000"]
    mesh_dir, one_dir = tmp_path / "mesh", tmp_path / "one"
    ranks = mesh_ranks.spawn(mesh_ranks.run_launcher, 2, tmp_path, {
        "argv": common + ["--runtime", "mesh", "--state-fsdp-axes", "data",
                          "--ckpt-dir", str(mesh_dir)]})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = train_cli.main(common + ["--workers", "2", "--ckpt-dir",
                                       str(one_dir)])
    finally:
        torch.set_num_threads(threads)
    assert [{k: v for k, v in row.items() if k != "wall_s"}
            for row in ranks[0]] == [
        {k: v for k, v in row.items() if k != "wall_s"} for row in ranks[1]]
    with open(mesh_dir / "history.json") as f:
        mesh_hist = json.load(f)
    assert len(mesh_hist) == len(one) == 4
    assert sorted(os.listdir(mesh_dir)) == ["history.json", "step_4"]
    for got, want in zip(mesh_hist, one):
        assert set(got) == set(want)
        for key, v in want.items():
            if key == "wall_s":
                continue
            if key in ("dtheta_sq", "rhs", "mean_lhs"):
                assert got[key] == pytest.approx(v, rel=NORM_RTOL), key
            else:
                assert got[key] == v, key
    like = TT.init_train_state(TC.get_smoke_config(ARCH), TT.TrainHParams(),
                               M, 0, "cpu").params
    got, _ = ckpt.restore(str(mesh_dir / "step_4"), like)
    want, _ = ckpt.restore(str(one_dir / "step_4"), like)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
