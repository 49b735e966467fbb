"""The port's pipelined cohort driver (``core/flat.py::run_cohort_rounds``).

The contract: the pipeline (round i+1's rows gathered and sent while round
i runs, round i's writeback landed one round late, the rows consecutive
cohorts share forwarded on the device) reorders copies, never arithmetic.
On the CPU it equals the serial oracle (``pipeline=False``) BIT FOR BIT for
every rule kind, the sparse top-k wire and both delta-payload rules: θ,
masks, staleness, ∇, the RHS ring, every pool plane, the server extras and
every metric. So does a memmap pool against a RAM pool.

Also here, as the JAX package's ``tests/test_cohort_pipeline.py`` has
them: the drain before the ``resum_every`` guard, ``metrics_every``
equivalence, the sorted-cohort check, the empty schedule, the drain on an
early exit, the forwarding patch; the overlap schedule against the
reference's ``cohort_overlap_schedule`` on random schedules, and
``sample_cohorts`` against the reference's arrays.

And the LM trainer's cohort step (``make_cohort_train_step``) against the
JAX trainer's, in lockstep: stablelm-1.6b's smoke config (fp32), M = 4,
C = 2, 4 rounds, cada2 and local_momentum (H = 2). Each round the
reference's round-k state and pool are loaded into the port
(``convert.cohort_state_from_numpy``, ``convert.pool_from_numpy``), both
take the same numpy batch of the cohort and one step. Masks and staleness
match exactly (no gate margin of these runs lies near its threshold);
float state matches within the band of ``test_torch_trainer_lockstep.py``
(STATE_TOL of each array's scale; θ as its update, plus the spacing of
fp32 numbers at θ'). The port's own pipelined run of the same rounds
equals its serial run bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core import engine as jax_engine
from repro.core import flat as JF
from repro.core.rules import CommRule as JaxRule
from repro.distributed import trainer as JT
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core import flat as F
from repro_torch.core.engine import CADAEngine, sample_cohorts
from repro_torch.core.rules import RULES, CommRule
from repro_torch.data import ijcnn1_like, pad_to_matrix, uniform_partition
from repro_torch.distributed import trainer as TT
from repro_torch.models.small import logreg_loss
from repro_torch.optim.fused import FusedAMSGrad
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

M, C, STEPS = 8, 3, 18
ARMS = RULES + ("topk_sparse", "local_momentum", "fedadam")


def _rule(kind):
    """The reference's cohort-test rules (tests/test_cohort_pipeline.py)."""
    if kind == "topk_sparse":
        return dict(kind="topk", c=5.0, d_max=4, max_delay=6,
                    topk_frac=0.5, sparse_wire=True)
    if kind in ("local_momentum", "fedadam"):
        return dict(kind=kind, c=0.6, d_max=4, max_delay=6, local_steps=2,
                    local_lr=0.05, local_beta=0.9)
    kw = dict(kind=kind, c=5.0, d_max=4, max_delay=6)
    if kind == "topk":
        kw["topk_frac"] = 0.5
    if kind == "avp":
        kw.update(period_min=1, period_max=4)
    return kw


def _problem(steps, m=M, seed=2, n=400, batch=8):
    """ijcnn1_like logreg: zero parameters and (steps, M, b, ...) numpy
    batches of each worker's shard."""
    ds = ijcnn1_like(n=n)
    mtx = pad_to_matrix(uniform_partition(ds.n, m, seed=0))
    rng = np.random.default_rng(seed)
    ids = mtx[np.arange(m)[None, :, None],
              rng.integers(0, mtx.shape[1], (steps, m, batch))]
    params = {"w": np.zeros((22, 2), np.float32),
              "b": np.zeros((2,), np.float32)}
    return params, (ds.x[ids], ds.y[ids])


def _delta_problem(steps, h=2, m=M, seed=1):
    """A linear least-squares problem for the delta rules: (steps, H, M, b,
    ...) batches."""
    rng = np.random.default_rng(seed)
    params = {"w": (0.3 * rng.normal(size=(22, 2))).astype(np.float32),
              "b": np.zeros((2,), np.float32)}
    return params, (rng.normal(size=(steps, h, m, 8, 22)).astype(np.float32),
                    rng.normal(size=(steps, h, m, 8, 2)).astype(np.float32))


def delta_loss(p, b):
    x, y = b
    return torch.mean((x @ p["w"] + p["b"] - y) ** 2)


def cohort_batches(kind, cohorts, bx, by):
    """Round i's batch holds the rows of ``cohorts[i]`` only (the worker
    axis is axis 1 under the delta rules' H axis)."""
    delta = kind in ("local_momentum", "fedadam")
    out = []
    for i, co in enumerate(cohorts):
        x, y = (bx[i][:, co], by[i][:, co]) if delta else (bx[i][co],
                                                           by[i][co])
        out.append((torch.from_numpy(np.ascontiguousarray(x)),
                    torch.from_numpy(np.ascontiguousarray(y))))
    return out


def cohort_run(kind, cohorts, *, pipeline, metrics_every=8,
               pool_storage="ram", pool_path=None, resum_every=0,
               batches=None, m=M):
    """One port cohort run of ``kind`` over ``cohorts``: (state, pool, host
    metrics, engine)."""
    delta = kind in ("local_momentum", "fedadam")
    t = cohorts.shape[0]
    params, (bx, by) = (_delta_problem(t, m=m) if delta
                        else _problem(t, m=m))
    if delta:
        eng = CADAEngine(delta_loss, None, CommRule(**_rule(kind)), m,
                         device="cpu", resum_every=resum_every)
    else:
        eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                         CommRule(**_rule(kind)), m, device="cpu",
                         resum_every=resum_every)
    st, pool = eng.init_cohort(
        {k: torch.from_numpy(v) for k, v in params.items()},
        pool_storage=pool_storage, pool_path=pool_path)
    if batches is None:
        batches = cohort_batches(kind, cohorts, bx, by)
    st, mets = eng.run_cohort(st, pool, batches, cohorts, pipeline=pipeline,
                              metrics_every=metrics_every)
    return st, pool, mets, eng


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [torch.as_tensor(x)]


def assert_bit_exact(a, b, what):
    """Two cohort runs' (state, pool, metrics): every state tensor, every
    pool plane and every metric, bit for bit."""
    st_a, pool_a, mets_a = a
    st_b, pool_b, mets_b = b
    assert len(mets_a) == len(mets_b)
    for i, (ma, mb) in enumerate(zip(mets_a, mets_b)):
        assert set(ma) == set(mb)
        for key in ma:
            np.testing.assert_array_equal(
                ma[key], mb[key], err_msg=f"{what}: {key} at round {i}")
    assert st_a.step == st_b.step
    la, lb = _leaves(st_a), _leaves(st_b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: state leaf {i} differs"
    assert pool_a.plane_order == pool_b.plane_order
    for name in pool_a.plane_order:
        assert torch.equal(pool_a.planes[name], pool_b.planes[name]), (
            f"{what}: pool plane {name!r} differs")


# --------------------------------------- pipelined vs serial (every kind)

@pytest.mark.parametrize("kind", ARMS)
def test_pipelined_matches_serial_all_kinds(kind):
    """The pipeline reorders copies, never arithmetic: bit-exact against
    the serial oracle. C = 3 of M = 8 overlap from round to round, so the
    forwarding patch runs."""
    cohorts = sample_cohorts(M, C, STEPS, seed=5)
    assert (F.cohort_overlap_schedule(cohorts) >= 0).any()
    st_s, pool_s, mets_s, _ = cohort_run(kind, cohorts, pipeline=False)
    st_p, pool_p, mets_p, _ = cohort_run(kind, cohorts, pipeline=True)
    assert_bit_exact((st_p, pool_p, mets_p), (st_s, pool_s, mets_s), kind)


def test_pipelined_resum_drains_before_guard():
    """The ``resum_every`` guard reads the host pool: the pipelined driver
    lands the deferred writeback first, so the guarded pipelined run
    equals the guarded serial run, and the run ends on a guard round with
    ∇ equal to the pool's fp64 mean."""
    cohorts = sample_cohorts(M, C, 20, seed=3)
    runs = [cohort_run("cada2", cohorts, pipeline=p, resum_every=5)
            for p in (False, True)]
    assert_bit_exact(runs[1][:3], runs[0][:3], "cada2+resum")
    st, pool = runs[1][:2]
    assert torch.equal(st.server.nabla, pool.resum_nabla())


def test_metrics_every_equivalence():
    """``metrics_every`` batches the device → host fetch only: the values
    are the same at any stride, one larger than the run included."""
    cohorts = sample_cohorts(M, C, STEPS, seed=7)
    runs = [cohort_run("cada2", cohorts, pipeline=True, metrics_every=k)
            for k in (1, 5, STEPS + 10)]
    for run in runs[1:]:
        assert_bit_exact(run[:3], runs[0][:3], "metrics_every")


def test_run_cohort_rounds_rejects_unsorted_cohorts():
    """The overlap schedule searchsorts the previous row, so the drivers
    check the schedule up front instead of forwarding wrong rows."""
    cohorts = sample_cohorts(M, C, 4, seed=5)
    cohorts[2] = cohorts[2][::-1]
    for pipeline in (False, True):
        with pytest.raises(ValueError, match="sorted"):
            cohort_run("cada2", cohorts, pipeline=pipeline)


def test_run_cohort_rounds_empty_schedule():
    """A (0, C) schedule is a no-op on both drivers: (state, []) and no
    pool traffic."""
    params, _ = _problem(1)
    eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                     CommRule(**_rule("cada2")), M, device="cpu")
    st, pool = eng.init_cohort({k: torch.from_numpy(v)
                                for k, v in params.items()})
    for pipeline in (False, True):
        st2, mets = eng.run_cohort(st, pool, [], np.empty((0, C), np.int32),
                                   pipeline=pipeline)
        assert mets == [] and st2 is st
        assert pool.resident_nbytes == pool.nbytes   # nothing staged


# ------------------------------------------------ the overlap schedule

@pytest.mark.parametrize("seed", range(4))
def test_cohort_overlap_schedule_matches_reference(seed):
    """The forwarding schedule equals the reference's on random sorted
    schedules, and points each worker at its row in the previous cohort
    (-1 exactly where it was absent; row 0 forwards nothing)."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(5, 60))
    c = int(rng.integers(1, m))
    cohorts = sample_cohorts(m, c, int(rng.integers(2, 30)), seed=seed)
    src = F.cohort_overlap_schedule(cohorts)
    assert src.dtype == np.int32
    np.testing.assert_array_equal(src, JF.cohort_overlap_schedule(cohorts))
    assert (src[0] == -1).all()
    for i in range(1, cohorts.shape[0]):
        for j, w in enumerate(cohorts[i]):
            hits = np.nonzero(cohorts[i - 1] == w)[0]
            assert src[i, j] == (hits[0] if hits.size else -1)


def test_sample_cohorts_equals_reference():
    """The same sorted ids as the reference's ``sample_cohorts`` (numpy
    draws seeded per (seed, round)), and the same participation masks."""
    for m, c, steps, seed in ((8, 3, 18, 5), (10_000, 64, 6, 0),
                              (256, 32, 40, 1)):
        ids = sample_cohorts(m, c, steps, seed=seed)
        ref = jax_engine.sample_cohorts(m, c, steps, seed=seed)
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, ref)
        from repro_torch.core.engine import cohorts_to_participation
        np.testing.assert_array_equal(
            cohorts_to_participation(ids, m),
            jax_engine.cohorts_to_participation(ref, m))


def test_patch_fused_rows_forwards_prev():
    """The patch takes the previous block's rows at forwarded positions
    and keeps the gathered rows elsewhere."""
    rng = np.random.default_rng(0)
    fused = torch.from_numpy(rng.normal(size=(2, 4, 6)).astype(np.float32))
    prev = torch.from_numpy(rng.normal(size=(2, 5, 6)).astype(np.float32))
    out = F.patch_fused_rows(fused, prev, torch.tensor([3, -1, 0, -1]))
    assert torch.equal(out[:, 0], prev[:, 3])
    assert torch.equal(out[:, 1], fused[:, 1])
    assert torch.equal(out[:, 2], prev[:, 0])
    assert torch.equal(out[:, 3], fused[:, 3])


# ------------------------------------------------- drain on early exit

def test_pipelined_drain_on_early_exit():
    """A pipeline stopped mid-run (the batch supplier raises at round j)
    lands its deferred writeback: the pool holds the serial oracle's state
    after the j completed rounds."""
    j = 9
    cohorts = sample_cohorts(M, C, STEPS, seed=5)
    _, (bx, by) = _problem(STEPS)
    batches = cohort_batches("cada2", cohorts, bx, by)

    class Boom(RuntimeError):
        pass

    def exploding(i, cohort):
        if i == j:
            raise Boom
        return batches[i]

    eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                     CommRule(**_rule("cada2")), M, device="cpu")
    params, _ = _problem(1)
    st, pool = eng.init_cohort({k: torch.from_numpy(v)
                                for k, v in params.items()})
    with pytest.raises(Boom):
        eng.run_cohort(st, pool, exploding, cohorts, pipeline=True)
    _, pool_s, _, _ = cohort_run("cada2", cohorts[:j], pipeline=False,
                                 batches=batches[:j])
    for name in pool_s.plane_order:
        assert torch.equal(pool.planes[name], pool_s.planes[name]), name


# ------------------------------------------------------- memmap pool

def test_memmap_pipelined_matches_ram(tmp_path):
    """The storage is invisible to the numbers: a pipelined run over a
    memmap pool equals the RAM pool's run bit for bit."""
    cohorts = sample_cohorts(M, C, STEPS, seed=5)
    ram = cohort_run("laq", cohorts, pipeline=True)
    mm = cohort_run("laq", cohorts, pipeline=True, pool_storage="memmap",
                    pool_path=str(tmp_path))
    assert_bit_exact(mm[:3], ram[:3], "memmap-vs-ram")
    assert mm[1].mapped_nbytes == ram[1].nbytes
    assert (tmp_path / "worker_grads.plane").exists()


# ------------------------------------------ the LM trainer's cohort step

ARCH = "stablelm-1.6b"
TM, TC_, T_ROUNDS, SEQ1, LR = 4, 2, 4, 33, 1e-3
T_RULE = dict(c=20.0, d_max=4, max_delay=10)
STATE_TOL = 1e-5
INT_EXTRAS = ("slot", "ring_version", "period")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


@pytest.mark.parametrize("kind", ["cada2", "local_momentum"])
def test_trainer_cohort_lockstep_with_jax(kind):
    h = 2 if kind == "local_momentum" else 1
    rule_kw = dict(kind=kind, local_steps=h, **T_RULE)
    jcfg, tcfg = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    jhp = JT.TrainHParams(rule=JaxRule(**rule_kw), lr=LR)
    thp = TT.TrainHParams(rule=CommRule(**rule_kw), lr=LR)
    j_step = JT.make_cohort_train_step(jcfg, jhp, TM)
    t_step = TT.make_cohort_train_step(tcfg, thp, TM)
    j_state, j_pool = JT.init_cohort_train_state(jcfg, jhp, TM,
                                                 jax.random.PRNGKey(0))
    cohorts = sample_cohorts(TM, TC_, T_ROUNDS, seed=1)
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, jcfg.vocab, (2 * h * TC_, SEQ1)).astype(np.int32)
            for _ in range(T_ROUNDS)]
    t_batches = [TT.worker_split({"tokens": torch.from_numpy(t).long()},
                                 TC_, local_steps=h) for t in toks]
    skips, worst = 0, (0.0, "")
    for k in range(T_ROUNDS):
        j_prev = jax.tree.map(np.array, j_state)
        planes_prev = {n: p.copy() for n, p in j_pool.planes.items()}
        t_state = convert.cohort_state_from_numpy(j_prev, "cpu")
        t_pool = convert.pool_from_numpy(j_pool, device="cpu")
        j_state, jm = j_step(j_state, j_pool, JT.worker_split(
            {"tokens": jnp.asarray(toks[k])}, TC_, local_steps=h),
            cohorts[k])
        t_next, tm = t_step(t_state, t_pool, t_batches[k], cohorts[k])
        j = jax.tree.map(np.asarray, j_state)
        jm = jax.tree.map(np.asarray, jm)

        np.testing.assert_array_equal(tm["upload_mask"].numpy(),
                                      jm["upload_mask"])
        skips += int((~jm["upload_mask"]).sum())
        assert t_next.step == k + 1
        np.testing.assert_array_equal(t_next.server.staleness.numpy(),
                                      j.server.staleness)
        for key in INT_EXTRAS:
            if key in j.server.extras:
                np.testing.assert_array_equal(
                    t_next.server.extras[key].numpy(), j.server.extras[key])
        off = np.setdiff1d(np.arange(TM), cohorts[k])
        theta = _np(j_prev.params_flat)
        d_ref = _np(j.params_flat) - theta
        pairs = [("params update", d_ref,
                  _np(t_next.params_flat) - theta),
                 ("h", j.h, t_next.h), ("vhat", j.vhat, t_next.vhat),
                 ("nabla", j.server.nabla, t_next.server.nabla),
                 ("loss", jm["loss"], tm["loss"])]
        for name in t_pool.plane_order:
            ref = _np(j_pool.planes[name])
            got = _np(t_pool.planes[name])
            # rows outside the cohort are untouched on both sides
            np.testing.assert_array_equal(ref[off], planes_prev[name][off])
            np.testing.assert_array_equal(got[off], ref[off])
            pairs.append((f"pool.{name}", ref[cohorts[k]],
                          got[cohorts[k]]))
        for name, v in dict(j.server.extras).items():
            if name in INT_EXTRAS:
                continue
            tv = t_next.server.extras[name]
            if isinstance(v, dict):    # a parameter tree (the ring)
                pairs += [(f"{name}[{i}]", a, b) for i, (a, b) in
                          enumerate(zip(jax.tree.leaves(v),
                                        tree_leaves(tv)))]
            else:
                pairs.append((name, v, tv))
        spacing = np.spacing(np.abs(theta + d_ref))
        for name, a, b in pairs:
            a, b = _np(a), _np(b)
            assert a.shape == b.shape, name
            scale = max(np.abs(a).max(), 1e-30)
            gap = np.abs(b - a) - (spacing if name == "params update"
                                   else 0.0)
            assert (gap <= STATE_TOL * scale).all(), (
                f"{kind} {name} at round {k}: {gap.max() / scale:.3g} of "
                "scale")
            worst = max(worst, (float(gap.max() / scale), name))
    print(f"\ntrainer cohort {kind}: largest gap {worst[0]:.3g} of scale "
          f"({worst[1]}), {skips} skips")
    if kind == "cada2":
        assert skips > 0, "the gate never skipped: the test is vacuous"

    # the port's pipelined driver over the same rounds equals its serial
    runs = []
    for pipeline in (False, True):
        st, pool = TT.init_cohort_train_state(tcfg, thp, TM, 0,
                                              device="cpu")
        st, mets = TT.run_cohort_train(t_step, st, pool, t_batches, cohorts,
                                       pipeline=pipeline, metrics_every=3)
        runs.append((st, pool, mets))
    assert_bit_exact(runs[1], runs[0], f"trainer {kind}")
