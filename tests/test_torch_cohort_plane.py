"""The port's cohort plane (``core/flat.py::flat_cohort_round``,
``WorkerPool``, ``CADAEngine.init_cohort/step_cohort/run_cohort``).

Three contracts:

  * Against the JAX package's cohort plane, in lockstep, for every rule
    kind and the sparse top-k wire (logreg on ijcnn1_like, M = 8, C = 3,
    12 rounds; the delta rules at H = 2 on a least-squares problem, on
    their own servers). Each round the reference's round-k state and pool
    are loaded into the port (``convert.cohort_state_from_numpy``,
    ``convert.pool_from_numpy``) and both take one ``step_cohort`` on the
    same numpy batch of the cohort. Upload masks, staleness, slots, ring
    versions and avp periods are exact (no gate margin of these runs lies
    near its threshold), and so are the pool rows outside the cohort.
    Float state is held to the band that ``test_torch_lockstep.py`` states
    and explains: STATE_TOL of each array's scale, with the wire
    differences of a b-bit or top-k wire checked and counted by
    ``lockstep_wire.py`` and their columns left out of the server-side
    arrays.
  * Against the port's own dense plane run with the cohort as its
    participation mask (``cohorts_to_participation``): bit for bit, every
    kind, delta rules included, as the reference pins its planes
    (``tests/test_cohort_plane.py``). On the CPU the port's gradient rows
    do not depend on how many workers one vmapped call evaluates, so there
    is no exception.
  * The pool: gather/scatter round trips in fp32 and bf16, RAM and
    memmap; which planes each rule pools; ``resum_nabla`` against the
    reference's on the same planes, and the drift guard; a pool
    checkpoint crossing the two packages in both directions, resharded to
    another ``n_flat``; the M = 10⁴ federated smoke.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jax_ckpt
from repro.core import comm as jax_comm
from repro.core import flat as JF
from repro.core.engine import CADAEngine as JaxEngine
from repro.core.rules import CommRule as JaxRule
from repro.models.small import logreg_loss as jax_logreg_loss
from repro.optim.fused import FusedAMSGrad as JaxFusedAMSGrad
from repro_torch import convert
from repro_torch.checkpoint import io as ckpt
from repro_torch.core import comm
from repro_torch.core import flat as F
from repro_torch.core.engine import (CADAEngine, cohorts_to_participation,
                                     make_cohort_sampler, sample_cohorts)
from repro_torch.core.rules import KINDS, CommRule
from repro_torch.data import mnist_like, pad_to_matrix, uniform_partition
from repro_torch.models.small import logreg_loss, mlp_init, mlp_loss
from repro_torch.optim.fused import FusedAMSGrad
from repro_torch.utils.trees import tree_leaves
from lockstep_wire import wire_differences
from test_torch_cohort_pipeline import (_delta_problem, _problem, _rule,
                                        cohort_batches, cohort_run,
                                        delta_loss)

torch.set_num_threads(1)

M, C = 8, 3
ARMS = KINDS + ("topk_sparse",)
DELTA = ("local_momentum", "fedadam")
LOCK_ROUNDS = 12
STATE_TOL = 1e-4
MAX_WIRE_DIFF_SHARE = 1e-3
INT_EXTRAS = ("slot", "ring_version", "period")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _jax_delta_loss(p, b):
    x, y = b
    return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)


def _opt_arrays(opt_state, layout):
    """name -> flat float array of every optimizer-state field but the
    count (dict fields packed in the port's layout order)."""
    if not hasattr(opt_state, "_fields"):
        return {}
    out = {}
    for f in opt_state._fields:
        v = getattr(opt_state, f)
        if f == "count":
            continue
        if isinstance(v, dict):
            v = layout.pack({k: x if torch.is_tensor(x)
                             else torch.from_numpy(np.array(x, np.float32))
                             for k, x in v.items()})
        out[f] = _np(v)
    return out


# ------------------------------------------ port cohort vs JAX cohort

@pytest.mark.parametrize("kind", ARMS)
def test_cohort_lockstep_with_jax(kind):
    delta = kind in DELTA
    rule = _rule(kind)
    params, (bx, by) = (_delta_problem(LOCK_ROUNDS) if delta
                        else _problem(LOCK_ROUNDS))
    cohorts = sample_cohorts(M, C, LOCK_ROUNDS, seed=5)
    if delta:
        j_eng = JaxEngine(_jax_delta_loss, None, JaxRule(**rule), M)
        t_eng = CADAEngine(delta_loss, None, CommRule(**rule), M,
                           device="cpu")
    else:
        j_eng = JaxEngine(jax_logreg_loss, JaxFusedAMSGrad(lr=0.05),
                          JaxRule(**rule), M)
        t_eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                           CommRule(**rule), M, device="cpu")
    j_state, j_pool = j_eng.init_cohort(jax.tree.map(jnp.asarray, params))
    batches = cohort_batches(kind, cohorts, bx, by)
    uploads = skips = wire_diffs = uploaded = 0
    worst = (0.0, "")
    for k in range(LOCK_ROUNDS):
        co = cohorts[k]
        j_prev = jax.tree.map(np.array, j_state)
        planes_prev = {n: np.array(p) for n, p in j_pool.planes.items()}
        t_state = convert.cohort_state_from_numpy(j_prev, "cpu")
        t_pool = convert.pool_from_numpy(j_pool, device="cpu")
        assert t_state.step == k
        assert t_pool.plane_order == j_pool.plane_order
        j_state, jm = j_eng.step_cohort(
            j_state, j_pool, tuple(jnp.asarray(b.numpy())
                                   for b in batches[k]), co)
        t_next, tm = t_eng.step_cohort(t_state, t_pool, batches[k], co)
        layout = t_eng._layout
        j = jax.tree.map(np.asarray, j_state)
        jm = jax.tree.map(np.asarray, jm)

        j_up = jm["upload_mask"]
        np.testing.assert_array_equal(tm["upload_mask"].numpy(), j_up,
                                      err_msg=f"{kind} round {k}")
        uploads += int(j_up.sum())
        skips += int((~j_up).sum())
        assert t_next.step == k + 1
        np.testing.assert_array_equal(t_next.server.staleness.numpy(),
                                      j.server.staleness)
        np.testing.assert_array_equal(tm["staleness"].numpy(),
                                      jm["staleness"])
        for key in INT_EXTRAS:
            if key in j.server.extras:
                assert t_next.server.extras[key].dtype == torch.int32
                np.testing.assert_array_equal(
                    t_next.server.extras[key].numpy(), j.server.extras[key],
                    err_msg=key)
        for key in ("uploads", "grad_evals"):
            assert int(tm[key]) == int(jm[key]), key
        np.testing.assert_allclose(float(tm["bytes_up"]),
                                   float(jm["bytes_up"]), rtol=1e-6)
        jl, tl = np.asarray(jm["lhs"]), tm["lhs"].numpy()
        assert np.array_equal(np.isfinite(jl), np.isfinite(tl))
        assert np.array_equal(jl[~np.isfinite(jl)], tl[~np.isfinite(tl)])

        # pool rows outside the cohort are untouched on both sides
        off = np.setdiff1d(np.arange(M), co)
        for name in t_pool.plane_order:
            np.testing.assert_array_equal(_np(j_pool.planes[name])[off],
                                          planes_prev[name][off])
            np.testing.assert_array_equal(_np(t_pool.planes[name])[off],
                                          planes_prev[name][off])
        # the cohort's uploaded rows: wire differences, and their columns
        wg_prev = planes_prev["worker_grads"][co]
        wg_ref = _np(j_pool.planes["worker_grads"])[co]
        flagged, _ = wire_differences(
            t_eng.rule, layout, STATE_TOL, wg_prev, wg_ref,
            _np(t_pool.planes["worker_grads"])[co])
        cols = flagged.any(axis=0)
        wire_scale = float(np.abs(wg_ref - wg_prev).max())
        wire_diffs += int(flagged.sum())
        uploaded += int(j_up.sum()) * layout.n

        pairs = [("params_flat", j.params_flat, t_next.params_flat, "col"),
                 ("nabla", j.server.nabla, t_next.server.nabla, "col"),
                 ("loss", jm["loss"], tm["loss"], None),
                 ("rhs", jm["rhs"], tm["rhs"], None),
                 ("lhs", jl[np.isfinite(jl)], tl[np.isfinite(tl)], None)]
        pairs += [(f"pool.{name}", _np(j_pool.planes[name])[co],
                   _np(t_pool.planes[name])[co],
                   "entry" if name in ("worker_grads", "residual")
                   else None) for name in t_pool.plane_order]
        jo, to = (_opt_arrays(j.opt_state, layout),
                  _opt_arrays(t_next.opt_state, layout))
        assert sorted(jo) == sorted(to)
        pairs += [(f"opt.{n}", jo[n], to[n], "col") for n in jo]
        for name, v in dict(j.server.extras).items():
            if name in INT_EXTRAS:
                continue
            tv = t_next.server.extras[name]
            pairs += [(f"{name}[{i}]", a, b, None) for i, (a, b) in
                      enumerate(zip(jax.tree.leaves(v), tree_leaves(tv)))]
        for name, a, b, where in pairs:
            a, b = _np(a), _np(b)
            assert a.shape == b.shape, name
            keep = (np.ones(a.shape, bool) if where is None
                    else ~flagged if where == "entry"
                    else ~np.broadcast_to(cols, a.shape))
            if not keep.any():
                continue
            scale = max(np.abs(a).max(),
                        wire_scale if name == "pool.residual" else 0.0,
                        1e-30)
            np.testing.assert_allclose(b[keep], a[keep], rtol=0,
                                       atol=STATE_TOL * scale,
                                       err_msg=f"{kind} {name} round {k}")
            worst = max(worst, (float(np.abs(b - a)[keep].max() / scale),
                                name))
        # the RHS ring: the newest entry Σ Δθ², off by at most what the
        # columns of a wire difference move
        theta = _np(j_prev.params_flat).astype(np.float64)
        d_ref = (_np(j.params_flat).astype(np.float64) - theta)[cols]
        d_port = (_np(t_next.params_flat).astype(np.float64) - theta)[cols]
        slack = float(np.abs(d_port ** 2 - d_ref ** 2).sum()) * 1.01
        a, b = _np(j.server.diff_hist), _np(t_next.server.diff_hist)
        new = k % len(a)
        scale = max(np.abs(a).max(), 1e-30)
        assert abs(b[new] - a[new]) <= STATE_TOL * scale + slack
        others = np.arange(len(a)) != new
        np.testing.assert_array_equal(b[others], a[others])
    print(f"\ncohort {kind}: largest gap {worst[0]:.3g} of scale "
          f"({worst[1]}), {uploads} uploads, {skips} skips, {wire_diffs} "
          f"wire differences in {uploaded} uploaded entries")
    assert uploads > 0
    assert wire_diffs <= MAX_WIRE_DIFF_SHARE * uploaded
    if rule["kind"] not in ("always",) + DELTA:
        assert skips > 0, "the gate never skipped: the test is vacuous"


# ---------------------------------- port cohort vs port dense (bit for bit)

@pytest.mark.parametrize("kind", ARMS)
def test_cohort_matches_dense_all_kinds(kind):
    """The cohort plane against the dense plane with the cohort's
    participation mask: masks, staleness, θ, ∇, the RHS ring, the worker
    planes and every extra, bit for bit."""
    steps = 24
    delta = kind in DELTA
    cohorts = sample_cohorts(M, C, steps, seed=5)
    params, (bx, by) = (_delta_problem(steps) if delta else _problem(steps))
    if delta:
        eng = CADAEngine(delta_loss, None, CommRule(**_rule(kind)), M,
                         device="cpu")
    else:
        eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                         CommRule(**_rule(kind)), M, device="cpu")
    st_d, m_d = eng.run(
        eng.init({k: torch.from_numpy(v) for k, v in params.items()}),
        (torch.from_numpy(bx), torch.from_numpy(by)),
        participation=torch.from_numpy(cohorts_to_participation(cohorts,
                                                                M)))
    st_c, pool, m_c, _ = cohort_run(kind, cohorts, pipeline=True)
    for i, mm in enumerate(m_c):
        np.testing.assert_array_equal(
            mm["upload_mask"], m_d["upload_mask"][i][cohorts[i]].numpy(),
            err_msg=f"{kind}: round {i} masks")
        off = np.ones(M, bool)
        off[cohorts[i]] = False
        assert not m_d["upload_mask"][i][off].any()
    assert 0 < sum(int(mm["uploads"]) for mm in m_c)
    pairs = [("staleness", st_c.server.staleness, st_d.comm.staleness),
             ("nabla", st_c.server.nabla, st_d.comm.nabla),
             ("diff_hist", st_c.server.diff_hist, st_d.comm.diff_hist),
             ("params_flat", st_c.params_flat, st_d.params_flat),
             ("worker_grads", pool.planes["worker_grads"],
              st_d.comm.worker_grads)]
    pairs += [(name, pool.planes[name], st_d.comm.extras[name])
              for name in eng_pooled(kind)]
    for name, val in st_c.server.extras.items():
        pairs += [(f"{name}[{i}]", a, b) for i, (a, b) in enumerate(
            zip(tree_leaves(val), tree_leaves(st_d.comm.extras[name])))]
    for name, a, b in pairs:
        assert torch.equal(a, b), f"{kind}: {name} differs"


def eng_pooled(kind):
    return comm.strategy_for(CommRule(**_rule(kind))).pooled_extras()


def test_pool_split_per_rule():
    """Which state lands where: the O(M·n) planes in the pool, the rest
    on the server, no server extra an (M, n_flat) plane; laq without error
    feedback pools no residual. The same split as the reference's."""
    params = {"w": torch.zeros(22, 2), "b": torch.zeros(2)}
    lay = F.layout_of(params)
    want = {"cada1": {"worker_delta"}, "laq": {"residual"},
            "topk": {"residual"}, "local_momentum": {"momenta"}}
    jparams = {"w": jnp.zeros((22, 2)), "b": jnp.zeros((2,))}
    jlay = JF.layout_of(jparams)
    for kind in KINDS:
        strat = comm.strategy_for(CommRule(**_rule(kind)))
        server, pool = F.init_cohort_state(strat, lay, params, M)
        assert set(pool.plane_order) == {"worker_grads"} | want.get(
            kind, set()), kind
        _, jpool = JF.init_cohort_state(
            jax_comm.strategy_for(JaxRule(**_rule(kind))), jlay, jparams, M)
        assert pool.plane_order == jpool.plane_order, kind
        for t in tree_leaves(dict(server.extras)):
            assert tuple(t.shape[:2]) != (M, lay.n_flat), kind
    strat = comm.strategy_for(CommRule(kind="laq", error_feedback=False))
    _, pool = F.init_cohort_state(strat, lay, params, M)
    assert pool.plane_order == ("worker_grads",)


# ------------------------------------------------------------ the pool

@pytest.mark.parametrize("storage", ["ram", "memmap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pool_gather_scatter_roundtrip(tmp_path, storage, dtype):
    """pool → (C, n_flat) → pool is bit-exact in fp32 and bf16, RAM and
    memmap; rows outside the cohort are never touched; a memmap pool keeps
    its planes in files and only its staging slots in RAM."""
    g = torch.Generator().manual_seed(0)
    m, n_flat = 32, 48
    planes = {name: torch.randn(m, n_flat, generator=g).to(dtype)
              for name in ("worker_grads", "residual")}
    pool = F.WorkerPool({k: v.clone() for k, v in planes.items()},
                        storage=storage, path=str(tmp_path), device="cpu")
    assert pool.plane_dtype == dtype
    assert pool.nbytes == 2 * m * n_flat * planes["residual"].element_size()
    if storage == "memmap":
        assert (tmp_path / "worker_grads.plane").exists()
        assert pool.mapped_nbytes == pool.nbytes
        assert pool.resident_nbytes == 0
    cohort = np.sort(np.random.default_rng(0).choice(m, 7, replace=False))
    rows = pool.gather(cohort)
    for name in planes:
        assert rows[name].shape == (7, n_flat)
        assert torch.equal(rows[name], planes[name][cohort])
    assert pool.resident_nbytes >= 2 * 2 * 7 * n_flat * rows[
        "residual"].element_size()
    pool.scatter(cohort, rows)        # identity: the whole pool unchanged
    for name in planes:
        assert torch.equal(pool.planes[name], planes[name])
    new = {name: torch.randn(7, n_flat, generator=g).to(dtype)
           for name in planes}
    pool.scatter(cohort, new)
    pool.flush()
    off = np.setdiff1d(np.arange(m), cohort)
    for name in planes:
        assert torch.equal(pool.planes[name][cohort], new[name])
        assert torch.equal(pool.planes[name][off], planes[name][off])
    if storage == "memmap":
        disk = np.fromfile(tmp_path / "residual.plane",
                           dtype=np.uint16 if dtype == torch.bfloat16
                           else np.float32).reshape(m, n_flat)
        got = pool.planes["residual"]
        want = (got.view(torch.int16).numpy().view(np.uint16)
                if dtype == torch.bfloat16 else got.numpy())
        np.testing.assert_array_equal(disk, want)


def test_resum_nabla_equals_reference():
    """The drift guard's fp64 re-sum gives the reference's fp32 bits on the
    same planes, and the guarded run ends with ∇ equal to it."""
    rng = np.random.default_rng(3)
    planes = {"worker_grads": rng.normal(size=(50, 40)).astype(np.float32)}
    jpool = JF.WorkerPool({k: v.copy() for k, v in planes.items()})
    pool = convert.pool_from_numpy(planes, device="cpu")
    np.testing.assert_array_equal(pool.resum_nabla().numpy(),
                                  jpool.resum_nabla())
    cohorts = sample_cohorts(M, C, 20, seed=3)
    st, pool, mets, _ = cohort_run("cada2", cohorts, pipeline=False,
                                   resum_every=5)
    assert torch.equal(st.server.nabla, pool.resum_nabla())
    assert np.isfinite([m["loss"] for m in mets]).all()
    # unguarded, the incremental aggregate sits within fp32 rounding of
    # the invariant the guard restores
    st_u, pool_u, _, _ = cohort_run("cada2", cohorts, pipeline=False)
    gap = (st_u.server.nabla.double() - pool_u.resum_nabla().double()).abs()
    assert float(gap.max()) < 1e-6


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
def test_pool_checkpoint_crosses_packages(tmp_path, direction):
    """A pool's planes saved by one package restore into the other's pool
    cut for another ``n_flat`` (the reference's 16-shard layout): the true
    entries bit for bit (bf16 by its bits), the padding tail zero, and a
    memmap pool loaded in place stays mapped."""
    params = {"w": np.zeros((22, 2), np.float32),
              "b": np.zeros((2,), np.float32)}
    lay_src = F.layout_of({k: torch.from_numpy(v) for k, v in
                           params.items()})
    lay_dst = JF.layout_of(jax.tree.map(jnp.asarray, params), shards=16)
    assert lay_src.n_flat != lay_dst.n_flat and lay_src.n == lay_dst.n
    n = lay_src.n
    rng = np.random.default_rng(1)
    vals = {name: rng.normal(size=(M, n)).astype(ml_dtypes.bfloat16)
            for name in ("worker_grads", "residual")}
    path = str(tmp_path / "ck")
    if direction == "port->jax":
        src = {name: np.zeros((M, lay_src.n_flat), ml_dtypes.bfloat16)
               for name in vals}
        for name in vals:
            src[name][:, :n] = vals[name]
        pool = convert.pool_from_numpy(src, storage="memmap",
                                       path=str(tmp_path / "src"),
                                       device="cpu")
        ckpt.save(path, {"pool": pool.state_dict()}, step=3,
                  flat_meta=lay_src)
        template = {"pool": {name: np.zeros((M, lay_dst.n_flat),
                                            ml_dtypes.bfloat16)
                             for name in vals}}
        restored, step = jax_ckpt.restore(path, template)
        dst = JF.WorkerPool({name: np.zeros((M, lay_dst.n_flat),
                                            ml_dtypes.bfloat16)
                             for name in vals})
        dst.load_state_dict(restored["pool"])
        got = {name: np.asarray(dst.planes[name]) for name in vals}
    else:
        src = JF.WorkerPool({name: np.zeros((M, lay_src.n_flat),
                                            ml_dtypes.bfloat16)
                             for name in vals})
        for name in vals:
            src.planes[name][:, :n] = vals[name]
        jax_ckpt.save(path, {"pool": src.state_dict()}, step=3,
                      flat_meta=lay_src)
        dst = F.WorkerPool(
            {name: torch.zeros(M, lay_dst.n_flat, dtype=torch.bfloat16)
             for name in vals}, storage="memmap",
            path=str(tmp_path / "dst"), device="cpu")
        restored, step = ckpt.restore(path, {"pool": dst.state_dict()})
        dst.load_state_dict(restored["pool"])
        for name in vals:
            assert dst._maps[name] is not None
            assert np.shares_memory(dst._maps[name],
                                    dst.planes[name].view(
                                        torch.int16).numpy())
        got = {name: dst.planes[name].view(torch.int16).numpy().view(
            ml_dtypes.bfloat16) for name in vals}
    assert step == 3
    for name in vals:
        assert got[name].shape == (M, lay_dst.n_flat)
        np.testing.assert_array_equal(got[name][:, :n].view(np.uint16),
                                      vals[name].view(np.uint16))
        assert not got[name][:, n:].view(np.uint16).any()


# ------------------------------------------------ federated magnitude

def test_federated_smoke_m_10k():
    """M = 10⁴ workers, C = 64, an MLP on mnist_like(20,000) in shards of
    2 (the reference's federated smoke at another model): the pool holds
    the O(M·n) plane on the host, the state holds nothing O(M·n), a round
    moves C rows, round 0 uploads its whole cohort, and the pipelined run
    equals the serial one."""
    m, c, rounds = 10_000, 64, 4
    ds = mnist_like(n=20_000)
    x = ds.x.reshape(ds.n, -1)[:, :64].copy()
    mtx = pad_to_matrix(uniform_partition(ds.n, m, seed=0))
    assert mtx.shape == (m, 2)
    sample = make_cohort_sampler(x, ds.y, mtx, 4, device="cpu")
    params = mlp_init(torch.Generator().manual_seed(7), 64, 16, 10,
                      device="cpu")
    cohorts = sample_cohorts(m, c, rounds, seed=0)
    gen = torch.Generator().manual_seed(1)
    batches = [sample(gen, cohorts[i]) for i in range(rounds)]
    runs = []
    for pipeline in (False, True):
        eng = CADAEngine(mlp_loss, FusedAMSGrad(lr=0.05),
                         CommRule(kind="cada2", c=0.6, d_max=10,
                                  max_delay=100), m, device="cpu")
        st, pool = eng.init_cohort(params)
        n_flat = eng._layout.n_flat
        assert pool.nbytes == m * n_flat * 4
        assert pool.device_row_bytes(c) == c * n_flat * 4
        st, mets = eng.run_cohort(st, pool, batches, cohorts,
                                  pipeline=pipeline, metrics_every=3)
        for t in tree_leaves({"s": dict(st.server.extras)}) + [
                st.server.nabla, st.params_flat]:
            assert not (t.dim() >= 2 and t.shape[0] == m
                        and t.shape[-1] == n_flat)
        assert np.isfinite([mm["loss"] for mm in mets]).all()
        assert int(mets[0]["uploads"]) == c
        runs.append((st, pool, mets))
    from test_torch_cohort_pipeline import assert_bit_exact
    assert_bit_exact(runs[1], runs[0], "M=10^4")


@pytest.mark.parametrize("kind", ["cada2", "cada1", "laq", "local_momentum"])
def test_cohort_round_matches_dense_round_bf16_state(kind):
    """With bf16 CADA state (the LM trainer's ``cada_dtype="bfloat16"``)
    one cohort round from the dense state's split equals the dense round
    with the cohort's participation mask, bit for bit: ∇, masks,
    staleness, the worker rows and the pooled extras."""
    steps = 6
    delta = kind in DELTA
    params, (bx, by) = (_delta_problem(steps) if delta else _problem(steps))
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    eng = CADAEngine(delta_loss if delta else logreg_loss, None,
                     CommRule(**_rule(kind)), M, device="cpu")
    strat, layout = eng.strategy, F.layout_of(params)
    pflat = layout.pack(params)
    comm_d = F.init_flat_comm_state(strat, layout, params, M,
                                    grad_dtype=torch.bfloat16)
    server, pool = F.init_cohort_state(strat, layout, params, M,
                                       grad_dtype=torch.bfloat16)
    cohorts = sample_cohorts(M, C, steps, seed=2)
    part = cohorts_to_participation(cohorts, M)
    kw = dict(vgrad=eng._vgrad, vgrad_per=eng._vgrad_per)
    for k in range(steps):
        co = cohorts[k]
        full = (torch.from_numpy(bx[k]), torch.from_numpy(by[k]))
        out_d = F.flat_comm_round(strat, layout, comm_d, params, pflat, full,
                                  k, participation=torch.from_numpy(part[k]),
                                  **kw)
        idx = torch.as_tensor(co, dtype=torch.long)
        sub = tuple(b[:, idx] if delta else b[idx] for b in full)
        out_c = F.flat_cohort_round(strat, layout, server, pool.gather(co),
                                    params, pflat, sub, k, idx, m_total=M,
                                    **kw)
        pool.scatter(co, out_c.rows)
        assert torch.equal(out_c.upload, out_d.upload[idx])
        dsq = torch.tensor(0.01 * (k + 1))
        comm_d = F.record_progress(out_d.comm, dsq, k)
        server = F.record_progress(out_c.server, dsq, k)
        assert comm_d.worker_grads.dtype == torch.bfloat16
        assert torch.equal(server.nabla, comm_d.nabla)
        assert torch.equal(server.staleness, comm_d.staleness)
        assert torch.equal(pool.planes["worker_grads"], comm_d.worker_grads)
        for name in strat.pooled_extras():
            assert torch.equal(pool.planes[name], comm_d.extras[name]), name
        for name, v in server.extras.items():
            for a, b in zip(tree_leaves(v), tree_leaves(comm_d.extras[name])):
                assert torch.equal(a, b), name


# -------------------------------------------- the card unless asked

def _cohort_entry_points():
    import repro_torch.configs as TC
    from repro_torch.distributed import trainer as TT

    def state():
        eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.05),
                         CommRule(**_rule("cada2")), M, device="cpu")
        st, pool = eng.init_cohort({"w": torch.zeros(22, 2),
                                    "b": torch.zeros(2)})
        return st, pool

    def numpy_state(x):
        if torch.is_tensor(x):
            return x.numpy()
        if isinstance(x, dict):
            return {k: numpy_state(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(numpy_state(v) for v in x))
        return x

    return {
        "WorkerPool": lambda: F.WorkerPool(
            {"worker_grads": torch.zeros(4, 8)}),
        "pool_from_numpy": lambda: convert.pool_from_numpy(
            {"worker_grads": np.zeros((4, 8), np.float32)}),
        "cohort_state_from_numpy": lambda: convert.cohort_state_from_numpy(
            numpy_state(state()[0])),
        "make_cohort_sampler": lambda: make_cohort_sampler(
            np.ones((8, 3), np.float32), np.zeros(8, np.int32),
            np.arange(8).reshape(2, 4), 2),
        "init_cohort_train_state": lambda: TT.init_cohort_train_state(
            TC.get_smoke_config("stablelm-1.6b"), TT.TrainHParams(), 2, 0),
    }


@pytest.mark.parametrize("name", ["WorkerPool", "pool_from_numpy",
                                  "cohort_state_from_numpy",
                                  "make_cohort_sampler",
                                  "init_cohort_train_state"])
def test_cohort_entry_point_refuses_the_cpu_by_default(name):
    """The cohort plane's entry points run on the card unless given
    ``device="cpu"``: without a CUDA device, given none, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cohort_entry_points()[name]()
