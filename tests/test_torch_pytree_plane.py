"""The port's per-leaf pytree plane (``fused=False``) against the JAX
package's, and against the port's own flat plane.

* ``comm.comm_round`` and ``CADAEngine(fused=False).step`` in lockstep with
  the reference's for all ten kinds (the eight gradient rules on
  ``FusedAMSGrad``, whose pytree step is ``ops.fused_cada_update``; the
  delta rules at H = 2 on their own servers): logreg on ijcnn1_like, M = 4,
  batch 8, 16 rounds, lr 0.01, c = 0.3 (topk: 30, at topk_frac 0.54),
  d_max 3, max_delay 5, each round started
  from the reference's state (``convert.engine_state_from_numpy``; the
  round test hands both sides the reference's round-k CommState and
  parameters). The engine runs with and without a partial-participation
  mask. The JAX side runs jitted on the CPU, as its own tests run it.
  Contract, as ``test_torch_lockstep.py``'s: masks, staleness, avp's
  periods, upload and gradient-evaluation counts exact (a worker whose
  reference gate margin |LHS − RHS| is within MARGIN_BAND · RHS may flip:
  that round's float state is not compared, and at most one round a run
  may flip); every float array (θ, the moments, ∇, the worker copies, the
  rules' extras, the finite LHS, the loss, the RHS ring) within
  STATE_TOL = 1e-4 of its scale. The two frameworks round the gradients
  and the moment update differently (XLA's FMA), and the pytree plane's
  eq. (3) is a per-leaf mean, whose order neither side fixes (measured
  here, ``pytest -s``: at most 2.3e-5 of scale, ∇ in always' round). A b-bit or
  top-k wire turns that gap into whole levels or support swaps at a few
  entries, checked and counted as there (``lockstep_wire.py``).
* The port's pytree plane against its flat plane, all ten kinds, 8 rounds
  free-running at the reference's settings for this pair: masks and
  staleness exact, parameters within rtol 1e-4 and atol 1e-6 (its
  contract, ``tests/test_flat_plane.py``).
* ``ops.fused_cada_update`` and ``FusedAMSGrad.init``/``apply`` on a tree
  of odd leaf sizes (one bf16 leaf) against the reference: θ', h', v̂'
  within 2⁻²⁰ of each array's scale and Σupd² within rtol 1e-5 (ROADMAP's
  "Moment update": about one ULP, from XLA's FMA).
* The ``utils/trees`` helpers against the reference's.
* The trainer's ``fused=False`` pair (engine and trainer on the pytree
  plane, cada2; ``tests/test_parity_engine_trainer.py``'s pair): masks and
  staleness equal, parameters within rtol 1e-4, atol 1e-6.
* The cohort plane refuses ``fused=False``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm as jcomm
from repro.core.engine import CADAEngine as JaxEngine
from repro.core.rules import CommRule as JaxRule
from repro.kernels import ops as jops
from repro.models.small import logreg_loss as jax_logreg_loss
from repro.optim.fused import FusedAMSGrad as JaxFusedAMSGrad
from repro.utils import trees as jtrees
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core import comm as tcomm
from repro_torch.core.engine import CADAEngine
from repro_torch.core.rules import KINDS, LOCAL_RULES, CommRule
from repro_torch.data import ijcnn1_like, pad_to_matrix, uniform_partition
from repro_torch.distributed import trainer as TT
from repro_torch.kernels import ops as tops
from repro_torch.models.model import lm_loss
from repro_torch.models.small import logreg_loss
from repro_torch.optim.adam import adam
from repro_torch.optim.fused import FusedAMSGrad
from repro_torch.utils import trees as ttrees
from lockstep_pytree import Packer, Tally, check_tally, compare_round, np32

torch.set_num_threads(1)

M, BATCH, ROUNDS, H = 4, 8, 16, 2
# the free run of the two planes: as many rounds as the reference's test of
# the pair (tests/test_flat_plane.py); a free run with a quantized wire
# parts once one level flips
FREE_ROUNDS = 8
RULE = dict(c=0.3, d_max=3, max_delay=5)
LR = 0.01
STATE_TOL = 1e-4
ULP_SCALE = 2.0 ** -20


# topk: the 2-class logreg's weight gradient comes in mirrored pairs
# (column 1 = −column 0) of equal magnitude, so a k that splits a pair
# leaves the kept entry to the last bit of rounding on each side; at
# topk_frac 0.54 each leaf keeps whole pairs (24 of 44, 2 of 2). Its
# error-feedback residual keeps the wire's energy above the RHS at c = 0.3
# (ROADMAP: its gate is bistable); at c = 30 it uploads 30 of 48 times.
RULE_BY_KIND = {"topk": dict(topk_frac=0.54, c=30.0)}


def _rule_kw(kind):
    return dict(kind=kind, **{**RULE, **RULE_BY_KIND.get(kind, {})},
                **({"local_steps": H} if kind in LOCAL_RULES else {}))


def _problem():
    ds = ijcnn1_like(n=512)
    mtx = pad_to_matrix(uniform_partition(len(ds.y), M, seed=0))
    params = {"w": np.zeros((22, 2), np.float32),
              "b": np.zeros((2,), np.float32)}
    return ds.x, ds.y, mtx, params


def _batch(x, y, mtx, rng, kind):
    lead = (H, M) if kind in LOCAL_RULES else (M,)
    rows = np.arange(M).reshape((1,) * (len(lead) - 1) + (M, 1))
    ids = mtx[rows, rng.integers(0, mtx.shape[1], lead + (BATCH,))]
    return x[ids], y[ids]


def _engines(kind, fused_port=False):
    opt = kind not in LOCAL_RULES
    j_eng = JaxEngine(jax_logreg_loss, JaxFusedAMSGrad(lr=LR) if opt else None,
                      JaxRule(**_rule_kw(kind)), M, fused=False)
    t_eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=LR) if opt else None,
                       CommRule(**_rule_kw(kind)), M, fused=fused_port,
                       device="cpu")
    return j_eng, t_eng


@pytest.mark.parametrize("participation", [False, True],
                         ids=["full", "partial"])
@pytest.mark.parametrize("kind", KINDS)
def test_pytree_engine_in_lockstep(kind, participation):
    x, y, mtx, params = _problem()
    j_eng, t_eng = _engines(kind)
    j_step = jax.jit(j_eng.step)
    j_state = j_eng.init(jax.tree.map(jnp.asarray, params))
    rng = np.random.default_rng(0)
    tally = Tally()
    for k in range(ROUNDS):
        bx, by = _batch(x, y, mtx, rng, kind)
        mask = rng.random(M) < 0.7 if participation else None
        j_prev = jax.tree.map(np.asarray, j_state)
        t_state = convert.engine_state_from_numpy(j_prev, "cpu")
        assert t_state.step == k and t_state.params_flat is None
        j_state, jm = j_step(j_state, (jnp.asarray(bx), jnp.asarray(by)),
                             None if mask is None else jnp.asarray(mask))
        t_next, tm = t_eng.step(
            t_state, (torch.from_numpy(bx), torch.from_numpy(by)),
            None if mask is None else torch.from_numpy(mask))
        j = jax.tree.map(np.asarray, j_state)
        jm = jax.tree.map(np.asarray, jm)
        pk = Packer(j_prev.params)
        server = [("params", pk.one(j.params), pk.one(t_next.params))]
        opt_j, opt_t = j.opt_state, t_next.opt_state
        if hasattr(opt_j, "_fields"):
            assert opt_t._fields == opt_j._fields
            assert opt_t.count == int(opt_j.count) == k + 1
            server += [(f"opt.{f}", pk.one(getattr(opt_j, f)),
                        pk.one(getattr(opt_t, f)))
                       for f in opt_j._fields if f != "count"]
        else:
            assert int(opt_t) == int(opt_j)
        cols = compare_round(k, t_eng.rule, pk, j_prev.comm, j.comm,
                             t_next.comm, jm, tm, mask, tally, STATE_TOL,
                             server)
        if cols is False:
            continue
        assert t_next.step == k + 1 and t_next.params_flat is None
        # the RHS ring's newest entry is Σ Δθ², off by at most what the
        # columns of a wire difference move
        theta = pk.one(j_prev.params).astype(np.float64)
        d_ref = (pk.one(j.params) - theta)[cols]
        d_port = (pk.one(t_next.params) - theta)[cols]
        slack = float(np.abs(d_port ** 2 - d_ref ** 2).sum()) * 1.01
        a, b = j.comm.diff_hist, np32(t_next.comm.diff_hist)
        new = k % len(a)
        scale = max(np.abs(a).max(), 1e-30)
        assert abs(b[new] - a[new]) <= STATE_TOL * scale + slack, k
        others = np.arange(len(a)) != new
        assert np.array_equal(b[others], a[others])
    check_tally(kind, tally, f"engine {kind} "
                 f"{'partial' if participation else 'full'}")


@pytest.mark.parametrize("kind", KINDS)
def test_comm_round_in_lockstep(kind):
    """The shared round alone: each round, both sides' ``comm_round`` from
    the reference's round-k CommState and parameters (the reference's
    trajectory comes from its jitted engine)."""
    x, y, mtx, params = _problem()
    j_eng, t_eng = _engines(kind)
    j_step = jax.jit(j_eng.step)
    j_strategy = jcomm.strategy_for(JaxRule(**_rule_kw(kind)))
    j_round = jax.jit(lambda c, p, b, k: jcomm.comm_round(
        j_strategy, c, p, b, k, vgrad=j_eng._vgrad,
        vgrad_per=j_eng._vgrad_per))
    j_state = j_eng.init(jax.tree.map(jnp.asarray, params))
    rng = np.random.default_rng(1)
    tally = Tally()
    for k in range(ROUNDS):
        bx, by = _batch(x, y, mtx, rng, kind)
        j_prev = jax.tree.map(np.asarray, j_state)
        out_j = j_round(j_state.comm, j_state.params,
                        (jnp.asarray(bx), jnp.asarray(by)),
                        jnp.asarray(k, jnp.int32))
        t_comm = convert.comm_state_from_numpy(j_prev.comm, "cpu")
        assert isinstance(t_comm, tcomm.CommState)
        out_t = tcomm.comm_round(
            t_eng.strategy, t_comm, convert.params_from_numpy(
                j_prev.params, "cpu"),
            (torch.from_numpy(bx), torch.from_numpy(by)), k,
            vgrad=t_eng._vgrad, vgrad_per=t_eng._vgrad_per)
        j_state, _ = j_step(j_state, (jnp.asarray(bx), jnp.asarray(by)))
        jo = jax.tree.map(np.asarray, out_j)
        if compare_round(k, t_eng.rule, Packer(j_prev.params),
                         j_prev.comm, jo.comm, out_t.comm, jo.metrics,
                         out_t.metrics, None, tally, STATE_TOL) is False:
            continue
        assert np.array_equal(out_t.upload.numpy(), jo.upload)
        np.testing.assert_allclose(out_t.losses.numpy(), jo.losses,
                                   rtol=0, atol=STATE_TOL * max(
                                       np.abs(jo.losses).max(), 1e-30))
        # the round leaves the RHS ring to record_progress
        assert np.array_equal(np32(out_t.comm.diff_hist),
                              j_prev.comm.diff_hist)
    check_tally(kind, tally, f"comm_round {kind}")


@pytest.mark.parametrize("kind", KINDS)
def test_pytree_plane_matches_flat_plane(kind):
    """The port's two planes, free-running from one state on the same
    batches at the reference's settings for this pair (M = 3, batch 16,
    c = 5, d_max 4, max_delay 6, lr 0.05, 8 rounds): masks and staleness
    exact, θ within rtol 1e-4, atol 1e-6."""
    m, free = 3, dict(c=5.0, d_max=4, max_delay=6)
    ds = ijcnn1_like(n=400)
    mtx = pad_to_matrix(uniform_partition(ds.n, m, seed=0))
    rng = np.random.default_rng(2)
    lead = (H, m) if kind in LOCAL_RULES else (m,)
    rows = np.arange(m).reshape((1,) * (len(lead) - 1) + (m, 1))
    ids = mtx[rows, rng.integers(0, mtx.shape[1],
                                 (FREE_ROUNDS,) + lead + (16,))]
    batches = (torch.from_numpy(ds.x[ids]), torch.from_numpy(ds.y[ids]))
    params = convert.params_from_numpy(
        {"w": np.zeros((22, 2), np.float32),
         "b": np.zeros((2,), np.float32)}, "cpu")
    rule = CommRule(**{**_rule_kw(kind), **free})
    opt = None if kind in LOCAL_RULES else FusedAMSGrad(lr=0.05)
    engines = [CADAEngine(logreg_loss, opt, rule, m, fused=f, device="cpu")
               for f in (True, False)]
    (s_f, m_f), (s_r, m_r) = (e.run(e.init(params), batches)
                              for e in engines)
    assert s_f.params_flat is not None and s_r.params_flat is None
    assert isinstance(s_r.comm, tcomm.CommState)
    assert torch.equal(m_f["upload_mask"], m_r["upload_mask"])
    assert torch.equal(m_f["staleness"], m_r["staleness"])
    torch.testing.assert_close(m_f["bytes_up"], m_r["bytes_up"],
                               rtol=1e-6, atol=0)
    for key in params:
        torch.testing.assert_close(s_r.params[key], s_f.params[key],
                                   rtol=1e-4, atol=1e-6)
    total = int(m_f["uploads"].sum())
    print(f"\n{kind}: {total} uploads of {FREE_ROUNDS * m}")
    if kind not in ("always", *LOCAL_RULES):
        assert 0 < total < FREE_ROUNDS * m, "the gate never skipped"


def _odd_tree(rng):
    return {"a": rng.normal(size=(37, 5)).astype(np.float32),
            "b": rng.normal(size=(1031,)).astype(np.float32),
            "c": {"d": rng.normal(size=(3, 3, 3)).astype(np.float32),
                  "e": rng.normal(size=()).astype(np.float32)}}


def _close_ulp(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=ULP_SCALE * scale, err_msg=what)


def test_fused_cada_update_matches_reference():
    """Four steps on a tree of odd leaf sizes (37·5 + 1031 + 27 + 1 = 1244
    entries, padded to 2048), one leaf in bf16, each step from the
    reference's state."""
    rng = np.random.default_rng(3)
    params = _odd_tree(rng)
    params["b"] = np.asarray(jnp.asarray(params["b"], jnp.bfloat16))
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), params)
    h, vhat = zeros, zeros
    for step in range(4):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
            np.float32), _odd_tree(rng))
        j_out = jops.fused_cada_update(
            jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, h),
            jax.tree.map(jnp.asarray, vhat), jax.tree.map(jnp.asarray, grads),
            0.01)
        t_out = tops.fused_cada_update(
            *(convert.params_from_numpy(t, "cpu")
              for t in (params, h, vhat, grads)), 0.01)
        j_out = jax.tree.map(np.asarray, j_out)
        for i, name in enumerate(("params", "h", "vhat")):
            jl, tl = jax.tree.leaves(j_out[i]), ttrees.tree_leaves(t_out[i])
            assert len(jl) == len(tl) == 4
            for a, b in zip(jl, tl):
                assert tuple(b.shape) == a.shape, name
                assert str(b.dtype).split(".")[-1] == str(a.dtype), name
                _close_ulp(b, a, f"{name} at step {step}")
        np.testing.assert_allclose(float(t_out[3]), float(j_out[3]),
                                   rtol=1e-5)
        params, h, vhat = j_out[0], j_out[1], j_out[2]


def test_fused_amsgrad_init_apply_match_reference():
    rng = np.random.default_rng(4)
    params = _odd_tree(rng)
    ours, ref = FusedAMSGrad(lr=0.02), JaxFusedAMSGrad(lr=0.02)
    t_params = convert.params_from_numpy(params, "cpu")
    j_params = jax.tree.map(jnp.asarray, params)
    t_state, j_state = ours.init(t_params), ref.init(j_params)
    assert t_state.count == 0
    for a, b in zip(ttrees.tree_leaves(t_state.h),
                    ttrees.tree_leaves(t_state.vhat)):
        assert a.dtype == b.dtype == torch.float32
        assert a.data_ptr() != b.data_ptr() and not a.any()
    for step in range(3):
        grads = _odd_tree(rng)
        t_params, t_state, t_sq = ours.apply(
            t_params, t_state, convert.params_from_numpy(grads, "cpu"))
        j_params, j_state, j_sq = ref.apply(
            j_params, j_state, jax.tree.map(jnp.asarray, grads))
        for name, a, b in (("params", j_params, t_params),
                           ("h", j_state.h, t_state.h),
                           ("vhat", j_state.vhat, t_state.vhat)):
            for x, z in zip(jax.tree.leaves(a), ttrees.tree_leaves(b)):
                _close_ulp(z, x, f"{name} at step {step}")
        np.testing.assert_allclose(float(t_sq), float(j_sq), rtol=1e-5)
        assert t_state.count == int(j_state.count) == step + 1
        # the reference's state carried across, so the steps stay in step
        t_params = convert.params_from_numpy(
            jax.tree.map(np.asarray, j_params), "cpu")
        t_state = convert.opt_state_from_numpy(
            jax.tree.map(np.asarray, j_state), "cpu")


def test_tree_helpers_match_reference():
    rng = np.random.default_rng(5)
    a, b = _odd_tree(rng), _odd_tree(rng)
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a, b))
    ta, tb = (convert.params_from_numpy(t, "cpu") for t in (a, b))
    mask = np.asarray(True)

    def same(got, want, rtol=1e-6):
        wl, gl = jax.tree.leaves(want), ttrees.tree_leaves(got)
        assert len(wl) == len(gl)
        for w, g in zip(wl, gl):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_allclose(np32(g), np.asarray(w, np.float32),
                                       rtol=rtol, atol=0)

    same(ttrees.tree_add(ta, tb), jtrees.tree_add(ja, jb))
    same(ttrees.tree_sub(ta, tb), jtrees.tree_sub(ja, jb))
    same(ttrees.tree_scale(0.3, ta), jtrees.tree_scale(0.3, ja))
    same(ttrees.tree_axpy(-0.7, ta, tb), jtrees.tree_axpy(-0.7, ja, jb))
    same(ttrees.tree_zeros_like(ta), jtrees.tree_zeros_like(ja))
    same(ttrees.tree_zeros_like(ta, torch.bfloat16),
         jtrees.tree_zeros_like(ja, jnp.bfloat16))
    same(ttrees.tree_cast(ta, torch.bfloat16),
         jtrees.tree_cast(ja, jnp.bfloat16))
    same(ttrees.tree_where_mask(torch.as_tensor(mask), ta, tb),
         jtrees.tree_where_mask(jnp.asarray(mask), ja, jb))
    same(ttrees.tree_where_mask(torch.as_tensor(~mask), ta, tb),
         jtrees.tree_where_mask(jnp.asarray(~mask), ja, jb))
    np.testing.assert_allclose(float(ttrees.tree_dot(ta, tb)),
                               float(jtrees.tree_dot(ja, jb)), rtol=1e-5)
    np.testing.assert_allclose(float(ttrees.tree_sq_norm(ta)),
                               float(jtrees.tree_sq_norm(ja)), rtol=1e-5)
    assert ttrees.tree_size(ta) == int(jtrees.tree_size(ja)) == 1244
    assert ttrees.tree_bytes(ta) == int(jtrees.tree_bytes(ja)) == 4 * 1244
    half = ttrees.tree_cast(ta, torch.bfloat16)
    assert ttrees.tree_bytes(half) == int(jtrees.tree_bytes(
        jtrees.tree_cast(ja, jnp.bfloat16))) == 2 * 1244


# ---------------------------------------------- the trainer's pytree pair

PAIR_CFG = TC.get_smoke_config("stablelm-1.6b")
PAIR_M, PAIR_STEPS, PAIR_LR = 2, 6, 1e-3


def _pair_batches():
    rng = np.random.default_rng(100)
    return [TT.worker_split({"tokens": torch.from_numpy(
        rng.integers(0, PAIR_CFG.vocab, (4, 33))).long()}, PAIR_M)
        for _ in range(PAIR_STEPS)]


def test_trainer_pytree_pair_matches():
    """cada2 (c = 20, d_max 4, max_delay 10) on stablelm-1.6b's smoke
    config, M = 2, 6 steps: the pytree engine (protocol ``adam``, whose
    defaults are the paper's AMSGrad form, on the LM's training-route
    loss) and the pytree trainer (``_amsgrad_apply``) from one seed."""
    rule = CommRule(kind="cada2", c=20.0, d_max=4, max_delay=10)
    hp = TT.TrainHParams(rule=rule, lr=PAIR_LR, fused=False)
    state = TT.init_train_state(PAIR_CFG, hp, PAIR_M, 0, device="cpu")
    assert isinstance(state.comm, tcomm.CommState)
    assert isinstance(state.h, dict)
    step = TT.make_train_step(PAIR_CFG, hp, PAIR_M)
    cfg = PAIR_CFG.with_(remat=False)   # remat does not compose with vmap
    eng = CADAEngine(
        lambda p, b: lm_loss(cfg, p, {"tokens": b[0]}, train=True)[0],
        adam(lr=PAIR_LR), rule, PAIR_M, fused=False, device="cpu")
    e_state = eng.init(state.params)
    uploads = 0
    for batch in _pair_batches():
        state, tm = step(state, batch)
        e_state, em = eng.step(e_state, (batch["tokens"],))
        assert torch.equal(tm["upload_mask"], em["upload_mask"])
        assert torch.equal(tm["staleness"], em["staleness"])
        uploads += int(tm["uploads"])
    assert 0 < uploads < PAIR_M * PAIR_STEPS
    for a, b in zip(ttrees.tree_leaves(e_state.params),
                    ttrees.tree_leaves(state.params)):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)


def test_cohort_plane_refuses_the_pytree_plane():
    eng = CADAEngine(logreg_loss, FusedAMSGrad(lr=LR), CommRule(kind="cada2"),
                     M, fused=False, device="cpu")
    params = convert.params_from_numpy(_problem()[3], "cpu")
    with pytest.raises(ValueError, match="fused=True"):
        eng.init_cohort(params)
    hp = TT.TrainHParams(fused=False)
    with pytest.raises(ValueError, match="fused"):
        TT.init_cohort_train_state(PAIR_CFG, hp, 4, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        TT.make_cohort_train_step(PAIR_CFG, hp, 4)
