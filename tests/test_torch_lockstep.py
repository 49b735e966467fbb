"""The port's Algorithm-1 round against the JAX engine, in lockstep.

For each rule (always, lag, cada1, cada2, cinn, laq, topk, avp, and the
variants below), each model (logreg on ijcnn1_like, an MLP 784→16→10 on
mnist_like) and with and without a partial-participation mask, 30 rounds run
like this: the JAX engine's round-k state is loaded into the port
(``convert.engine_state_from_numpy``), both engines take the same numpy
batch, each takes one ``step``, and the results are compared. Reloading
every round keeps a near-threshold gate flip from snowballing into two
different trajectories. The variants: laq without error feedback, topk with
the sparse (values, indices) wire and an 8-bit value quantizer, avp with the
composed gate, cada2 with an 8-bit wire, lag on the paper's SGD(0.05)
server and cada2 on the protocol Adam server.

The JAX side runs as its own tests run it on the CPU: the jitted engine
step, whose kernels take their plain jnp route there.

Contract:
  * Upload masks, staleness, CADA2 slots and ring versions and avp periods
    match exactly, except for a worker whose JAX-side gate margin
    |LHS − RHS| is within MARGIN_BAND · RHS. Such a flip is counted, the
    round's float state is not compared (the two sides legitimately
    differ), and at most one round in a run may flip. Infinite gate values
    (always, avp) must sit at the same workers.
  * Float state (θ, the optimizer's moments, ∇, worker planes, RHS ring,
    the rules' extras, the finite LHS and the loss) matches to
    |Δ| ≤ STATE_TOL · max|ref| per array. The two frameworks round
    differently: XLA contracts the moment update into an FMA, evaluates
    exp/log/expm1 with its own approximations, and sums the 784-wide MLP
    products in another order. The largest gap this test measures (shown
    with ``pytest -s``) is 9.6e-5 of the array's scale: the LHS of cada2
    with an 8-bit wire on the MLP, a norm of a difference of close
    gradients (2.3e-5 without the wire, the CADA1 logreg LHS).
  * A compressed wire turns that rounding gap into whole steps at a few
    entries: where x/scale·L lies within it of a .5 boundary, the two
    sides' b-bit quantizers round to neighbouring levels, and where two
    magnitudes at the k-th place of a top-k segment lie within it, the two
    sides keep different entries. Such WIRE DIFFERENCES show as entries of
    the uploaded worker plane beyond STATE_TOL. Each must be either one
    quantization level, |Δ| ≤ scale/L of its (worker, segment) with scale
    the segment's largest |wire| (rules with a b-bit wire), or a top-k
    support swap: one side sent 0, and the other's value lies within
    STATE_TOL · scale (plus one level under a quantized wire) of the
    reference's k-th largest |wire| in that segment (topk). They are counted
    (at most MAX_WIRE_DIFF_SHARE of the entries uploaded in the run), the
    columns they touch are left out of the comparison of the server-side
    arrays (∇, θ, the moments) and the residual, and the newest RHS-ring
    entry may differ by what the port's and the reference's Δθ² differ by
    in those columns. The error-feedback residual is what the wire cut off
    the corrected innovation, about one level at most, so its gap is held
    against the scale of that innovation (the round's largest |wire|), not
    against its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import CADAEngine as JaxEngine
from repro.core.rules import CommRule as JaxRule
from repro.models.small import logreg_loss as jax_logreg_loss
from repro.models.small import mlp_loss as jax_mlp_loss
from repro.optim.adam import adam as jax_adam
from repro.optim.fused import FusedAMSGrad as JaxFusedAMSGrad
from repro.optim.sgd import sgd as jax_sgd
from repro_torch import convert
from repro_torch.core.engine import CADAEngine
from repro_torch.core.quantize import topk_count
from repro_torch.core.rules import CommRule
from repro_torch.data import (ijcnn1_like, mnist_like, pad_to_matrix,
                              uniform_partition)
from repro_torch.models.small import logreg_loss, mlp_loss
from repro_torch.optim.adam import adam
from repro_torch.optim.fused import FusedAMSGrad
from repro_torch.optim.sgd import sgd

torch.set_num_threads(1)

M, BATCH, ROUNDS = 4, 8, 30
MARGIN_BAND = 1e-3
STATE_TOL = 1e-4
# wire differences allowed, as a share of the entries uploaded in a run: the
# measured share is below 1e-5 (shown with `pytest -s`); a quantizer or a
# top-k selection that were wrong would differ at most entries
MAX_WIRE_DIFF_SHARE = 1e-3
INT_EXTRAS = ("slot", "ring_version", "period")

# name: (rule fields, server optimizer, c per model or None for the model's)
VARIANTS = {
    "laq-no-ef": (dict(kind="laq", error_feedback=False), None, None),
    "topk-sparse-q8": (dict(kind="topk", sparse_wire=True, quantize_bits=8),
                       None, None),
    "avp-compose": (dict(kind="avp", avp_compose=True), None, None),
    "cada2-q8": (dict(kind="cada2", quantize_bits=8), None, None),
    # SGD's steps are lr·∇, far shorter than Adam's normalized ones, so the
    # RHS is ~10³ times smaller: c is raised to the median LHS/RHS ratio
    # measured at c=1 (about 300 and 2700), so the gate uploads and skips
    "lag-sgd": (dict(kind="lag"), "sgd", {"logreg": 300.0, "mlp": 2700.0}),
    "cada2-adam": (dict(kind="cada2"), "adam", None),
}


def _problem(model, rng):
    if model == "logreg":
        ds = ijcnn1_like(n=512)
        params = {"w": np.zeros((22, 2), np.float32),
                  "b": np.zeros((2,), np.float32)}
        # c chosen so every gated rule both uploads and skips
        return ds.x, ds.y, params, jax_logreg_loss, logreg_loss, 0.3, 0.05
    ds = mnist_like(n=512)
    params = {
        "w1": (rng.normal(size=(784, 16)) / 28.0).astype(np.float32),
        "b1": np.zeros(16, np.float32),
        "w2": (rng.normal(size=(16, 10)) / 4.0).astype(np.float32),
        "b2": np.zeros(10, np.float32),
    }
    # a smaller step keeps the MLP's logits moderate: at lr=0.05 they grow
    # until the softmax gradient loses digits to cancellation in both
    # frameworks alike
    return (ds.x.reshape(ds.n, -1), ds.y, params, jax_mlp_loss, mlp_loss,
            10.0, 0.01)


def _optimizers(opt, lr):
    """(reference's, port's) server optimizer: the fused AMSGrad step at
    ``lr``, the paper's SGD(0.05) for its LAG baseline, or protocol Adam."""
    if opt == "sgd":
        return jax_sgd(0.05), sgd(0.05)
    if opt == "adam":
        return jax_adam(lr), adam(lr)
    return JaxFusedAMSGrad(lr=lr), FusedAMSGrad(lr=lr)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _count(opt_state):
    """The step count of an optimizer state (SGD's state is the count)."""
    return (opt_state.count if hasattr(opt_state, "_fields")
            else int(opt_state))


def _opt_arrays(opt_state, layout):
    """name -> flat float array of every optimizer-state field but the
    count (dict fields packed in the layout's order)."""
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


def _wire_kind(rule):
    """(quantizer levels or 0, top-k fraction or None) of a rule's wire."""
    bits = rule.quantize_bits or (8 if rule.kind in ("cinn", "laq") else 0)
    levels = float(2 ** (bits - 1) - 1) if bits else 0.0
    frac = rule.topk_frac if rule.kind == "topk" else None
    return levels, frac


def _wire_differences(rule, layout, wg_prev, wg_ref, wg_port):
    """(M, n_flat) bool mask of the wire differences (see the module
    docstring), each checked; returns (mask, largest swap gap / scale).

    An entry is a candidate where it differs beyond STATE_TOL, where it
    differs by more than half a quantization level (a flip below STATE_TOL
    still moves the residual), or where one side sent it and the other
    did not (top-k)."""
    diff = np.abs(wg_port - wg_ref)
    tol = STATE_TOL * max(np.abs(wg_ref).max(), 1e-30)
    levels, frac = _wire_kind(rule)
    w_ref, w_port = wg_ref - wg_prev, wg_port - wg_prev
    level = np.zeros_like(w_ref)
    if levels:
        for o, s in zip(layout.offsets, layout.sizes):
            level[:, o:o + s] = np.abs(w_ref[:, o:o + s]).max(
                axis=1, keepdims=True) / levels
    flagged = diff > tol
    if levels:
        flagged |= diff > level / 2
    if frac is not None:
        flagged |= (w_ref == 0.0) != (w_port == 0.0)
    if not flagged.any():
        return flagged, 0.0
    assert levels or frac is not None, (
        f"{int(flagged.sum())} worker-plane entries beyond STATE_TOL on a "
        "raw wire")
    worst_swap = 0.0
    for w, j in zip(*np.nonzero(flagged)):
        if levels and diff[w, j] <= level[w, j] * (1 + 1e-3) + tol:
            continue
        seg = np.searchsorted(np.asarray(layout.offsets), j, side="right") - 1
        o, s = layout.offsets[seg], layout.sizes[seg]
        row = np.abs(w_ref[w, o:o + s])
        scale = row.max()
        assert frac is not None, (
            f"worker {w} entry {j}: |Δ| {diff[w, j]:.3g} is more than one "
            f"level {level[w, j]:.3g}")
        kth = np.sort(row)[::-1][topk_count(s, frac) - 1]
        sent = (w_port[w, j] if w_ref[w, j] == 0.0 else w_ref[w, j])
        assert w_ref[w, j] == 0.0 or w_port[w, j] == 0.0, (
            f"worker {w} entry {j}: both sides sent it, {w_ref[w, j]:.6g} "
            f"vs {w_port[w, j]:.6g}")
        gap = abs(abs(sent) - kth)
        assert gap <= STATE_TOL * scale + level[w, j] * (1 + 1e-3), (
            f"worker {w} entry {j}: a support swap {abs(sent):.6g} away "
            f"from the k-th magnitude {kth:.6g}")
        worst_swap = max(worst_swap, gap / scale)
    return flagged, worst_swap


def _run_lockstep(hp, opt, model, participation, c_by_model=None):
    rng = np.random.default_rng(0)
    x, y, params, jax_loss, loss, c, lr = _problem(model, rng)
    if c_by_model is not None:
        c = c_by_model[model]
    mtx = pad_to_matrix(uniform_partition(len(y), M, seed=0))
    hp = dict(c=c, d_max=3, max_delay=5, **hp)
    j_opt, t_opt = _optimizers(opt, lr)
    j_eng = JaxEngine(jax_loss, j_opt, JaxRule(**hp), M)
    t_eng = CADAEngine(loss, t_opt, CommRule(**hp), M, device="cpu")
    j_step = jax.jit(j_eng.step)
    j_state = j_eng.init(jax.tree.map(jnp.asarray, params))
    layout = None

    flip_rounds, uploads, skips, worst = 0, 0, 0, (0.0, "")
    wire_diffs, uploaded_entries, worst_swap = 0, 0, 0.0
    for k in range(ROUNDS):
        ids = mtx[np.arange(M)[:, None],
                  rng.integers(0, mtx.shape[1], (M, BATCH))]
        bx, by = x[ids], y[ids]
        mask = rng.random(M) < 0.7 if participation else None

        j_prev = jax.tree.map(np.asarray, j_state)
        t_state = convert.engine_state_from_numpy(j_prev, "cpu")
        assert t_state.step == k
        j_next, jm = j_step(j_state, (jnp.asarray(bx), jnp.asarray(by)),
                            None if mask is None else jnp.asarray(mask))
        t_next, tm = t_eng.step(
            t_state, (torch.from_numpy(bx), torch.from_numpy(by)),
            None if mask is None else torch.from_numpy(mask))
        layout = t_eng._layout
        j = jax.tree.map(np.asarray, j_next)
        jm = jax.tree.map(np.asarray, jm)
        j_state = j_next

        j_up, t_up = jm["upload_mask"], tm["upload_mask"].numpy()
        uploads += int(j_up.sum())
        skips += int((~j_up & (True if mask is None else mask)).sum())
        if not np.array_equal(j_up, t_up):
            margin = np.abs(jm["lhs"] - jm["rhs"])
            flipped = j_up != t_up
            assert (margin[flipped] <= MARGIN_BAND * jm["rhs"]).all(), (
                f"round {k}: upload masks differ outside the margin band: "
                f"jax {j_up}, port {t_up}, lhs {jm['lhs']}, rhs {jm['rhs']}")
            flip_rounds += 1
            continue

        assert t_next.step == k + 1
        assert _count(t_next.opt_state) == int(_count(j.opt_state))
        assert np.array_equal(t_next.comm.staleness.numpy(), j.comm.staleness)
        assert t_next.comm.staleness.dtype == torch.int32
        for key in INT_EXTRAS:
            if key in j.comm.extras:
                assert t_next.comm.extras[key].dtype == torch.int32, key
                assert np.array_equal(t_next.comm.extras[key].numpy(),
                                      j.comm.extras[key]), key
        assert int(tm["uploads"]) == int(jm["uploads"])
        assert int(tm["grad_evals"]) == int(jm["grad_evals"])
        np.testing.assert_allclose(float(tm["bytes_up"]),
                                   float(jm["bytes_up"]), rtol=1e-6)
        jl, tl = np.asarray(jm["lhs"]), tm["lhs"].numpy()
        assert np.array_equal(np.isfinite(jl), np.isfinite(tl))
        assert np.array_equal(jl[~np.isfinite(jl)], tl[~np.isfinite(tl)])

        # wire differences, and the columns they touch
        wg_prev = np.asarray(j_prev.comm.worker_grads, np.float32)
        flagged, swap = _wire_differences(
            t_eng.rule, layout, wg_prev,
            np.asarray(j.comm.worker_grads, np.float32),
            _np(t_next.comm.worker_grads))
        cols = flagged.any(axis=0)
        wire_scale = float(np.abs(np.asarray(j.comm.worker_grads,
                                             np.float32) - wg_prev).max())
        wire_diffs += int(flagged.sum())
        uploaded_entries += int(j_up.sum()) * layout.n
        worst_swap = max(worst_swap, swap)

        pairs = [("params_flat", j.params_flat, t_next.params_flat, "col"),
                 ("nabla", j.comm.nabla, t_next.comm.nabla, "col"),
                 ("worker_grads", j.comm.worker_grads,
                  t_next.comm.worker_grads, "entry"),
                 ("loss", jm["loss"], tm["loss"], None),
                 ("rhs", jm["rhs"], tm["rhs"], None),
                 ("lhs", jl[np.isfinite(jl)], tl[np.isfinite(tl)], None)]
        j_opt_arrays = _opt_arrays(j.opt_state, layout)
        t_opt_arrays = _opt_arrays(t_next.opt_state, layout)
        assert sorted(j_opt_arrays) == sorted(t_opt_arrays)
        pairs += [(f"opt.{n}", j_opt_arrays[n], t_opt_arrays[n], "col")
                  for n in j_opt_arrays]
        ex_t = t_next.comm.extras
        for name, v in dict(j.comm.extras).items():
            if name in INT_EXTRAS:
                continue
            if isinstance(v, dict):
                pairs += [(f"{name}.{kk}", vv, ex_t[name][kk], None)
                          for kk, vv in v.items()]
            else:
                pairs.append((name, v, ex_t[name],
                              "entry" if name == "residual" else None))
        for name, a, b, where in pairs:
            a, b = _np(a), _np(b)
            assert a.shape == b.shape, name
            keep = (np.ones(a.shape, bool) if where is None
                    else ~np.broadcast_to(cols, a.shape))
            if not keep.any():
                continue
            scale = max(np.abs(a).max(),
                        wire_scale if name == "residual" else 0.0, 1e-30)
            np.testing.assert_allclose(b[keep], a[keep], rtol=0,
                                       atol=STATE_TOL * scale,
                                       err_msg=f"{name} at round {k}")
            worst = max(worst, (float(np.abs(b - a)[keep].max() / scale),
                                name))

        # the RHS ring's newest entry: Σ Δθ², off by at most the touched
        # columns' Δθ² gap
        theta = np.asarray(j_prev.params_flat, np.float32)
        d_ref = (np.asarray(j.params_flat, np.float64) - theta)[cols]
        d_port = (_np(t_next.params_flat).astype(np.float64) - theta)[cols]
        slack = float(np.abs(d_port ** 2 - d_ref ** 2).sum()) * 1.01
        new = k % len(j.comm.diff_hist)
        a, b = j.comm.diff_hist, _np(t_next.comm.diff_hist)
        scale = max(np.abs(a).max(), 1e-30)
        assert abs(b[new] - a[new]) <= STATE_TOL * scale + slack, (
            f"diff_hist at round {k}: {b[new]} vs {a[new]}")
        others = np.arange(len(a)) != new
        np.testing.assert_allclose(b[others], a[others], rtol=0,
                                   atol=STATE_TOL * scale)

    # the measured gaps, shown with `pytest -s`
    label = ",".join(f"{k}={v}" for k, v in hp.items()
                     if k not in ("c", "d_max", "max_delay"))
    print(f"\n{label}{'/' + opt if opt else ''}/{model}/"
          f"{'partial' if participation else 'full'}"
          f": largest gap {worst[0]:.3g} of scale ({worst[1]}), "
          f"{flip_rounds} in-band flip rounds, {uploads} uploads, "
          f"{wire_diffs} wire differences in {uploaded_entries} uploaded "
          f"entries, largest support-swap gap {worst_swap:.3g} of scale")
    assert flip_rounds <= 1
    assert uploads > 0
    assert wire_diffs <= MAX_WIRE_DIFF_SHARE * uploaded_entries
    if hp["kind"] != "always":
        assert skips > 0, "the gate never skipped: the test is vacuous"


@pytest.mark.parametrize("participation", [False, True],
                         ids=["full", "partial"])
@pytest.mark.parametrize("model", ["logreg", "mlp"])
@pytest.mark.parametrize("kind", ["always", "lag", "cada1", "cada2", "cinn",
                                  "laq", "topk", "avp"])
def test_lockstep_round(kind, model, participation):
    _run_lockstep(dict(kind=kind), None, model, participation)


@pytest.mark.parametrize("participation", [False, True],
                         ids=["full", "partial"])
@pytest.mark.parametrize("model", ["logreg", "mlp"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lockstep_variant(variant, model, participation):
    hp, opt, c_by_model = VARIANTS[variant]
    _run_lockstep(hp, opt, model, participation, c_by_model)


def test_gathered_and_stacked_second_evals_agree():
    """cada2's second evaluation in its gathered (``fuse_evals=False``) and
    stacked (default) forms gives the same round, within STATE_TOL."""
    rng = np.random.default_rng(1)
    x, y, params, _, loss, c, lr = _problem("mlp", rng)
    mtx = pad_to_matrix(uniform_partition(len(y), M, seed=0))
    hp = dict(kind="cada2", c=c, d_max=3, max_delay=5)
    engines = [CADAEngine(loss, FusedAMSGrad(lr=lr), CommRule(**hp), M,
                          fuse_evals=f, device="cpu") for f in (True, False)]
    state = engines[0].init(convert.params_from_numpy(params, "cpu"))
    for _ in range(12):
        ids = mtx[np.arange(M)[:, None],
                  rng.integers(0, mtx.shape[1], (M, BATCH))]
        batch = (torch.from_numpy(x[ids]), torch.from_numpy(y[ids]))
        (s_a, m_a), (s_b, m_b) = (e.step(state, batch) for e in engines)
        assert torch.equal(m_a["upload_mask"], m_b["upload_mask"])
        for a, b in ((s_a.params_flat, s_b.params_flat),
                     (s_a.comm.worker_grads, s_b.comm.worker_grads),
                     (m_a["lhs"], m_b["lhs"])):
            torch.testing.assert_close(
                a, b, rtol=0, atol=STATE_TOL * float(b.abs().max()))
        state = s_a
