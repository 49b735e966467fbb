"""The port's LM trainer against the JAX package's, in lockstep.

stablelm-1.6b's smoke config (fp32), M = 2 workers, 8 steps of a (4, 33)
token batch, the reference parity test's rule settings (c = 20,
d_max = 4, max_delay = 10, lr = 1e-3; ``tests/test_parity_engine_trainer.py``),
for every kind in ``RULES``, and cada2 twice more: with bf16 moments and
bf16 CADA state (``moments_dtype``, ``cada_dtype``), with two
microbatches per worker, and with the grouped second evaluation
(``group_evals``: one evaluation per occupied ring row); and the delta-payload rules ``local_momentum`` and
``fedadam`` at H = 2 local steps (the batch split (H, M, 1, 33); the mean
delta feeds the trainer's AMSGrad server step on both sides); and cada2
on granite-moe-1b-a400m's smoke config (the loss carries the routers' aux
loss) and on qwen2-vl-2b's, whose batches are {"embeds", "labels",
"positions"} (M-RoPE positions of a text prefix and a 4 x 4 image). Each step, the reference's step-k state is loaded
into the port (``convert.train_state_from_numpy``), both trainers take the
same numpy batch, each takes one step, and the results are compared.
Reloading every step keeps a near-threshold gate flip from snowballing.

The JAX side runs as its own tests run it on the CPU: the jitted
``make_train_step``, whose kernels take their plain jnp route there.

Contract:
  * Upload masks, staleness, CADA2 slots and ring versions and avp periods
    match exactly, except for a worker whose reference-side gate margin
    |LHS − RHS| is within MARGIN_BAND · RHS (then the step's float state
    is not compared; at most one such step per run). Upload counts and
    gradient evaluations match exactly.
  * Float state (θ, h, v̂, ∇, the worker planes, the rules' float extras,
    the finite LHS, the loss and ‖Δθ‖²) matches to
    |Δ| ≤ STATE_TOL · max|ref| per array; θ as its update from the step-k
    θ both sides start from, which may also differ by the spacing of fp32
    numbers at θ' (θ + upd rounds). The RHS ring carries its older
    entries over and takes ‖Δθ‖² as its newest. The measured gaps (shown
    with ``pytest -s``) are below 1e-6 of scale for the stored arrays: the
    gradients' rounding (the LM loss's own band,
    ``test_torch_train_loss.py``) and XLA's FMA in the moment update; θ's
    update, AMSGrad's normalized step, which divides small gradient
    entries by roots near √ε, takes them to 5.3e-6 of its scale. The
    delta rules' two local steps compound the gradients' gap: up to 4.3e-6
    of scale (FedAdam's h).
  * With bf16 moments and CADA state, every array may also differ by
    BF16_BAND = 2⁻⁷ of its scale, one bf16 rounding step at its largest
    entry: an innovation entry, its worker mean, ∇ and the moments each
    round to bf16, so a gap below the fp32 band becomes a whole bf16 step
    at some entries, and a mean of two rounded values that cancel keeps
    that step at a small entry. θ's normalized update inherits them
    (measured: 4.0e-3 of its scale; the stored arrays ≤ 4.7e-4).
  * A b-bit or top-k wire turns the gradients' rounding gap into whole
    levels or support swaps at a few entries; they are checked and
    counted as in ``test_torch_lockstep.py`` (``lockstep_wire.py``), and
    the columns they touch are left out of the server-side arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.core.rules import CommRule as JaxRule
from repro.distributed import trainer as JT
from repro.models import frontends as jfront
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.core import flat as F
from repro_torch.core.rules import LOCAL_RULES, RULES, CommRule
from repro_torch.distributed import trainer as TT
from repro_torch.utils.trees import tree_leaves
from lockstep_wire import wire_differences

torch.set_num_threads(1)

ARCH = "stablelm-1.6b"
M, STEPS, BATCH, SEQ1, LR = 2, 8, 4, 33, 1e-3
RULE = dict(c=20.0, d_max=4, max_delay=10)
MARGIN_BAND = 1e-3
STATE_TOL = 1e-5
BF16_BAND = 2.0 ** -7        # one bf16 rounding step at the scale
MAX_WIRE_DIFF_SHARE = 1e-3
INT_EXTRAS = ("slot", "ring_version", "period")

CASES = {**{kind: (dict(kind=kind), {}) for kind in RULES},
         "cada2-bf16-state": (dict(kind="cada2"),
                              dict(moments_dtype="bfloat16",
                                   cada_dtype="bfloat16")),
         "cada2-microbatches2": (dict(kind="cada2"), dict(microbatches=2)),
         "cada2-group-evals": (dict(kind="cada2"), dict(group_evals=True)),
         **{f"{kind}-h2": (dict(kind=kind, local_steps=2), {})
            for kind in LOCAL_RULES},
         **{f"cada2-{arch}": (dict(kind="cada2"), {}, arch)
            for arch in ("granite-moe-1b-a400m", "qwen2-vl-2b")}}


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _packed(layout, params):
    """A parameter tree (numpy or tensors) packed in the port's layout."""
    if not torch.is_tensor(tree_leaves(params)[0]):
        params = convert.params_from_numpy(params, "cpu")
    return _np(layout.pack(params))


def _float_pairs(j, t):
    """(name, reference, port, where) of the float state after a step but
    θ; ``where`` says what a wire difference leaves out of the comparison:
    its column ("col", the server-side arrays), its entry ("entry", the
    worker planes) or nothing (None)."""
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
        if isinstance(v, dict):   # a parameter tree (ring, snapshot)
            pairs += [(f"{name}[{i}]", a, b, None) for i, (a, b) in
                      enumerate(zip(jax.tree.leaves(v), tree_leaves(port)))]
        else:
            pairs.append((name, v, port, "entry"))
    return pairs


def _model_batch(jcfg, rng):
    """One global numpy batch of the model's kind: tokens (BATCH, SEQ1),
    or for an embedding-input model {"embeds", "labels"} of SEQ1 - 1
    positions, with the M-RoPE positions of a text prefix and a 4 x 4
    image."""
    if jcfg.embed_input:
        return {"tokens": rng.integers(0, jcfg.vocab, (BATCH, SEQ1)).astype(
            np.int32)}
    s = SEQ1 - 1
    out = {"embeds": rng.normal(size=(BATCH, s, jcfg.d_model)).astype(
               np.float32),
           "labels": rng.integers(0, jcfg.vocab, (BATCH, s)).astype(
               np.int32)}
    if jcfg.mrope:
        out["positions"] = np.array(jfront.mrope_positions(BATCH, s, (4, 4)))
    return out


def _torch_batch(batch):
    return {n: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for n, v in batch.items()}


def _run(case):
    rule_kw, hp_kw, arch = (*CASES[case], ARCH)[:3]
    jcfg, tcfg = JC.get_smoke_config(arch), TC.get_smoke_config(arch)
    jhp = JT.TrainHParams(rule=JaxRule(**rule_kw, **RULE), lr=LR, **hp_kw)
    thp = TT.TrainHParams(rule=CommRule(**rule_kw, **RULE), lr=LR, **hp_kw)
    j_step = jax.jit(JT.make_train_step(jcfg, jhp, M))
    t_step = TT.make_train_step(tcfg, thp, M)
    j_state = JT.init_train_state(jcfg, jhp, M, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    bf16 = thp.moments_dtype == "bfloat16"
    h = thp.rule.local_steps

    flips = uploads = skips = wire_diffs = uploaded_entries = 0
    worst = (0.0, "")
    for k in range(STEPS):
        batch = _model_batch(jcfg, rng)
        j_prev = jax.tree.map(np.asarray, j_state)
        t_state = convert.train_state_from_numpy(j_prev, "cpu")
        assert t_state.step == k
        j_state, jm = j_step(j_state, JT.worker_split(
            {n: jnp.asarray(v) for n, v in batch.items()}, M,
            local_steps=h))
        t_next, tm = t_step(t_state, TT.worker_split(
            _torch_batch(batch), M, local_steps=h))
        layout = F.layout_of(t_state.params)
        j = jax.tree.map(np.asarray, j_state)
        jm = jax.tree.map(np.asarray, jm)

        j_up, t_up = jm["upload_mask"], tm["upload_mask"].numpy()
        uploads += int(j_up.sum())
        skips += int((~j_up).sum())
        if not np.array_equal(j_up, t_up):
            margin = np.abs(jm["lhs"] - jm["rhs"])
            flipped = j_up != t_up
            assert (margin[flipped] <= MARGIN_BAND * jm["rhs"]).all(), (
                f"step {k}: upload masks differ outside the margin band: "
                f"jax {j_up}, port {t_up}, lhs {jm['lhs']}, rhs {jm['rhs']}")
            flips += 1
            continue

        assert t_next.step == k + 1
        assert np.array_equal(tm["staleness"].numpy(), jm["staleness"])
        assert int(tm["uploads"]) == int(jm["uploads"])
        flagged = np.zeros((M, layout.n_flat), bool)
        wire_scale = 0.0
        if j.comm is not None:
            assert t_next.comm.staleness.dtype == torch.int32
            assert np.array_equal(t_next.comm.staleness.numpy(),
                                  j.comm.staleness)
            for key in INT_EXTRAS:
                if key in j.comm.extras:
                    assert np.array_equal(t_next.comm.extras[key].numpy(),
                                          j.comm.extras[key]), key
            assert int(tm["grad_evals"]) == int(jm["grad_evals"])
            jl, tl = np.asarray(jm["lhs"]), tm["lhs"].numpy()
            assert np.array_equal(np.isfinite(jl), np.isfinite(tl))
            assert np.array_equal(jl[~np.isfinite(jl)], tl[~np.isfinite(tl)])
            if np.isfinite(jl).any():
                scale = np.abs(jl[np.isfinite(jl)]).max()
                assert np.abs(tl - jl)[np.isfinite(jl)].max() <= (
                    STATE_TOL * scale), (k, tl, jl)
            wg_prev = _np(j_prev.comm.worker_grads)
            wg_ref = _np(j.comm.worker_grads)
            if not bf16:   # a bf16 plane's flips are held below
                flagged, _ = wire_differences(
                    thp.rule, layout, STATE_TOL, wg_prev, wg_ref,
                    _np(t_next.comm.worker_grads))
            wire_diffs += int(flagged.sum())
            wire_scale = float(np.abs(wg_ref - wg_prev).max())
            uploaded_entries += int(j_up.sum()) * layout.n

        cols = flagged.any(axis=0)
        # θ as its update from the step-k θ both sides start from; θ + upd
        # rounds to fp32, so the updates may also differ by the spacing of
        # fp32 numbers at θ'
        theta = _packed(layout, j_prev.params)
        d_ref = _packed(layout, j.params) - theta
        d_port = _packed(layout, t_next.params) - theta
        spacing = np.spacing(np.abs(theta + d_ref))
        pairs = [("params update", d_ref, d_port, "col")] + _float_pairs(
            j, t_next) + [("loss", jm["loss"], tm["loss"], None)]
        band = STATE_TOL + (BF16_BAND if bf16 else 0.0)
        for name, a, b, where in pairs:
            a, b = _np(a), _np(b)
            assert a.shape == b.shape, name
            keep = {None: np.ones(a.shape, bool), "col": ~cols,
                    "entry": ~flagged}[where]
            scale = max(np.abs(a).max(),
                        wire_scale if name == "residual" else 0.0, 1e-30)
            gap = np.abs(b - a) - (spacing if name == "params update"
                                   else 0.0)
            bad = ~(gap <= band * scale) & keep
            assert not bad.any(), (
                f"{case} {name} at step {k}: {int(bad.sum())} entries "
                f"outside the band, e.g. ref {a[bad][:3]} port {b[bad][:3]}")
            worst = max(worst, (float(gap[keep].max() / scale), name))
        # Σ Δθ², off by at most what the columns of a wire difference move
        d_ref, d_port = d_ref.astype(np.float64), d_port.astype(np.float64)
        slack = float(np.abs(d_port ** 2 - d_ref ** 2)[cols].sum()) * 1.01
        dsq_ref = float(jm["dtheta_sq"])
        assert abs(float(tm["dtheta_sq"]) - dsq_ref) <= (
            band * dsq_ref + slack), (k, float(tm["dtheta_sq"]), dsq_ref)
        if j.comm is not None:
            # the RHS ring: the older entries carried over, the newest the
            # step's Σ Δθ² (held above)
            hist = _np(t_next.comm.diff_hist)
            new = k % len(hist)
            assert hist[new] == float(tm["dtheta_sq"])
            others = np.arange(len(hist)) != new
            assert np.array_equal(hist[others],
                                  _np(j.comm.diff_hist)[others])

    # the measured gaps, shown with `pytest -s`
    print(f"\n{case}: largest gap {worst[0]:.3g} of scale ({worst[1]}), "
          f"{flips} in-band flip steps, {uploads} uploads, {skips} skips, "
          f"{wire_diffs} wire differences in {uploaded_entries} uploaded "
          "entries")
    return flips, uploads, skips, wire_diffs, uploaded_entries


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_lockstep_step(case):
    flips, uploads, skips, wire_diffs, entries = _run(case)
    assert flips <= 1
    assert uploads > 0
    assert wire_diffs <= MAX_WIRE_DIFF_SHARE * entries
    if CASES[case][0]["kind"] not in ("always", "topk", *LOCAL_RULES):
        assert skips > 0, "the gate never skipped: the test is vacuous"

