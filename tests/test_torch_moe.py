"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py``.

The property tests mirror ``tests/test_moe_ssm.py`` (shape and
finiteness, the aux loss against a collapsed router, the capacity's
bounds, the capacity drop, per-row dispatch = global dispatch where the
capacity does not bind) on the port's own parameters. The value tests
convert the reference's own parameters (``repro_torch.convert``) and give
both sides the same numpy activations (fp32).

Tolerances:
  * ``_capacity``: exact, over the hypothesis sweep of the reference's
    test.
  * Routing: each token's top-k experts and each expert's set of tokens
    with a non-zero gate are exact, except where the reference's own
    numbers put the choice inside ROUTE_BAND: a token's k-th and
    (k+1)-th probabilities within ROUTE_BAND of the k-th, or its gate
    within ROUTE_BAND of that expert's top-C cutoff. Softmax and the fp32
    router product round differently in XLA and PyTorch eager (the same
    near-threshold flip that ``tests/test_torch_lockstep.py`` bands); the
    rows of a flipped token are then left out of the value comparison.
    (Tokens with a zero gate may fill an expert's spare capacity in any
    order: they add 0 · y.)
  * ``moe_ffn``'s output within RTOL of its scale, the aux loss within
    rtol RTOL; the gradients of a fixed linear read-out plus the aux loss,
    with respect to every parameter and the input, within GRAD_TOL of each
    leaf's scale (the band ``tests/test_torch_train_loss.py`` uses).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as JC
from repro.models import model as JM
from repro.models import moe as jmoe
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

RTOL = 1e-5
GRAD_TOL = 1e-5
ROUTE_BAND = 1e-5


def _cfgs(e=4, k=2, d=32, ff=64, **kw):
    change = dict(n_experts=e, top_k=k, d_model=d, d_ff=ff, **kw)
    return (JC.get_smoke_config("granite-moe-1b-a400m").with_(**change),
            TC.get_smoke_config("granite-moe-1b-a400m").with_(**change))


def _port_setup(e=4, k=2, d=32, ff=64, b=2, s=16, seed=0):
    _, cfg = _cfgs(e, k, d, ff)
    lp = TM.layer(TM.init_params(cfg, seed, "cpu")["blocks"], 0)["mlp"]
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(b, s, d)).astype(np.float32))
    return cfg, lp, x


def _pair_setup(arch="granite-moe-1b-a400m", b=2, s=24, act=None, seed=0,
                **change):
    """Both configs, layer 0's MLP parameters of the reference (numpy) and
    the port (converted), and one (B, S, d) fp32 input."""
    jcfg = JC.get_smoke_config(arch).with_(**change)
    tcfg = TC.get_smoke_config(arch).with_(**change)
    if act is not None:
        jcfg, tcfg = jcfg.with_(mlp_act=act), tcfg.with_(mlp_act=act)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    jlp = jax.tree.map(lambda p: np.asarray(p[0]), jp["blocks"]["mlp"])
    tlp = convert.params_from_numpy(jlp, "cpu")
    x = np.random.default_rng(seed + 5).normal(
        size=(b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jlp, tlp, x


# ------------------------------------------------- the reference's tests

def test_moe_output_finite_and_shaped():
    cfg, lp, x = _port_setup()
    y, aux = tmoe.moe_ffn(lp, cfg, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux) >= 0.0


def test_moe_aux_loss_penalizes_imbalance():
    """Uniform routing probabilities give aux == coeff (Switch lemma); a
    collapsed router gives ~E× more."""
    cfg, lp, x = _port_setup(e=4, k=1)
    x = x.abs()   # positive activations: the +100 column always wins
    lp_u = dict(lp, router=torch.zeros_like(lp["router"]))
    _, aux_u = tmoe.moe_ffn(lp_u, cfg, x)
    collapsed = torch.zeros_like(lp["router"])
    collapsed[:, 0] += 100.0
    _, aux_c = tmoe.moe_ffn(dict(lp, router=collapsed), cfg, x)
    assert float(aux_c) > float(aux_u) * 2.0, (float(aux_c), float(aux_u))
    np.testing.assert_allclose(float(aux_u), cfg.router_aux_coeff,
                               rtol=0.05)


@settings(max_examples=20, deadline=None)
@given(n=st.integers(8, 4096), e=st.integers(2, 32), k=st.integers(1, 4),
       cf=st.floats(1.0, 2.0))
def test_capacity_bounds_and_the_reference_value(n, e, k, cf):
    k = min(k, e)
    jcfg, tcfg = _cfgs(e=e, k=k, capacity_factor=cf)
    cap = tmoe._capacity(n, tcfg)
    assert 1 <= cap <= n
    assert cap % 8 == 0 or cap == n
    assert cap == jmoe._capacity(n, jcfg)


def test_moe_respects_capacity_drop():
    """With a collapsed router and capacity < tokens, overflow tokens are
    dropped (at most ``capacity`` output rows can be non-zero)."""
    cfg, lp, x = _port_setup(e=4, k=1, b=1, s=64)
    x = x.abs()
    collapsed = torch.zeros_like(lp["router"])
    collapsed[:, 0] += 100.0
    y, _ = tmoe.moe_ffn(dict(lp, router=collapsed), cfg, x)
    nonzero_rows = int((y.reshape(-1, y.shape[-1]).abs().sum(1)
                        > 1e-6).sum())
    cap = tmoe._capacity(64, cfg)
    assert cap < 64, "the test needs capacity pressure"
    assert nonzero_rows <= cap, (nonzero_rows, cap)


def test_moe_local_dispatch_matches_global():
    """Per-row dispatch == global dispatch when capacity is not binding
    (the reference's tolerance; here both sides are the port's fp32)."""
    cfg, lp, x = _port_setup(e=4, k=2)
    cfg = cfg.with_(capacity_factor=8.0)
    yg, _ = tmoe.moe_ffn(lp, cfg, x)
    yl, _ = tmoe.moe_ffn(lp, cfg.with_(moe_local_dispatch=True), x)
    np.testing.assert_allclose(yg.numpy(), yl.numpy(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------- against the JAX side

def _reference_route(jcfg, jlp, x2d):
    """The reference's routing lines of ``_dispatch`` on (N, d) tokens."""
    xf = jnp.asarray(x2d)
    logits = xf.astype(jnp.float32) @ jnp.asarray(jlp["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, jcfg.top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    sel = jax.nn.one_hot(gate_idx, jcfg.n_experts, dtype=jnp.float32)
    combine = jnp.einsum("nk,nke->ne", gate_vals, sel)
    top_gate, top_tok = jax.lax.top_k(combine.T,
                                      jmoe._capacity(xf.shape[0], jcfg))
    return tuple(np.asarray(t) for t in (probs, gate_idx, combine, top_gate,
                                         top_tok))


def _route_flips(jcfg, tcfg, jlp, tlp, x2d):
    """Compares the routing of both sides; returns the tokens whose
    routing differs (each inside ROUTE_BAND, else it fails)."""
    probs, gidx, comb, tgate, ttok = _reference_route(jcfg, jlp, x2d)
    t = [v.numpy() for v in tmoe._route(tlp, tcfg, torch.from_numpy(x2d))]
    t_probs, t_gidx, t_comb, t_tgate, t_ttok = t
    np.testing.assert_allclose(t_probs, probs, rtol=RTOL, atol=0)
    flipped = set()
    k = jcfg.top_k
    srt = -np.sort(-probs, axis=-1)
    for n in range(probs.shape[0]):
        if set(gidx[n]) == set(t_gidx[n]):
            continue
        gap = srt[n, k - 1] - srt[n, k] if k < probs.shape[1] else np.inf
        assert gap <= ROUTE_BAND * srt[n, k - 1], (n, gidx[n], t_gidx[n])
        flipped.add(n)
    for e in range(jcfg.n_experts):
        want = {int(i) for i, g in zip(ttok[e], tgate[e]) if g > 0}
        got = {int(i) for i, g in zip(t_ttok[e], t_tgate[e]) if g > 0}
        cutoff = tgate[e][-1]
        for n in want ^ got:
            if n in flipped:
                continue
            assert abs(comb[n, e] - cutoff) <= ROUTE_BAND * cutoff, (e, n)
            flipped.add(n)
    return flipped


@pytest.mark.parametrize("arch,act,s,cf", [
    ("granite-moe-1b-a400m", None, 24, 1.25),   # swiglu
    ("granite-moe-1b-a400m", None, 64, 0.5),    # the capacity binds
    ("grok-1-314b", None, 24, 1.25),            # geglu
    ("grok-1-314b", "gelu", 24, 1.25),
])
@pytest.mark.parametrize("local", [False, True])
def test_moe_ffn_matches_reference(arch, act, s, cf, local):
    jcfg, tcfg, jlp, tlp, x = _pair_setup(arch, s=s, act=act,
                                          moe_local_dispatch=local,
                                          capacity_factor=cf)
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, jlp), jcfg,
                            jnp.asarray(x))
    ty, taux = tmoe.moe_ffn(tlp, tcfg, torch.from_numpy(x))
    flips = set()
    rows = [x.reshape(-1, x.shape[-1])] if not local else list(x)
    for r, x2d in enumerate(rows):
        base = 0 if not local else r * x.shape[1]
        flips |= {base + n for n in _route_flips(jcfg, tcfg, jlp, tlp, x2d)}
    jy = np.asarray(jy).reshape(-1, x.shape[-1])
    ty = ty.numpy().reshape(-1, x.shape[-1])
    keep = np.array([n not in flips for n in range(jy.shape[0])])
    assert keep.sum() >= 0.9 * keep.size, f"{len(flips)} routing flips"
    scale = np.abs(jy).max()
    err = np.abs(ty - jy)[keep].max()
    assert err <= RTOL * scale, (err, scale)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)
    dropped = int((np.abs(jy).sum(1) == 0).sum())
    if cf < 1:
        assert dropped > 0, "the capacity should drop tokens"
    print(f"\n{arch} {act or jcfg.mlp_act} S={s} cf={cf} local={local}: "
          f"max |Δy| {err / scale:.3g} of scale, {len(flips)} flips, "
          f"{dropped} tokens dropped")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b"])
def test_moe_ffn_gradients_match_reference(arch):
    jcfg, tcfg, jlp, tlp, x = _pair_setup(arch, s=24)
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(p, jcfg, xx)
        return jnp.sum(y * w) + aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jlp), jnp.asarray(x))
    names = sorted(tlp)
    leaves = [tlp[n].clone().requires_grad_() for n in names]
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.moe_ffn(dict(zip(names, leaves)), tcfg, tx)
    loss = torch.sum(y * torch.from_numpy(w)) + aux
    grads = torch.autograd.grad(loss, leaves + [tx])
    assert not _route_flips(jcfg, tcfg, jlp, tlp, x.reshape(-1, x.shape[-1]))
    worst = 0.0
    for name, tg, jg in zip(names + ["x"], grads,
                            [jg_p[n] for n in names] + [jg_x]):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        err = float(np.abs(tg.numpy() - jg).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)
        worst = max(worst, err / scale)
    print(f"\n{arch}: largest gradient gap {worst:.3g} of its leaf's scale")


def test_moe_runs_the_same_bits_twice():
    """The layer's forward and backward are deterministic (the expert
    gather and scatter go one expert at a time)."""
    cfg, lp, x = _port_setup(e=4, k=2, s=32)
    out = []
    for _ in range(2):
        leaves = {n: v.clone().requires_grad_() for n, v in lp.items()}
        y, aux = tmoe.moe_ffn(leaves, cfg, x)
        g = torch.autograd.grad((y ** 2).sum() + aux, list(leaves.values()))
        out.append((y, aux, g))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b"])
def test_moe_lm_gradient_under_vmap_equals_each_row(arch):
    """The sim runtime vmaps the LM loss's gradient over workers
    (``torch.func``): a MoE model's per-worker gradients under vmap equal
    the unbatched ones bit for bit."""
    cfg = TC.get_smoke_config(arch).with_(remat=False)
    params = TM.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 2, 9)))

    def loss(p, t):
        return TM.lm_loss(cfg, p, {"tokens": t}, train=True)[0]

    batched = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
        params, toks)
    for i in range(2):
        one = torch.func.grad(loss)(params, toks[i])
        for a, b in zip(jax.tree.leaves(batched), jax.tree.leaves(one)):
            assert torch.equal(a[i], b)


def test_bf16_moe_params_and_positions_convert_leaf_for_leaf():
    """A bf16 MoE model's tree converts leaf for leaf with the reference's
    layout: experts (L, E, d, ff) in bf16, the router (L, d, E) kept in
    fp32; M-RoPE positions (3, B, S) stay int32."""
    from repro.models import frontends as jfront
    jcfg = JC.get_smoke_config("granite-moe-1b-a400m").with_(
        dtype="bfloat16")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    mlp = tp["blocks"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert tuple(mlp["router"].shape) == (jcfg.n_layers, jcfg.d_model,
                                          jcfg.n_experts)
    for name in ("w_up", "w_gate", "w_down"):
        assert mlp[name].dtype == torch.bfloat16
        assert mlp[name].shape[:2] == (jcfg.n_layers, jcfg.n_experts)
        want = np.asarray(jp["blocks"]["mlp"][name]).astype(np.float32)
        assert np.array_equal(mlp[name].float().numpy(), want)
    ported = TM.init_params(TC.get_smoke_config(
        "granite-moe-1b-a400m").with_(dtype="bfloat16"), 0, "cpu")
    assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), ported) == \
        jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tp)
    pos = convert.tensor_from_numpy(
        np.asarray(jfront.mrope_positions(2, 24, (4, 4))), "cpu")
    assert pos.dtype == torch.int32 and tuple(pos.shape) == (3, 2, 24)
