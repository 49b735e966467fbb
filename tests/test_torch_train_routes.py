"""The training routes of the port's models against the reference's code
that the JAX trainer differentiates: the blockwise attention
(``repro.models.attention.flash_attention``), the training dispatch of
``causal_attention``, and the chunked selective scan
(``repro.models.ssm.selective_scan_jnp``). Forward values and gradients
(``jax.grad`` of Σ out·cotangent against ``torch.autograd``) on the same
numpy inputs, in fp32.

Tolerance: every array within TOL of its own scale (max |reference|).
Both sides compute in fp32 with the same operations; they differ in the
order of the sums inside einsums and reductions, in XLA's fused exp, and
in the scan's intra-chunk order (the reference's associative scan runs as
a tree, the port's step by step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max |Δ| {err} > {TOL} · {scale}"


def _grads(j_fn, t_fn, arrays, cotangents):
    """Forward outputs and gradients of Σ out·cotangent in both packages,
    with respect to every array."""
    def j_loss(*xs):
        outs = j_fn(*xs)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cotangents))
    j_outs = j_fn(*map(jnp.asarray, arrays))
    j_g = jax.grad(j_loss, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    t_outs = t_fn(*ts)
    loss = sum(torch.sum(o * torch.from_numpy(c))
               for o, c in zip(t_outs, cotangents))
    t_g = torch.autograd.grad(loss, ts)
    return j_outs, t_outs, j_g, t_g


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("window", [0, 24])
def test_blockwise_attention_matches_reference(window):
    """S = 64 in query chunks of 16 and KV chunks of 8, GQA 4:2."""
    rng = np.random.default_rng(window)
    b, s, hq, hkv, hd = 2, 64, 4, 2, 8
    q = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    ct = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    j_outs, t_outs, j_g, t_g = _grads(
        lambda q, k, v: (jattn.flash_attention(
            q, k, v, window=window, dtype=jnp.float32, q_chunk=16,
            kv_chunk=8),),
        lambda q, k, v: (tattn.blockwise_attention(
            q, k, v, window=window, dtype=torch.float32, q_chunk=16,
            kv_chunk=8),),
        (q, k, v), (ct,))
    _close(t_outs[0], j_outs[0], "out")
    for name, tg, jg in zip("qkv", t_g, j_g):
        _close(tg, jg, f"d{name}")


@pytest.mark.parametrize("s,route", [(32, "naive"), (2048, "blockwise")])
def test_training_dispatch_takes_the_reference_route(monkeypatch, s, route):
    """``causal_attention(train=True)`` picks the reference's route by
    length (naive below 2048, blockwise at 2048), never the serving
    route's ``ops.flash_attention``, and matches the reference's
    ``causal_attention`` on a tiny head."""
    taken = []
    for name in ("naive_attention", "blockwise_attention"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _f=fn, _n=name, **kw: (
            taken.append(_n), _f(*a, **kw))[1])

    def refuse(*a, **kw):
        raise AssertionError("the training route reached ops.flash_attention")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(1, s, 1, 4)).astype(np.float32)
               for _ in range(3))
    got = tattn.causal_attention(*map(torch.from_numpy, (q, k, v)),
                                 dtype=torch.float32, train=True)
    assert taken == [f"{route}_attention"]
    want = jattn.causal_attention(*map(jnp.asarray, (q, k, v)),
                                  dtype=jnp.float32)
    _close(got, want, f"causal_attention S={s}")


# ---------------------------------------------------------------- the scan

def _scan_inputs(rng, a_form, with_h0):
    bsz, s, d, n = 2, 32, 16, 4
    dt = np.log1p(np.exp(rng.normal(size=(bsz, s, d)) - 2)).astype(
        np.float32)
    x = rng.normal(size=(bsz, s, d)).astype(np.float32)
    if a_form == "mamba1":     # a dense (D, N) matrix
        a = -np.exp(rng.normal(size=(d, n))).astype(np.float32)
    else:                      # mamba2: one decay per head of 4 channels
        a = np.repeat(-np.exp(rng.normal(size=(d // 4,))), 4)[:, None]
        a = np.broadcast_to(a, (d, n)).astype(np.float32).copy()
    b = rng.normal(size=(bsz, s, n)).astype(np.float32)
    c = rng.normal(size=(bsz, s, n)).astype(np.float32)
    arrays = [dt, x, a, b, c]
    if with_h0:
        arrays.append(rng.normal(size=(bsz, d, n)).astype(np.float32))
    return arrays


@pytest.mark.parametrize("a_form,with_h0", [("mamba1", False),
                                            ("mamba1", True),
                                            ("mamba2", False)])
def test_chunked_scan_matches_reference(a_form, with_h0):
    """Four chunks of 8: y and h_final, and their gradients in every input
    (h0 included where given)."""
    rng = np.random.default_rng(3)
    arrays = _scan_inputs(rng, a_form, with_h0)
    y_shape, h_shape = arrays[1].shape, (2, 16, 4)
    cts = (rng.normal(size=y_shape).astype(np.float32),
           rng.normal(size=h_shape).astype(np.float32))

    def j_fn(dt, x, a, b, c, h0=None):
        return jssm.selective_scan_jnp(dt, x, a, b, c, h0, chunk=8)

    def t_fn(dt, x, a, b, c, h0=None):
        if a_form == "mamba2":   # the model's stride-0 view of per-head A
            a = a[:, :1].expand(-1, a.shape[1])
        return tssm.selective_scan_chunked(dt, x, a, b, c, h0, chunk=8)

    j_outs, t_outs, j_g, t_g = _grads(j_fn, t_fn, arrays, cts)
    _close(t_outs[0], j_outs[0], "y")
    _close(t_outs[1], j_outs[1], "h_final")
    names = ["dt", "x", "a", "b", "c", "h0"][:len(arrays)]
    for name, tg, jg in zip(names, t_g, j_g):
        if name == "a" and a_form == "mamba2":
            # the port's A is one column seen N times, the reference's N
            # equal columns: compare the gradient of each channel's decay
            tg, jg = tg.sum(1), jnp.sum(jg, axis=1)
        _close(tg, jg, f"d{name}")


def test_training_scan_route_is_the_chunked_scan(monkeypatch):
    """``_scan(train=True)`` never reaches the kernel dispatch."""
    def refuse(*a, **kw):
        raise AssertionError("the training route reached ops.selective_scan")

    monkeypatch.setattr(ops, "selective_scan", refuse)
    rng = np.random.default_rng(5)
    dt, x, a, b, c = map(torch.from_numpy, _scan_inputs(rng, "mamba1",
                                                        False))
    y, h = tssm._scan(dt, x, a, b, c, None, train=True)
    y2, h2 = tssm.selective_scan_chunked(dt, x, a, b, c)
    assert torch.equal(y, y2) and torch.equal(h, h2)
