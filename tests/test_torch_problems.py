"""The paper's remaining problems in the port against the JAX package: the
covtype data and its unequal partition, and the CNN.

  * ``covtype_like`` and ``random_sizes_partition`` copy the reference's
    numpy code, so their arrays and index lists are EQUAL to the
    reference's, over a grid of sizes and seeds that includes m = n and
    ``random_sizes_partition(500, 2, seed=5)``, whose two shards come out
    the same size ([250, 250]): nothing here assumes that sizes differ.
  * ``cnn_apply``, ``cnn_loss`` and the loss's gradients match the
    reference's and ``jax.grad`` on the same numpy weights and batch, at
    the paper's width (28×28, c1 8, c2 16, fc 64: 54,314 parameters) and at
    an odd side (hw 13, where both max pools see odd sides and pad at the
    end). Tolerance: 1e-5 of each array's scale (fp32 on both sides; the
    convolutions and the 784-wide product sum in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.partition import random_sizes_partition as jax_partition
from repro.data.synthetic import covtype_like as jax_covtype
from repro.data.synthetic import mnist_like as jax_mnist
from repro.models import small as JS
from repro_torch.data import covtype_like, mnist_like, random_sizes_partition
from repro_torch.models import small as TS

torch.set_num_threads(1)

TOL = 1e-5


@pytest.mark.parametrize("n,seed", [(20000, 0), (500, 3), (7, 11)])
def test_covtype_like_equals_the_reference(n, seed):
    ours, ref = covtype_like(n, seed), jax_covtype(n, seed)
    assert ours.n_classes == ref.n_classes == 7
    assert ours.x.dtype == ref.x.dtype and ours.y.dtype == ref.y.dtype
    np.testing.assert_array_equal(ours.x, ref.x)
    np.testing.assert_array_equal(ours.y, ref.y)


@pytest.mark.parametrize("n,m,seed", [(20000, 20, 0), (500, 2, 5),
                                      (500, 7, 1), (10, 10, 3), (11, 10, 4),
                                      (1, 1, 0), (581, 20, 9)])
def test_random_sizes_partition_equals_the_reference(n, m, seed):
    ours, ref = random_sizes_partition(n, m, seed), jax_partition(n, m, seed)
    assert len(ours) == len(ref) == m
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert all(len(s) >= 1 for s in ours)
    assert np.array_equal(np.sort(np.concatenate(ours)), np.arange(n))


def test_random_sizes_partition_may_draw_equal_sizes():
    """The reference's own draw at (500, 2, seed 5) is two equal shards."""
    assert [len(s) for s in random_sizes_partition(500, 2, seed=5)] == [
        len(s) for s in jax_partition(500, 2, seed=5)] == [250, 250]


def test_random_sizes_partition_refuses_more_workers_than_examples():
    with pytest.raises(ValueError) as ref:
        jax_partition(3, 4)
    with pytest.raises(ValueError) as ours:
        random_sizes_partition(3, 4)
    assert str(ours.value) == str(ref.value)


def _cnn_case(hw):
    """Numpy weights (the reference's init at the paper's width, or at an
    odd side weights whose w1 fits the ⌈hw/4⌉² pooled features) and an
    NHWC batch."""
    rng = np.random.default_rng(hw)
    if hw == 28:
        params = jax.tree.map(np.array, JS.cnn_init(jax.random.PRNGKey(0)))
        x = jax_mnist(16, seed=4).x
        np.testing.assert_array_equal(x, mnist_like(16, seed=4).x)
        y = jax_mnist(16, seed=4).y
    else:
        flat = (-(-hw // 4)) ** 2 * 16
        shapes = {"conv1": (5, 5, 1, 8), "bc1": (8,), "conv2": (5, 5, 8, 16),
                  "bc2": (16,), "w1": (flat, 64), "b1": (64,),
                  "w2": (64, 10), "b2": (10,)}
        params = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
                  for k, s in shapes.items()}
        x = rng.normal(size=(5, hw, hw, 1)).astype(np.float32)
        y = rng.integers(0, 10, 5).astype(np.int32)
    return params, x, y


def _close(ours, ref, what):
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, what
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=TOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("hw", [28, 13])
def test_cnn_matches_the_reference(hw):
    params, x, y = _cnn_case(hw)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    _close(TS.cnn_apply(tparams, tx), jax.jit(JS.cnn_apply)(jparams, jx),
           "logits")
    jloss, jgrads = jax.jit(jax.value_and_grad(JS.cnn_loss))(jparams,
                                                             (jx, jy))
    _close(TS.cnn_loss(tparams, (tx, ty)), jloss, "loss")
    grads = torch.func.grad(TS.cnn_loss)(tparams, (tx, ty))
    assert sorted(grads) == sorted(jgrads)
    for k in jgrads:
        _close(grads[k], jgrads[k], f"grad {k}")


def test_cnn_has_the_reference_widths_and_layouts():
    ours = TS.cnn_init(torch.Generator().manual_seed(0), device="cpu")
    ref = JS.cnn_init(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert sum(v.numel() for v in ours.values()) == 54_314


def test_cnn_per_worker_gradients_under_vmap():
    """``torch.func.vmap`` over per-worker CNN weights (the engine's
    ``vgrad_per``, which cada2's second evaluation and the delta rules'
    local steps use) batches ``conv2d`` over its weight: each worker's
    gradient equals ``jax.vmap(jax.grad)``'s."""
    params, x, y = _cnn_case(28)
    m = 3
    rng = np.random.default_rng(1)
    wparams = {k: np.stack([v + 0.01 * i * rng.normal(size=v.shape)
                            .astype(np.float32) for i in range(m)])
               for k, v in params.items()}
    xb = x[:12].reshape(m, 4, 28, 28, 1)
    yb = y[:12].reshape(m, 4)
    grad_and_value = torch.func.grad_and_value(TS.cnn_loss)
    tg, tl = torch.func.vmap(grad_and_value, in_dims=(0, 0))(
        {k: torch.from_numpy(v) for k, v in wparams.items()},
        (torch.from_numpy(xb), torch.from_numpy(yb)))
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(JS.cnn_loss),
                              in_axes=(0, 0)))(
        {k: jnp.asarray(v) for k, v in wparams.items()},
        (jnp.asarray(xb), jnp.asarray(yb)))
    _close(tl, jl, "losses")
    for k in jg:
        _close(tg[k], jg[k], f"grad {k}")


@pytest.mark.parametrize("kind", ["logreg", "mlp", "cnn"])
def test_make_problem_builds_the_reference_shapes(kind):
    x = mnist_like(4).x if kind != "logreg" else covtype_like(4).x
    params, loss = TS.make_problem(kind, torch.Generator().manual_seed(0),
                                   x, 10, device="cpu")
    ref, _ = JS.make_problem(kind, jax.random.PRNGKey(0), x, 10)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    y = torch.zeros(4, dtype=torch.int32)
    assert torch.isfinite(loss(params, (torch.from_numpy(x), y)))
