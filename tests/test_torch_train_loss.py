"""The LM loss on the port's training route and its gradients, against
``jax.value_and_grad`` of the reference's ``lm_loss``.

The smoke configs of all ten configs of the registry, fp32, each with
``remat`` off and on: dense (stablelm-1.6b, internlm2-1.8b, llama3-405b,
yi-34b), MoE (granite-moe-1b-a400m, grok-1-314b: the loss carries the
routers' aux loss), zamba2-2.7b (hybrid: Mamba2 stages and a shared
attention block), falcon-mamba-7b (pure Mamba1), and qwen2-vl-2b and
musicgen-medium through their token embeddings. The reference's own
parameters go to the port through ``repro_torch.convert``, and both sides
get the same numpy tokens (B = 2, S = 32). qwen2-vl-2b and
musicgen-medium also take {"embeds", "labels"} batches, qwen2-vl's with
the M-RoPE positions of a text prefix and a 4 x 4 image.

Tolerance: the loss within LOSS_TOL of its value, each gradient leaf
within GRAD_TOL of its own scale (max |reference leaf|). Both sides are
fp32; they differ in the order of sums inside matmuls and reductions, in
XLA's fused exp/log/softplus, and in the scan's intra-chunk order
(measured here, shown with ``pytest -s``: at most 1.5e-6 of a leaf's
scale, falcon-mamba's). The port's gradients with remat on are bit-equal
to those with it off: the checkpointed bodies recompute the same ops on
the same inputs.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import model as JM
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.models import model as TM
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

ARCHS = ["stablelm-1.6b", "internlm2-1.8b", "zamba2-2.7b",
         "falcon-mamba-7b", "llama3-405b", "yi-34b", "granite-moe-1b-a400m",
         "grok-1-314b", "qwen2-vl-2b", "musicgen-medium"]
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
B, S = 2, 32


def _port_value_and_grad(cfg, params, tokens):
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss = TM.lm_loss(cfg, params, batch, train=True)[0]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # an input's unused leaf (musicgen's untied embedding table under an
    # embeddings batch) has a zero gradient, as jax.grad gives it
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch, remat):
    jcfg = JC.get_smoke_config(arch).with_(remat=remat)
    tcfg = TC.get_smoke_config(arch).with_(remat=remat)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    toks = np.random.default_rng(11).integers(
        0, jcfg.vocab, (B, S + 1)).astype(np.int32)

    j_loss, j_g = jax.jit(jax.value_and_grad(
        lambda p, t: JM.lm_loss(jcfg, p, {"tokens": t})[0]))(jp, toks)
    tt = torch.from_numpy(toks).long()
    t_loss, t_g = _port_value_and_grad(
        tcfg, convert.params_from_numpy(np_params, "cpu"), tt)
    _hold(arch, remat, t_loss, t_g, j_loss, j_g)
    if remat:   # the same gradients, bit for bit, as without remat
        _, plain_g = _port_value_and_grad(
            tcfg.with_(remat=False),
            convert.params_from_numpy(np_params, "cpu"), tt)
        for a, b in zip(t_g, plain_g):
            assert torch.equal(a, b)


def _hold(arch, remat, t_loss, t_g, j_loss, j_g):
    """The port's loss and gradients against the reference's, within
    LOSS_TOL and GRAD_TOL."""
    assert abs(float(t_loss) - float(j_loss)) <= LOSS_TOL * abs(
        float(j_loss)), (float(t_loss), float(j_loss))
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(j_g)[0]]
    worst = 0.0
    for path, tg, jg in zip(paths, t_g, jax.tree.leaves(j_g)):
        jg = np.asarray(jg, np.float32)
        assert tuple(tg.shape) == jg.shape, path
        scale = max(float(np.abs(jg).max()), 1e-30)
        err = float(np.abs(tg.numpy() - jg).max())
        assert err <= GRAD_TOL * scale, (
            f"{arch} {path}: max |Δ| {err} > {GRAD_TOL} · {scale}")
        worst = max(worst, err / scale)
    print(f"\n{arch} remat={remat}: largest gradient gap {worst:.3g} of "
          "its leaf's scale")   # shown with `pytest -s`


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_embedding_batches_and_gradients_match_reference(arch, remat):
    """{"embeds", "labels"} batches (with qwen2-vl's M-RoPE positions)
    through both losses."""
    from repro.models import frontends as jfront
    jcfg = JC.get_smoke_config(arch).with_(remat=remat)
    tcfg = TC.get_smoke_config(arch).with_(remat=remat)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(12)
    batch = {"embeds": rng.normal(size=(B, S, jcfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.mrope:
        batch["positions"] = np.array(jfront.mrope_positions(B, S, (4, 4)))
    j_loss, j_g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.lm_loss(jcfg, p, b)[0]))(jp, batch)
    t_batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
               else torch.from_numpy(v) for k, v in batch.items()}
    t_loss, t_g = _port_value_and_grad(
        tcfg, convert.params_from_numpy(np_params, "cpu"), t_batch)
    _hold(arch, remat, t_loss, t_g, j_loss, j_g)


def test_train_and_serving_routes_agree_in_value():
    """The two routes compute the same loss (their attention and scan
    differ only in rounding)."""
    cfg = TC.get_smoke_config("zamba2-2.7b")
    params = TM.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S + 1))).long()
    serve = float(TM.lm_loss(cfg, params, {"tokens": toks})[0])
    train = float(TM.lm_loss(cfg, params, {"tokens": toks}, train=True)[0])
    assert abs(serve - train) <= LOSS_TOL * abs(serve), (serve, train)
