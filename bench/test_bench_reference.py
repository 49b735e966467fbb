"""The plain reference (``bench/reference.py``, ``bench/refcada.py``)
against the port on the CPU, at the port's smoke configurations in
float32: the dense loss and its gradients, the prefill's last logits,
the attention's query blocks, and three cada2 steps of the trainer."""
from __future__ import annotations

import pytest
import torch

from bench import reference as R
from bench import train, weights
from bench.conftest import port_dict, small_train_cell


def _draw(cfg, init, seed=0):
    return weights.draw(weights.program_shapes(cfg), init, seed,
                        torch.device("cpu"))


def test_dense_loss_and_gradients_match_the_port():
    from repro_torch.configs import stablelm_1_6b
    from repro_torch.models.model import lm_loss
    cfg = stablelm_1_6b.smoke_config()
    theta = _draw(cfg, small_train_cell().config["init"], 3)
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=torch.Generator()
                         .manual_seed(1))
    leaves = {p: t.clone().requires_grad_() for p, t in theta.items()}
    port = lm_loss(cfg, weights.unflatten(leaves), {"tokens": toks},
                   train=True)[0]
    port_g = torch.autograd.grad(port, list(leaves.values()))
    ref_leaves = {p: t.clone().requires_grad_() for p, t in theta.items()}
    ref = R.dense_loss(ref_leaves, port_dict(cfg), toks)
    ref_g = torch.autograd.grad(ref, list(ref_leaves.values()))
    assert port.item() == pytest.approx(ref.item(), rel=1e-5)
    for p, a, b in zip(theta, port_g, ref_g):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6 * b.abs().max()), p


def test_last_logits_match_the_ports_prefill():
    from repro_torch.configs import internlm2_1_8b
    from repro_torch.models.model import prefill
    cfg = internlm2_1_8b.smoke_config()
    theta = _draw(cfg, [["*", {"normal": 0.1}]], 4)
    toks = torch.randint(0, cfg.vocab, (2, 70), generator=torch.Generator()
                         .manual_seed(2))
    port = prefill(cfg, weights.unflatten(theta), toks)[0]
    ref = R.dense_last_logits(theta, port_dict(cfg), toks)
    assert torch.allclose(port, ref, rtol=1e-4, atol=1e-5 * ref.abs().max())


@pytest.mark.parametrize("block", [1, 7, 64])
def test_attention_in_query_blocks_is_whole_attention(block):
    from repro_torch.configs import internlm2_1_8b
    cfg = port_dict(internlm2_1_8b.smoke_config())
    g = torch.Generator().manual_seed(6)
    d, hd = cfg["d_model"], cfg["d_model"] // cfg["n_heads"]
    kv = cfg["n_kv_heads"] * hd
    p = {"wq": torch.randn(d, d, generator=g) * 0.1,
         "wk": torch.randn(d, kv, generator=g) * 0.1,
         "wv": torch.randn(d, kv, generator=g) * 0.1,
         "wo": torch.randn(d, d, generator=g) * 0.1}
    x = torch.randn(2, 40, d, generator=g)
    cos, sin = R.rope_tables(40, hd, cfg["rope_theta"], x.device)
    whole = R.attention(x, p, cfg, cos, sin, R.FP32, block=40)
    got = R.attention(x, p, cfg, cos, sin, R.FP32, block=block)
    assert torch.allclose(got, whole, rtol=1e-5, atol=1e-6)


def test_cada2_reference_follows_the_ports_trainer(cpu):
    cell = small_train_cell(dtype="float32", remat=False)
    model = cell.config["model"]
    from repro_torch.models.config import ModelConfig
    theta0 = weights.draw(weights.program_shapes(ModelConfig(**model)),
                          cell.config["init"], 9, cpu)
    feed = train.feeder(cell, 9, cpu)
    got = train.program_first_steps(train.Program(cell, cpu, theta0),
                                    feed, 3, theta0)
    want = train.reference_steps(cell, theta0, feed, 3, R.FP32)
    assert got["upload"] == want["upload"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    for key in ("grad", "change"):
        for p in want[key]:
            assert got[key][p] == pytest.approx(want[key][p], rel=1e-3,
                                                abs=1e-6), (key, p)
