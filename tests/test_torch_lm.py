"""The port's LM serving slice against the JAX package's models.

For zamba2-2.7b, falcon-mamba-7b and internlm2-1.8b at their smoke configs
(fp32), the JAX package's own parameters go to the port through
``repro_torch.convert``, both sides get the same numpy tokens, and the
port's forward logits, prefill (last logits and every cache field) and 8
greedy decode steps are held against the reference's. On the JAX side the
zamba2 and falcon-mamba cases run once with the default jnp scan and once
with ``set_scan_impl("pallas")`` (the Pallas kernel in interpret mode).

Tolerance: every float array within 1e-5 of its own scale (max |ref|),
decode tokens equal. Both sides compute in fp32 with the same operation
order per layer; they differ in the order of sums inside matmuls and
reductions, in XLA's fused exp/softplus, and in the attention route (the
port's flash semantics scale q before the product, the reference's naive
route after), so elements differ by a few ULP of their array's scale
(measured here: ≤ 8e-7 of scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import attention as jattn
from repro.models import config as jconfig
from repro.models import model as JM
from repro.models import ssm as jssm
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import config as tconfig
from repro_torch.models import model as TM

torch.set_num_threads(1)

ARCHS = ["zamba2-2.7b", "falcon-mamba-7b", "internlm2-1.8b"]
RTOL = 1e-5
B, S, DECODE_STEPS = 2, 24, 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max |Δ| {err} > {RTOL} · {scale}"


def _setup(arch):
    jcfg = JC.get_smoke_config(arch).with_(remat=False)
    tcfg = TC.get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(_np(jp), "cpu")
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tcfg, jp, tp, toks


def test_configs_carry_the_reference_numbers():
    assert TC.list_archs() == sorted(ARCHS)
    for arch in ARCHS:
        for get in ("get_config", "get_smoke_config"):
            j, t = getattr(JC, get)(arch), getattr(TC, get)(arch)
            assert dataclasses.asdict(j) == dataclasses.asdict(t), arch
            assert tconfig.param_count(t) == jconfig.param_count(j)
            assert (tconfig.active_param_count(t)
                    == jconfig.active_param_count(j))
    assert tconfig.param_count(TC.get_config("zamba2-2.7b")) == 2_340_715_680


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_layout(arch):
    """Same tree, shapes and dtypes as the reference's init, the
    reference's constants, and as many parameters as ``param_count``."""
    jcfg = JC.get_smoke_config(arch)
    tcfg = TC.get_smoke_config(arch)
    want = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    got = TM.init_params(tcfg, 0, "cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
    blocks = got["blocks"]
    if "dt_bias" in blocks:
        assert bool((blocks["dt_bias"] == -4.0).all())
        assert bool((blocks["D"] == 1.0).all())
    real = sum(t.numel() for _, t in flat_g)
    assert real == tconfig.param_count(tcfg)


def _cases():
    out = []
    for arch in ARCHS:
        out.append((arch, "jnp"))
        if arch != "internlm2-1.8b":
            out.append((arch, "pallas"))
    return out


@pytest.mark.parametrize("arch,scan_impl", _cases())
def test_forward_prefill_decode_match_reference(arch, scan_impl):
    jcfg, tcfg, jp, tp, toks = _setup(arch)
    jt = jnp.asarray(toks)
    tt = torch.as_tensor(toks, dtype=torch.long)
    jssm.set_scan_impl(scan_impl)
    try:
        j_logits, _ = JM.forward(jcfg, jp, tokens=jt)
        j_last, j_cache = JM.prefill(jcfg, jp, tokens=jt,
                                     max_seq=S + DECODE_STEPS)
    finally:
        jssm.set_scan_impl("jnp")
    t_logits, aux = TM.forward(tcfg, tp, tt)
    assert float(aux) == 0.0
    _close(t_logits, j_logits, "forward logits")
    t_last, t_cache = TM.prefill(tcfg, tp, tt, max_seq=S + DECODE_STEPS)
    _close(t_last, j_last, "prefill logits")
    assert t_cache.index == int(j_cache.index) == S
    assert torch.equal(t_cache.slot_pos,
                       torch.from_numpy(np.array(j_cache.slot_pos)))
    for field in ("k", "v", "conv", "ssm"):
        want, got = getattr(j_cache, field), getattr(t_cache, field)
        assert (want is None) == (got is None), field
        if want is not None:
            _close(got, want, f"cache.{field}")

    # 8 greedy steps, each side from its own prefill cache
    j_tok, t_tok = jnp.argmax(j_last, -1), torch.argmax(t_last, -1)
    for step in range(DECODE_STEPS):
        j_last, j_cache = JM.decode_step(jcfg, jp, j_cache, tokens=j_tok)
        t_last, t_cache = TM.decode_step(tcfg, tp, t_cache, t_tok)
        _close(t_last, j_last, f"decode step {step} logits")
        j_tok, t_tok = jnp.argmax(j_last, -1), torch.argmax(t_last, -1)
        assert np.array_equal(np.asarray(j_tok), t_tok.numpy()), step
    assert t_cache.index == int(j_cache.index) == S + DECODE_STEPS
    assert torch.equal(t_cache.slot_pos,
                       torch.from_numpy(np.array(j_cache.slot_pos)))
    for field in ("k", "v", "conv", "ssm"):
        want, got = getattr(j_cache, field), getattr(t_cache, field)
        if want is not None:
            _close(got, want, f"cache.{field} after decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_converted_cache_matches_reference(arch):
    """``convert.decode_cache_from_numpy`` carries the reference's cache
    across: one decode step from it gives the reference's logits."""
    jcfg, tcfg, jp, tp, toks = _setup(arch)
    j_last, j_cache = JM.prefill(jcfg, jp, tokens=jnp.asarray(toks),
                                 max_seq=S + 1)
    t_cache = convert.decode_cache_from_numpy(_np(j_cache), "cpu")
    tok = np.asarray(jnp.argmax(j_last, -1))
    j_next, _ = JM.decode_step(jcfg, jp, j_cache, tokens=jnp.asarray(tok))
    t_next, _ = TM.decode_step(tcfg, tp, t_cache,
                               torch.as_tensor(tok, dtype=torch.long))
    _close(t_next, j_next, "decode from the converted cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The reference's own check (tests/test_models_smoke.py), inside the
    port: last-token logits of prefill(S-1) -> decode(1) equal the full
    forward's. Both are fp32 and differ only in sum order and route (the
    flash attention and the chunk scan vs the one-token steps): 1e-5 of
    scale (the reference's test allows 0.05 for its bf16-capable route)."""
    _, tcfg, _, tp, toks = _setup(arch)
    tt = torch.as_tensor(toks, dtype=torch.long)
    full, _ = TM.forward(tcfg, tp, tt)
    _, cache = TM.prefill(tcfg, tp, tt[:, :-1], max_seq=S)
    last, _ = TM.decode_step(tcfg, tp, cache, tt[:, -1])
    _close(last, full[:, -1].numpy(), "prefill(S-1)+decode vs forward")


def test_lm_loss_matches_reference():
    jcfg, tcfg, jp, tp, _ = _setup("zamba2-2.7b")
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    j_loss, j_m = JM.lm_loss(jcfg, jp, {"tokens": jnp.asarray(toks)})
    t_loss, t_m = TM.lm_loss(tcfg, tp,
                             {"tokens": torch.as_tensor(toks,
                                                        dtype=torch.long)})
    _close(t_loss, j_loss, "lm_loss")
    _close(t_m["nll"], j_m["nll"], "nll")


def test_attention_with_positions_takes_the_naive_route_on_cpu():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 12, 4, 32)).astype(np.float32)
    k = rng.normal(size=(1, 12, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, 12, 2, 32)).astype(np.float32)
    pos = np.arange(12)[::-1].copy()
    want = jattn.naive_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                 positions_q=jnp.asarray(pos),
                                 positions_k=jnp.asarray(pos), window=5,
                                 dtype=jnp.float32)
    got = tattn.causal_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                                 positions_q=torch.as_tensor(pos),
                                 positions_k=torch.as_tensor(pos), window=5,
                                 dtype=torch.float32)
    _close(got, want, "naive attention with positions")


@pytest.mark.parametrize("change,name", [({"block": "moe", "n_experts": 4,
                                           "top_k": 2}, "moe"),
                                          ({"mrope": True}, "mrope"),
                                          ({"embed_input": False},
                                           "embed_input")])
def test_unported_parts_raise_by_name(change, name):
    cfg = TC.get_smoke_config("internlm2-1.8b").with_(**change)
    with pytest.raises(NotImplementedError, match=name):
        TM.init_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match=name):
        TM.init_cache(cfg, 1, 8, "cpu")


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_serve_smoke_on_cpu(capsys, temperature):
    out = serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                      "--temperature", str(temperature)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill(4x32) on cpu: ")
    assert lines[1].startswith("decoded 16 tokens x 4 seqs in ")
    assert lines[2].startswith("sample token ids: [")
    assert tuple(out["tokens"].shape) == (4, 16)
    assert out["cache"].index == 32 + 16
    assert bool(torch.isfinite(out["logits"]).all())
