"""granite-4.0-h-micro on the port's pattern path
(``models/config.py::PatternConfig``) against the plain reference
(``bench/ref_granite_h.py``: plain torch in float32, nothing of the
port), on the CPU at the smoke size in float32
with seeded random weights: the training route's logits and loss,
prefill and decode through the cache, the published Mamba2 mixer against
a hand-written recurrence, the per-head scan's plain route at N = 128,
and the registration beside the reference's registry.

Tolerance: every comparison is float32 against float32, and the two sides
sum in other orders (the chunked scan in products against the plain loop
step by step, attention in one piece or by query blocks), so they agree
to a few units of float32 rounding of each array's scale; ``RTOL`` =
1e-5 of the scale is about 100 of them and 1/400 of bf16's rounding, and
the faults below (the reference-matched conv over x alone, the softmax
scale 1/√hd) move the logits by far more.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro_torch.configs as TC
from repro_torch.distributed.scheduler import DecodeScheduler, Request
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as serve_cli
from repro_torch.models import model as TM
from repro_torch.models import ssm
from repro_torch.models.config import param_count
from repro_torch.models.layers import causal_conv1d
from bench import ref_granite_h as RG
from bench.weights import flatten

torch.set_num_threads(1)

ARCH = "granite-4.0-h-micro"
CFG = TC.get_smoke_config(ARCH)
RTOL = 1e-5


def _gap(got, want) -> float:
    """max |got − want| over the scale of ``want``."""
    return float((got - want).abs().max() / want.abs().max())


def _params(cfg=CFG, seed=0):
    """The port's init with every leaf that it sets to a constant drawn
    at random too, so each term of the layers shows in the logits."""
    p = TM.init_params(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)

    def draw(t, lo, hi):
        return lo + (hi - lo) * torch.rand(t.shape, generator=g)
    b = p["blocks"]
    b["A_log"] = torch.log(draw(b["A_log"], 1.0, 16.0))
    b["dt_bias"] = draw(b["dt_bias"], -4.0, -1.0)
    b["D"] = draw(b["D"], 0.5, 1.5)
    b["conv_w"] = draw(b["conv_w"], -0.5, 0.5)
    b["conv_b"] = draw(b["conv_b"], -0.5, 0.5)
    for tree, keys in ((b, ("ln", "ln2", "out_norm")),
                       (p["attn_blocks"], ("ln1", "ln2"))):
        for k in keys:
            tree[k] = draw(tree[k], 0.8, 1.2)
    p["final_norm"] = draw(p["final_norm"], 0.8, 1.2)
    return p


def _model(cfg=CFG) -> dict:
    return dataclasses.asdict(cfg)


def _ref_logits(params, tokens):
    """The reference's logits (B, S, V), over the port's parameter tree."""
    return RG.logits(flatten(params), _model(), tokens)


def _tokens(shape, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, CFG.vocab, shape)).long()


def test_the_training_route_matches_the_reference():
    params = _params()
    toks = _tokens((2, 33))
    got, _ = TM.forward(CFG, params, toks[:, :-1], train=True)
    want = _ref_logits(params, toks[:, :-1])
    assert _gap(got, want) <= RTOL
    loss, _ = TM.lm_loss(CFG, params, {"tokens": toks}, train=True)
    want = RG.loss(flatten(params), _model(), toks)
    assert loss.item() == pytest.approx(want.item(), rel=RTOL)


def test_the_serving_forward_matches_the_reference():
    params = _params(seed=3)
    toks = _tokens((2, 40), seed=4)
    got, _ = TM.forward(CFG, params, toks)
    assert _gap(got, _ref_logits(params, toks)) <= RTOL


def test_prefill_then_decode_follow_the_full_forward():
    """Prefill of 12 tokens, then 4 decode steps through the cache: the
    logits at each position equal the reference's full forward over the
    prompt and the fed tokens."""
    params = _params(seed=5)
    prompt = _tokens((2, 12), seed=6)
    fed = _tokens((2, 4), seed=7)
    full = _ref_logits(params, torch.cat([prompt, fed], 1))
    logits, cache = TM.prefill(CFG, params, prompt, max_seq=16)
    assert _gap(logits, full[:, 11]) <= RTOL
    for t in range(4):
        logits, cache = TM.decode_step(CFG, params, cache, tokens=fed[:, t])
        assert _gap(logits, full[:, 12 + t]) <= RTOL, t
    assert cache.index == 16


def _hand_mamba2(p, cfg, h):
    """The published Mamba2 mixer one token at a time: the conv's window
    of the last K inputs [x, B, C], the state per head (H, P, N)."""
    di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.mamba_headdim
    nh = di // hd
    bsz, s, _ = h.shape
    out = []
    for b in range(bsz):
        window = torch.zeros(cfg.ssm_conv, cfg.conv_dim)
        state = torch.zeros(nh, hd, n)
        for t in range(s):
            u = h[b, t]
            xbc = torch.cat([u @ p["in_x"], u @ p["in_b"], u @ p["in_c"]])
            window = torch.cat([window[1:], xbc[None]])
            conv = F.silu((window * p["conv_w"]).sum(0) + p["conv_b"])
            x, bm, cm = conv[:di].reshape(nh, hd), conv[di:di + n], \
                conv[di + n:]
            dt = F.softplus(u @ p["in_dt"] + p["dt_bias"])
            a = -torch.exp(p["A_log"])
            for k in range(nh):
                state[k] = torch.exp(dt[k] * a[k]) * state[k] \
                    + dt[k] * torch.outer(x[k], bm)
            y = (state @ cm + p["D"][:, None] * x).reshape(di)
            y = y * F.silu(u @ p["in_z"])
            y = y * torch.rsqrt((y * y).mean() + cfg.norm_eps) * p["out_norm"]
            out.append(y @ p["out_proj"])
    return torch.stack(out).reshape(bsz, s, -1)


def test_the_published_mixer_is_the_recurrence():
    params = _params(seed=8)
    lp = TM.layer(params["blocks"], 0)
    h = torch.randn(2, 19, CFG.d_model, generator=torch.Generator()
                    .manual_seed(9))
    got, tail, h_final = ssm.mamba2_mixer(lp, CFG, h, state=True)
    want = _hand_mamba2(lp, CFG, h)
    assert _gap(got, want) <= RTOL
    xbc = torch.cat([h @ lp["in_x"], h @ lp["in_b"], h @ lp["in_c"]], -1)
    assert torch.equal(tail, xbc[:, -(CFG.ssm_conv - 1):])
    assert h_final.shape == (2, CFG.ssm_heads, CFG.mamba_headdim,
                             CFG.ssm_state)


def test_the_plain_heads_scan_at_state_128_is_the_recurrence():
    """``ops.selective_scan_heads``' plain route at N = 128 (the CPU's)
    against the recurrence per head, step by step."""
    g = torch.Generator().manual_seed(10)
    gb, s, nh, p, n = 2, 37, 3, 16, 128
    dt = torch.rand(gb, s, nh, generator=g) * 0.2
    x = torch.randn(gb, s, nh * p, generator=g)
    a = -torch.rand(nh, generator=g) * 4 - 0.5
    bm, cm = (torch.randn(gb, s, n, generator=g) for _ in range(2))
    y, h_final = ops.selective_scan_heads(dt, x, a, bm, cm)
    state = torch.zeros(gb, nh, p, n)
    want = torch.empty(gb, s, nh, p)
    xh = x.reshape(gb, s, nh, p)
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[:, :, None, None]
        state = decay * state + (dt[:, t, :, None] * xh[:, t])[..., None] \
            * bm[:, t, None, None, :]
        want[:, t] = torch.einsum("ghpn,gn->ghp", state, cm[:, t])
    assert _gap(y, want.reshape(gb, s, nh * p)) <= RTOL
    assert _gap(h_final, state.reshape(gb, nh * p, n)) <= RTOL


def _x_only_conv(params, xi, b_ssm, c_ssm):
    """The reference-matched mixer's conv: x alone, B and C as
    projected."""
    di = xi.shape[-1]
    xc = F.silu(causal_conv1d(xi, params["conv_w"][:, :di],
                              params["conv_b"][:di]))
    return [xc, b_ssm, c_ssm]


@pytest.mark.parametrize("fault", ["conv over x alone", "scale 1/sqrt(hd)"])
def test_the_comparison_sees_each_fault(fault, monkeypatch):
    """The tolerance is tight enough: the reference-matched conv, or the
    softmax scale 1/√hd, put into the program moves the logits past it."""
    params = _params(seed=11)
    toks = _tokens((2, 40), seed=12)
    cfg = CFG
    if fault == "conv over x alone":
        monkeypatch.setattr(ssm, "_conv_xbc", _x_only_conv)
    else:
        cfg = CFG.with_(attn_scale=0.0)
        assert cfg.softmax_scale == CFG.hd ** -0.5 != CFG.softmax_scale
    got, _ = TM.forward(cfg, params, toks)
    assert _gap(got, _ref_logits(params, toks)) > 10 * RTOL


def test_the_scheduler_serves_the_pattern():
    """``DecodeScheduler`` rounds of uneven prompts: each request's tokens
    are the greedy continuation the reference's full forward gives."""
    params = _params(seed=13)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, CFG.vocab, n, dtype=np.int32)
               for n in (9, 5, 12)]
    sched = DecodeScheduler(CFG, params, n_slots=2, max_seq=16)
    for i, p in enumerate(prompts):
        sched.submit(Request(uid=i, prompt=p, max_new=3))
    done = {r.uid: r.out for r in sched.run()}
    for i, p in enumerate(prompts):
        # the scheduler pads a round's prompts with their last token
        n_pad = max(len(q) for q in prompts[2 * (i // 2):2 * (i // 2) + 2])
        seq = list(p) + [int(p[-1])] * (n_pad - len(p))
        for tok in done[i]:
            lg = _ref_logits(params, torch.tensor([seq]))[0, -1]
            assert tok == int(lg.argmax()), (i, seq)
            seq.append(tok)


def test_registration_beside_the_reference_registry():
    assert ARCH in TC.list_port_archs() and ARCH not in TC.list_archs()
    cfg = TC.get_config(ARCH)
    assert param_count(cfg) == 3_191_396_096
    assert sum(t.numel() for t in _leaves(TM.abstract_params(cfg))) \
        == param_count(cfg)
    assert cfg.layer_types.count("attention") == 4
    assert [i for i, k in enumerate(cfg.layer_types)
            if k == "attention"] == [5, 15, 25, 35]
    assert CFG.layer_types == ("mamba2", "attention")
    assert param_count(CFG) == sum(t.numel() for t in _leaves(_params()))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_the_serving_launcher_offers_it():
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--tokens",
                          "3"])
    assert out["tokens"].shape == (2, 3)


def test_sharding_the_pattern_raises_by_name():
    from repro_torch.distributed import sharding
    mesh = tmesh.make_host_mesh()
    for fn in (lambda: sharding.param_pspecs(CFG, mesh),
               lambda: sharding.shard_params(_params(), CFG, mesh)):
        with pytest.raises(ValueError, match=CFG.name):
            fn()


def test_no_rotary_tables_and_the_scale_reach_flash(monkeypatch):
    """Prefill computes no rotary table, and its attention layer hands the
    configured softmax scale to ``ops.flash_attention``."""
    scales = []
    real = ops.flash_attention

    def spy(*args, **kw):
        scales.append(kw.get("scale"))
        return real(*args, **kw)

    def no_rope(*args, **kw):
        raise AssertionError("a rotary table for a NoPE model")
    monkeypatch.setattr(ops, "flash_attention", spy)
    monkeypatch.setattr(TM.attn, "rope_angles", no_rope)
    monkeypatch.setattr(TM.attn, "apply_rope", no_rope)
    logits, cache = TM.prefill(CFG, _params(), _tokens((2, 10)), max_seq=12)
    TM.decode_step(CFG, _params(), cache, tokens=logits.argmax(-1))
    assert scales == [CFG.softmax_scale] == [1 / 32]


def test_the_flash_plain_route_takes_the_scale():
    g = torch.Generator().manual_seed(15)
    q, k, v = (torch.randn(1, 9, 4, 16, generator=g) for _ in range(3))
    want = ref.flash_attention_ref(q * 2.0, k, v)        # 2/√16 = 0.5
    got = ref.flash_attention_ref(q, k, v, scale=0.5)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
