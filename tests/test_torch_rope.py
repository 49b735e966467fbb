"""The rotary embedding's routes: the plain version (``ref.rope_ref``), the
one-pass CUDA kernel (``kernels/rope.py``) and the rule that picks between
them (``models/attention.py::apply_rope``).

The CPU tests hold the plain version and every route a CPU tensor takes to
the eager expression the models ran before the kernel, bit for bit, and
check that a call autograd would record keeps that expression (the kernel
has no backward). The tests marked ``cuda`` skip without a CUDA device; on
the card (no JAX there) run:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_rope.py

They hold the kernel to the same expression bit for bit, count its
launches on the serving and training routes and check what its wrapper
refuses. This file imports neither JAX nor the JAX package.
"""
import pytest
import torch
import torch.utils.checkpoint

from repro_torch import configs as TC
from repro_torch.core.rules import CommRule
from repro_torch.distributed.trainer import (TrainHParams, init_train_state,
                                             make_train_step, worker_split)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rope as trope
from repro_torch.models import attention as tattn
from repro_torch.models import frontends as tfront
from repro_torch.models import model as TM


def _eager(x, cos, sin, rotary_pct=1.0):
    """``models/attention.py::apply_rope`` as it was before the kernel."""
    hd = x.shape[-1]
    rot = int(hd * rotary_pct)
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    c = cos[..., None, : rot // 2]
    s = sin[..., None, : rot // 2]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def _sections(half: int) -> tuple:
    """M-RoPE sections (t, h, w) that add up to ``half``."""
    hw = 3 * half // 8
    return (half - 2 * hw, hw, hw)


def _tables(kind: str, b: int, s: int, hd: int, pct: float, device,
            offset: int = 0):
    """RoPE's (1, S, rot/2) tables, the models' own, or M-RoPE's (B, S,
    hd/2) from an image plan's positions; ``offset`` starts the positions
    there (a decode step's)."""
    if kind == "rope":
        pos = torch.arange(offset, offset + s, device=device)[None]
        return tattn.rope_angles(pos, int(hd * pct), 1e6)
    pos = tfront.mrope_positions(b, offset + s, (2, 2), device=device)
    return tattn.mrope_angles(pos[..., offset:], hd, 1e6,
                              _sections(hd // 2))


def _operands(b, s, h, hd, dtype, kind, pct, device, gen):
    x = (3 * torch.randn(b, s, h, hd, generator=gen, device=device)
         ).to(dtype)
    cos, sin = _tables(kind, b, s, hd, pct, device)
    return x, cos, sin


_GRID = [pytest.param(hd, pct, kind, s, dtype,
                      id=f"hd{hd}-{pct}-{kind}-s{s}-{str(dtype)[6:]}")
         for hd in (64, 80, 128, 160) for pct in (1.0, 0.5, 0.25)
         for kind in ("rope", "mrope") for s in (1, 333)
         for dtype in (torch.bfloat16, torch.float32)]


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("hd,pct,kind,s,dtype", _GRID)
def test_plain_rope_is_the_eager_expression(hd, pct, kind, s, dtype):
    """``ref.rope_ref``, ``ops.apply_rope`` and the models' ``apply_rope``
    on the CPU give the eager expression's bits (5 heads: one group of
    four and one more)."""
    gen = torch.Generator().manual_seed(hd + s)
    x, cos, sin = _operands(2, s, 5, hd, dtype, kind, pct, "cpu", gen)
    want = _eager(x, cos, sin, pct)
    for got in (ref.rope_ref(x, cos, sin, pct),
                ops.apply_rope(x, cos, sin, pct),
                ops.apply_rope(x, cos, sin, pct, impl="plain"),
                tattn.apply_rope(x, cos, sin, pct)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.fixture
def routed(monkeypatch):
    """Counts the calls that reach ``ops.apply_rope`` (the kernel's route
    on the card)."""
    calls = []
    real = ops.apply_rope

    def counting(*args, **kw):
        calls.append(kw.get("impl"))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "apply_rope", counting)
    return calls


@pytest.mark.parametrize("needs_grad", ["x", "cos", "both"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_keeps_the_eager_route_and_its_gradients(routed, needs_grad,
                                                          dtype):
    """An operand that requires grad, with grad enabled, keeps the eager
    expression; its output and gradients are the expression's bits."""
    gen = torch.Generator().manual_seed(7)
    x, cos, sin = _operands(2, 33, 3, 64, dtype, "rope", 0.5, "cpu", gen)
    w = torch.randn(2, 33, 3, 64, generator=gen)

    def grads(fn):
        xs = x.detach().requires_grad_(needs_grad in ("x", "both"))
        cs = cos.detach().requires_grad_(needs_grad in ("cos", "both"))
        out = fn(xs, cs, sin, 0.5)
        leaves = [t for t in (xs, cs) if t.requires_grad]
        return out, torch.autograd.grad((out.float() * w).sum(), leaves)

    got, got_g = grads(tattn.apply_rope)
    assert routed == []
    want, want_g = grads(_eager)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


@pytest.mark.parametrize("mode", ["plain", "no_grad", "inference_mode"])
def test_calls_autograd_does_not_record_take_the_kernel_route(routed, mode):
    """Tensors that require no grad, or any tensors under ``no_grad`` or
    ``inference_mode``, go to ``ops.apply_rope`` with the caller's
    ``impl``."""
    gen = torch.Generator().manual_seed(3)
    x, cos, sin = _operands(1, 9, 2, 32, torch.bfloat16, "rope", 1.0, "cpu",
                            gen)
    if mode == "plain":
        out = tattn.apply_rope(x, cos, sin, 1.0, "plain")
    else:
        ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
        with ctx:
            out = tattn.apply_rope(x.requires_grad_(mode == "no_grad"), cos,
                                   sin, 1.0, "plain")
    assert routed == ["plain"]
    assert torch.equal(out, _eager(x.detach(), cos, sin))


def test_checkpointed_training_keeps_the_eager_route(routed):
    """Under ``torch.utils.checkpoint(use_reentrant=False)`` (the trainer's
    remat) the forward and its recomputation record, so both stay eager;
    the gradient is the expression's."""
    gen = torch.Generator().manual_seed(5)
    x, cos, sin = _operands(2, 17, 4, 64, torch.bfloat16, "rope", 0.25,
                            "cpu", gen)

    def loss(fn, xs):
        return torch.utils.checkpoint.checkpoint(
            lambda t: fn(t, cos, sin, 0.25).float().square().sum(), xs,
            use_reentrant=False)

    xs = x.detach().requires_grad_()
    (got,) = torch.autograd.grad(loss(tattn.apply_rope, xs), [xs])
    assert routed == []
    xs = x.detach().requires_grad_()
    (want,) = torch.autograd.grad(loss(_eager, xs), [xs])
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "stablelm-1.6b",
                                  "qwen2-vl-2b", "zamba2-2.7b"])
def test_prefill_and_decode_route_every_attention_layer(routed, arch):
    """A prefill and a decode step send q and k of every attention layer
    to ``ops.apply_rope``; a training loss under autograd sends none."""
    cfg = TC.get_smoke_config(arch)
    params = TM.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(11)
    if cfg.embed_input:
        toks = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    else:
        toks = torch.randn(2, 24, cfg.d_model, generator=gen)
    kw = {"tokens" if cfg.embed_input else "embeds": toks}
    if cfg.mrope:
        kw["positions"] = tfront.mrope_positions(2, 24, (2, 2), device="cpu")
    n_attn = TM._n_attn_layers(cfg)
    logits, cache = TM.prefill(cfg, params, max_seq=32, **kw)
    assert routed == [None] * 2 * n_attn
    routed.clear()
    step = ({"tokens": torch.argmax(logits, -1)} if cfg.embed_input
            else {"embeds": torch.zeros(2, 1, cfg.d_model)})
    TM.decode_step(cfg, params, cache, **step)
    assert routed == [None] * 2 * n_attn
    routed.clear()
    batch = ({"tokens": toks} if cfg.embed_input
             else {"embeds": toks, "labels": torch.zeros(2, 24,
                                                         dtype=torch.long)})
    loss, _ = TM.lm_loss(cfg, _requiring_grad(params), batch, train=True)
    assert routed == []
    assert bool(torch.isfinite(loss))


def _requiring_grad(tree):
    """A copy of a params tree whose floating leaves require grad."""
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.detach().requires_grad_()
    return tree


def test_plain_route_edges():
    """rot = 0 returns x itself on every route; ``meta`` tensors take the
    plain version (the dry run's shapes); ``impl="kernel"`` on a CPU
    tensor and the kernel's wrapper on CPU tensors raise."""
    x = torch.randn(1, 4, 2, 8)
    cos, sin = tattn.rope_angles(torch.arange(4)[None], 8, 1e4)
    assert ops.apply_rope(x, cos, sin, 0.1) is x
    assert tattn.apply_rope(x, cos, sin, 0.0) is x
    xm = torch.empty(3, 5, 2, 8, device="meta", dtype=torch.bfloat16)
    cm, sm = (torch.empty(1, 5, 4, device="meta") for _ in range(2))
    out = ops.apply_rope(xm, cm, sm)
    assert out.device.type == "meta" and out.shape == xm.shape
    assert out.dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        ops.apply_rope(x, cos, sin, impl="kernel")
    before = trope.apply_rope.launches
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        trope.apply_rope(x, cos, sin)
    assert trope.apply_rope.launches == before


def _refused(x, cos, sin):
    """Operands the kernel's wrapper refuses, each with the words of its
    error: x (2, 6, 3, 16) and its (2, 6, 8) tables."""
    return [((x.transpose(1, 2), cos, sin), "contiguous"),
            ((x[0], cos, sin), r"\(B, S, H, hd\)"),
            ((x.half(), cos, sin), "fp32 or bf16"),
            ((x, cos, sin[..., :4]), "differ"),
            ((x, cos.double(), sin.double()), "must be fp32"),
            ((x, cos[..., :4], sin[..., :4]), "width 4"),
            ((x, cos.expand(3, 6, 8), sin.expand(3, 6, 8)), "broadcast"),
            ((x, cos.cpu(), sin.cpu()), "CUDA tensors"),
            ((x, cos, sin, 0.0625), "even"),
            ((x, cos, sin, 1.5), "even")]


@pytest.mark.parametrize("case", range(10))
def test_wrapper_checks_its_operands_before_the_device(case):
    """On host tensors the wrapper names what is wrong with the operands
    before it says the kernel needs the card, and launches nothing."""
    x = torch.randn(2, 6, 3, 16)
    cos, sin = _tables("rope", 2, 6, 16, 1.0, "cpu")
    args, match = _refused(x, cos, sin)[case]
    before = trope.apply_rope.launches
    with pytest.raises((ValueError, RuntimeError), match=match):
        trope.apply_rope(*args)
    assert trope.apply_rope.launches == before


# ------------------------------------------------------------------ card

@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,pct,kind,s,dtype", _GRID)
def test_kernel_is_bit_equal_to_the_eager_expression(gen, hd, pct, kind, s,
                                                     dtype):
    """One launch a call, the eager expression's bits on the card, and the
    same bits run to run (5 heads: one group of four and one more)."""
    x, cos, sin = _operands(2, s, 5, hd, dtype, kind, pct, "cuda", gen)
    before = trope.apply_rope.launches
    got = tattn.apply_rope(x, cos, sin, pct)
    assert trope.apply_rope.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, _eager(x, cos, sin, pct))
    assert torch.equal(got, trope.apply_rope(x, cos, sin, pct))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["unaligned", "batch_rows", "decode",
                                  "heads16", "heads8", "2d_tables",
                                  "long"])
def test_kernel_on_every_layout_it_takes(gen, dtype, case):
    """Bit-equal on the scalar instance (x off 16 bytes), on tables with a
    row a batch row or one row a step, at the serving head counts, on
    (S, W) tables, and over more tokens than the card holds threads."""
    b, s, h, hd = (2, 20000, 5, 128) if case == "long" else (3, 67, 5, 128)
    cos, sin = _tables("rope", b, s, hd, 1.0, "cuda")
    x = torch.randn(b, s, h, hd, generator=gen, device="cuda").to(dtype)
    if case == "unaligned":
        buf = torch.randn(x.numel() + 1, generator=gen, device="cuda")
        x = buf.to(dtype)[1:].view(b, s, h, hd)
        assert x.data_ptr() % 16
    elif case == "batch_rows":
        cos, sin = (torch.randn(b, s, hd // 2, generator=gen, device="cuda")
                    for _ in range(2))
    elif case == "decode":
        x = x[:, :1].contiguous()
        cos, sin = _tables("rope", 1, 1, hd, 1.0, "cuda", offset=4000)
    elif case in ("heads16", "heads8"):
        x = torch.randn(b, s, int(case[5:]), hd, generator=gen,
                        device="cuda").to(dtype)
    elif case == "2d_tables":
        cos, sin = cos[0], sin[0]
    got = trope.apply_rope(x, cos, sin)
    assert torch.equal(got, _eager(x, cos, sin))


@pytest.mark.cuda
def test_kernel_launches_on_the_serving_route_and_not_in_training(gen):
    """A dense prefill launches the kernel twice an attention layer (q and
    k) and a decode step twice again, with logits bit-equal to the same
    prefill with the rotary embedding's plain version; an M-RoPE prefill
    launches it too; a ``make_train_step`` step launches none."""
    for arch in ("internlm2-1.8b", "qwen2-vl-2b"):
        cfg = TC.get_smoke_config(arch)
        params = TM.init_params(cfg, 0)
        if cfg.embed_input:
            kw = {"tokens": torch.randint(0, cfg.vocab, (2, 40),
                                          generator=gen, device="cuda")}
        else:
            kw = {"embeds": torch.randn(2, 40, cfg.d_model, generator=gen,
                                        device="cuda")}
        if cfg.mrope:
            kw["positions"] = tfront.mrope_positions(2, 40, (4, 4))
        n_attn = TM._n_attn_layers(cfg)
        before = trope.apply_rope.launches
        logits, cache = TM.prefill(cfg, params, max_seq=48, **kw)
        assert trope.apply_rope.launches == before + 2 * n_attn
        real = ops.apply_rope
        try:
            ops.apply_rope = (lambda *a, impl=None, **k:
                              real(*a, impl="plain", **k))
            plain, _ = TM.prefill(cfg, params, max_seq=48, **kw)
        finally:
            ops.apply_rope = real
        assert trope.apply_rope.launches == before + 2 * n_attn
        assert torch.equal(logits, plain)
        step = ({"tokens": torch.argmax(logits, -1)} if cfg.embed_input
                else {"embeds": torch.zeros(2, 1, cfg.d_model,
                                            device="cuda")})
        TM.decode_step(cfg, params, cache, **step)
        assert trope.apply_rope.launches == before + 4 * n_attn
    cfg = TC.get_smoke_config("stablelm-1.6b")
    hp = TrainHParams(rule=CommRule(kind="cada2", c=20.0, d_max=4,
                                    max_delay=10), lr=1e-3)
    state = init_train_state(cfg, hp, 2, 0)
    batch = worker_split({"tokens": torch.randint(
        0, cfg.vocab, (4, 33), generator=gen, device="cuda")}, 2)
    before = trope.apply_rope.launches
    _, mets = make_train_step(cfg, hp, 2)(state, batch)
    torch.cuda.synchronize()
    assert trope.apply_rope.launches == before
    assert bool(torch.isfinite(mets["loss"]))


@pytest.mark.cuda
def test_wrapper_refuses_what_it_does_not_take(gen):
    """Non-contiguous or 3-D x, fp16 x, tables that differ, are not fp32,
    are too narrow, do not broadcast or sit on the host, and an odd or
    out-of-range rot: each raises by name and launches nothing."""
    x = torch.randn(2, 6, 3, 16, generator=gen, device="cuda")
    cos, sin = _tables("rope", 2, 6, 16, 1.0, "cuda")
    before = trope.apply_rope.launches
    for args, match in _refused(x, cos, sin):
        with pytest.raises((ValueError, RuntimeError), match=match):
            trope.apply_rope(*args)
    assert trope.apply_rope.launches == before
