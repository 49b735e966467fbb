"""The port's selective scan and flash attention against the JAX package's
Pallas kernels (``ops.selective_scan``, ``ops.flash_attention``), run in
interpret mode as the JAX package's own kernel tests run them on the CPU.
Both sides get the same numpy inputs; the port's dispatch sends CPU tensors
to the plain PyTorch versions, which the CUDA kernels are held against on
the card (``tests/test_torch_cuda.py``).

Tolerances:
  * scan, y and h_final: |Δ| ≤ 1e-5 · max(1, |ref|). Both sides run the
    same fp32 recurrence step by step; they differ in the order of the
    N-sum of y_t and in XLA's own exp, so elements differ by a few ULP of
    the running sums (measured here: ≤ 4.3e-6 of max(1, |ref|)). bf16
    x/B/C are upcast exactly on both sides, so the fp32 band holds for
    them too.
  * flash attention: |Δ| ≤ 1e-5 · max(1, |ref|). Both compute fp32 scores
    of q·(1/√hd) and an fp32 softmax; the Pallas kernel does it online over
    64-key blocks, the plain version in one piece, so sums run in another
    order (measured here: ≤ 5.4e-7). bf16 operands: the output is rounded
    to bf16 on both sides, so elements may differ by one bf16 ULP
    (2⁻⁸ relative) where the fp32 values straddle a rounding boundary.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ops as jops
from repro_torch import configs as TC
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ssm_scan
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bound = rtol * np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= bound), float(
        np.abs(got - want).max())


def _scan_inputs(rng, g, s, d, n, lowp):
    dt = np.abs(rng.normal(size=(g, s, d)) * 0.1).astype(np.float32)
    x = rng.normal(size=(g, s, d)).astype(np.float32)
    a = -np.abs(rng.normal(size=(g, d, n))).astype(np.float32)
    b = rng.normal(size=(g, s, n)).astype(np.float32)
    c = rng.normal(size=(g, s, n)).astype(np.float32)
    if lowp:   # x, B, C stored in bf16 (rounded once, on the JAX side)
        x, b, c = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16))
                   for t in (x, b, c))
    return dt, x, a, b, c


@pytest.mark.parametrize("shape,lowp", [((1, 64, 128, 16), False),
                                        ((2, 128, 256, 16), False),
                                        ((3, 64, 128, 64), False),
                                        ((1, 64, 128, 16), True)])
def test_plain_scan_matches_pallas(shape, lowp):
    rng = np.random.default_rng(sum(shape))
    ins = _scan_inputs(rng, *shape, lowp)
    y_j, h_j = jops.selective_scan(*(jnp.asarray(t) for t in ins), chunk=32,
                                   dblk=128, interpret=True)
    t_ins = [tensor_from_numpy(t, "cpu") for t in ins]
    before = ssm_scan.selective_scan.launches
    y_t, h_t = ops.selective_scan(*t_ins)
    assert ssm_scan.selective_scan.launches == before
    assert y_t.dtype == h_t.dtype == torch.float32
    _close(y_t.numpy(), y_j)
    _close(h_t.numpy(), h_j)


def test_plain_scan_takes_a_broadcast_a():
    """The model passes A as a zero-stride view over the groups; the plain
    version gives the same result as with A materialised."""
    rng = np.random.default_rng(3)
    dt, x, a, b, c = (tensor_from_numpy(t, "cpu")
                      for t in _scan_inputs(rng, 3, 16, 24, 8, False))
    a2 = a[0]
    y1, h1 = ops.selective_scan(dt, x, a2.expand(3, *a2.shape), b, c)
    y2, h2 = ops.selective_scan(dt, x, a2.expand(3, *a2.shape).clone(), b, c)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_mamba2_scan_inputs_give_a_as_a_stride0_view_on_n():
    """Mamba2's A reaches the scan as a view with stride 0 on N (the scan
    kernel reads that stride and computes one decay per channel), with
    the values the materialised A had; the plain scan gives the same bits
    from the view and from the materialised A."""
    cfg = TC.get_smoke_config("zamba2-2.7b")
    rng = np.random.default_rng(5)
    hn, hd, n = cfg.ssm_heads, cfg.mamba_headdim, cfg.ssm_state
    params = {"A_log": tensor_from_numpy(
                  rng.normal(size=hn).astype(np.float32), "cpu"),
              "dt_bias": tensor_from_numpy(
                  rng.normal(size=hn).astype(np.float32), "cpu")}
    dt_raw = tensor_from_numpy(
        rng.normal(size=(2, 24, hn)).astype(np.float32), "cpu")
    dt, a = tssm._mamba2_scan_inputs(params, cfg, dt_raw)
    assert a.shape == (cfg.d_inner, n) and a.stride(-1) == 0
    a_h = -torch.exp(params["A_log"].float())
    a_mat = torch.repeat_interleave(a_h, hd)[:, None] * torch.ones(
        (1, n), dtype=torch.float32)
    assert torch.equal(a, a_mat)
    x, b, c = (tensor_from_numpy(rng.normal(size=shape).astype(np.float32),
                                 "cpu")
               for shape in ((2, 24, cfg.d_inner), (2, 24, n), (2, 24, n)))
    y1, h1 = ops.selective_scan(dt, x, a.expand(2, *a.shape), b, c)
    y2, h2 = ops.selective_scan(dt, x, a_mat.expand(2, *a.shape).clone(),
                                b, c)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def _heads_inputs(rng, g, s, hn, p, n, lowp):
    """Mamba2's per-head operands: dt_h (G, S, H), x (G, S, H·P), a_h (H,),
    b, c (G, S, N)."""
    dt = np.abs(rng.normal(size=(g, s, hn)) * 0.1).astype(np.float32)
    x = rng.normal(size=(g, s, hn * p)).astype(np.float32)
    a = -(1.0 + 15.0 * rng.random(hn)).astype(np.float32)
    b = rng.normal(size=(g, s, n)).astype(np.float32)
    c = rng.normal(size=(g, s, n)).astype(np.float32)
    if lowp:   # x, B, C stored in bf16 (rounded once, on the JAX side)
        x, b, c = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16))
                   for t in (x, b, c))
    return dt, x, a, b, c


@pytest.mark.parametrize("p,n", [(32, 16), (64, 64), (32, 64), (64, 16)])
@pytest.mark.parametrize("s,chunk", [(65, 13), (100, 25)])
@pytest.mark.parametrize("lowp", [False, True])
def test_plain_heads_scan_matches_pallas(p, n, s, chunk, lowp):
    """``ops.selective_scan_heads`` on per-head operands against the JAX
    package's Pallas scan (interpret mode) on the same operands repeated
    over each head's P channels, A broadcast per head as the reference's
    docstring maps Mamba2 onto the kernel. S is no multiple of the card
    kernel's 64-step chunks; P and N are zamba2-2.7b's and its smoke
    config's widths."""
    rng = np.random.default_rng(p * 1000 + n * 10 + s + lowp)
    g, hn = 2, 3
    dt, x, a, b, c = _heads_inputs(rng, g, s, hn, p, n, lowp)
    dt_e = np.repeat(dt, p, axis=-1)
    a_e = np.broadcast_to(np.repeat(a, p)[None, :, None],
                          (g, hn * p, n)).astype(np.float32)
    y_j, h_j = jops.selective_scan(*(jnp.asarray(t) for t in
                                     (dt_e, x, a_e, b, c)),
                                   chunk=chunk, dblk=p, interpret=True)
    before = ssm_scan.selective_scan_heads.launches
    y_t, h_t = ops.selective_scan_heads(*(tensor_from_numpy(t, "cpu")
                                          for t in (dt, x, a, b, c)))
    assert ssm_scan.selective_scan_heads.launches == before
    assert y_t.dtype == h_t.dtype == torch.float32
    assert y_t.shape == (g, s, hn * p) and h_t.shape == (g, hn * p, n)
    _close(y_t.numpy(), y_j)
    _close(h_t.numpy(), h_j)


@pytest.mark.parametrize("lowp", [False, True])
def test_plain_heads_scan_gives_the_expand_routes_bits(lowp):
    """The per-head entry's plain route is the general scan on Δ and A
    repeated as ``_mamba2_scan_inputs`` repeats them: the same bits, so
    the CPU mamba2 serving route did not move."""
    cfg = TC.get_smoke_config("zamba2-2.7b")
    rng = np.random.default_rng(17)
    hn, n = cfg.ssm_heads, cfg.ssm_state
    params = {k: tensor_from_numpy(rng.normal(size=hn).astype(np.float32),
                                   "cpu") for k in ("A_log", "dt_bias")}
    dt_raw = tensor_from_numpy(
        rng.normal(size=(2, 70, hn)).astype(np.float32), "cpu")
    _, x, _, b, c = (tensor_from_numpy(t, "cpu") for t in _heads_inputs(
        rng, 2, 70, hn, cfg.mamba_headdim, n, lowp))
    dt_e, a_e = tssm._mamba2_scan_inputs(params, cfg, dt_raw)
    y1, h1 = ops.selective_scan(dt_e, x, a_e.expand(2, *a_e.shape), b, c)
    dt_h, a_h = tssm._mamba2_heads(params, dt_raw)
    y2, h2 = ops.selective_scan_heads(dt_h, x, a_h, b, c)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_meta_heads_scan_counts_the_general_scans_operations():
    """On ``meta`` tensors the per-head entry returns the shapes and
    dtypes alone and counts the general scan's 6·G·S·D·N operations under
    its name, so the dry run's rows do not move."""
    g, s, hn, p, n = 2, 4096, 80, 64, 64
    meta = {"device": "meta"}
    dt_h = torch.empty(g, s, hn, **meta)
    x = torch.empty(g, s, hn * p, dtype=torch.bfloat16, **meta)
    b = torch.empty(g, s, n, dtype=torch.bfloat16, **meta)
    with ops.counting_meta_ops() as heads:
        y, h = ops.selective_scan_heads(dt_h, x, torch.empty(hn, **meta), b,
                                        b)
    with ops.counting_meta_ops() as general:
        ops.selective_scan(torch.empty(g, s, hn * p, **meta), x,
                           torch.empty(g, hn * p, n, **meta), b, b)
    assert heads == general == {"selective_scan": 6 * g * s * hn * p * n}
    assert (y.shape, h.shape) == ((g, s, hn * p), (g, hn * p, n))
    assert y.dtype == h.dtype == torch.float32 and y.is_meta


@pytest.mark.parametrize("train,h0,route", [(False, False, "heads"),
                                            (True, False, "chunked"),
                                            (False, True, "general")])
def test_mamba2_inner_takes_the_heads_scan_when_serving(monkeypatch, train,
                                                        h0, route):
    """``mamba2_inner`` sends a serving scan from a zero state to
    ``ops.selective_scan_heads``; training takes the chunked scan and a
    start state the general scan on the repeated Δ/A, neither of them the
    per-head entry."""
    from repro_torch.models import model as TM
    cfg = TC.get_smoke_config("zamba2-2.7b")
    params = {k: v[0] for k, v in TM.init_params(cfg, 0, "cpu")[
        "blocks"].items() if torch.is_tensor(v)}
    calls = []

    def spy(name, f):
        def wrapped(*a, **kw):
            calls.append(name)
            return f(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "selective_scan_heads",
                        spy("heads", ops.selective_scan_heads))
    monkeypatch.setattr(tssm, "selective_scan_chunked",
                        spy("chunked", tssm.selective_scan_chunked))
    monkeypatch.setattr(tssm.ref, "selective_scan_ref",
                        spy("general", tssm.ref.selective_scan_ref))
    rng = np.random.default_rng(23)
    bsz, s, di, n = 2, 16, cfg.d_inner, cfg.ssm_state
    xc, z = (tensor_from_numpy(rng.normal(size=(bsz, s, di)).astype(
        np.float32), "cpu") for _ in range(2))
    b_ssm, c_ssm = (tensor_from_numpy(rng.normal(size=(bsz, s, n)).astype(
        np.float32), "cpu") for _ in range(2))
    dt_raw = tensor_from_numpy(rng.normal(size=(bsz, s, cfg.ssm_heads))
                               .astype(np.float32), "cpu")
    start = (torch.zeros(bsz, cfg.ssm_heads, cfg.mamba_headdim, n) if h0
             else None)
    out, h_final = tssm.mamba2_inner(params, cfg, xc, z, b_ssm, c_ssm,
                                     dt_raw, h0=start, return_state=True,
                                     train=train)
    assert calls[0] == route and calls.count("heads") == (route == "heads")
    assert out.shape == (bsz, s, cfg.d_model)
    assert h_final.shape == (bsz, cfg.ssm_heads, cfg.mamba_headdim, n)


def _attn_inputs(rng, b, s, hq, hkv, hd):
    q = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    return q, k, v


def _plain_flash_against_pallas(seed, b, s, hq, hkv, hd, window, blk):
    rng = np.random.default_rng(seed)
    q, k, v = _attn_inputs(rng, b, s, hq, hkv, hd)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=window,
                                interpret=True, q_blk=blk, kv_blk=blk)
    before = tfa.flash_attention.launches
    got = ops.flash_attention(*(tensor_from_numpy(t, "cpu")
                                for t in (q, k, v)), window=window)
    assert tfa.flash_attention.launches == before
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("hd", [16, 48, 64, 80, 128])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_plain_flash_matches_pallas(hq, hkv, window, hd):
    _plain_flash_against_pallas(hq * 1000 + hkv * 100 + window + hd, 2, 256,
                                hq, hkv, hd, window, 64)


@pytest.mark.parametrize("hd", [64, 80, 128])
@pytest.mark.parametrize("window", [0, 127, 128, 129])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_plain_flash_matches_pallas_at_its_128_blocks(hq, hkv, window, hd):
    """The Pallas kernel at its own 128-row blocks (``DEFAULT_BLK``, the
    tile of the card's wgmma kernel) over three of them (S = 384), with
    windows that end one key inside a block, at its edge and one past it:
    the plain version, which the card holds that kernel against, agrees
    at the new tile's edges."""
    _plain_flash_against_pallas(hq * 1000 + hkv * 100 + window + hd + 7, 1,
                                384, hq, hkv, hd, window, 128)


def test_plain_flash_bf16_output_in_q_dtype():
    rng = np.random.default_rng(11)
    q, k, v = (np.asarray(jnp.asarray(t).astype(jnp.bfloat16))
               for t in _attn_inputs(rng, 1, 128, 4, 2, 80))
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        q_blk=64, kv_blk=64), np.float32)
    got = ops.flash_attention(*(tensor_from_numpy(t, "cpu")
                                for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert np.all(diff <= 2.0 ** -8 * np.maximum(1.0, np.abs(want)))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' own wrappers take CUDA tensors only: a CPU tensor is
    refused there, and only ``ops`` routes it to the plain version."""
    x = torch.zeros(1, 8, 4, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_attention(x, x, x)
    dt = torch.zeros(1, 8, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssm_scan.selective_scan(dt, dt, torch.zeros(1, 16, 4),
                                torch.zeros(1, 8, 4), torch.zeros(1, 8, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        ssm_scan.selective_scan_heads(torch.zeros(1, 8, 2), dt,
                                      torch.zeros(2), torch.zeros(1, 8, 16),
                                      torch.zeros(1, 8, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.selective_scan_heads(torch.zeros(1, 8, 2), dt, torch.zeros(2),
                                 torch.zeros(1, 8, 16),
                                 torch.zeros(1, 8, 16), impl="kernel")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(x, x, x, impl="kernel")


@pytest.mark.parametrize("arch", JC.list_archs())
def test_every_config_head_dim_has_a_flash_instance(arch):
    """Every head dim of the repo's configs, full and smoke, is served by
    the card's flash kernel: by its own compiled instance, or zero-padded
    to the next larger one. None falls through to a refusal."""
    for cfg in (JC.get_config(arch), JC.get_smoke_config(arch)):
        if cfg.n_heads == 0:          # no attention layer (falcon-mamba)
            assert cfg.block == "mamba1"
            continue
        inst = tfa.instance_for(cfg.hd)
        assert inst in tfa.HEAD_DIMS and cfg.hd <= inst
        assert cfg.hd in tfa.HEAD_DIMS, (arch, cfg.hd)


@pytest.mark.parametrize("arch", JC.list_archs())
def test_every_full_size_head_dim_takes_the_wgmma_kernel(arch):
    """bf16 at every full-size config's head dim goes to the Hopper kernel
    (wgmma fed by TMA) at its own instance, unpadded; the smoke configs'
    small head dims run on it zero-padded to 64, and fp32 on the CUDA-core
    kernel at every config's own head dim."""
    cfg = JC.get_config(arch)
    if cfg.n_heads == 0:              # no attention layer (falcon-mamba)
        return
    assert tfa.instance_for(cfg.hd, torch.bfloat16) == cfg.hd
    assert tfa.kernel_for(torch.bfloat16) == "flash_fwd_kernel_wgmma"
    assert tfa.kernel_for(torch.float32) == "flash_fwd_kernel"
    for hd in (16, 32):
        assert tfa.instance_for(hd, torch.bfloat16) == 64
        assert tfa.instance_for(hd, torch.float32) == hd
    with pytest.raises(ValueError, match="fp32 or bf16"):
        tfa.kernel_for(torch.float16)


@pytest.mark.parametrize("hd,inst", [(1, 16), (16, 16), (17, 32), (40, 64),
                                     (48, 64), (64, 64), (72, 80), (96, 128),
                                     (128, 128)])
def test_flash_head_dims_map_to_the_next_instance(hd, inst):
    assert tfa.instance_for(hd) == inst


def test_flash_refuses_head_dims_above_its_largest_instance():
    with pytest.raises(ValueError, match="head dim 192"):
        tfa.instance_for(192)
