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
