"""M-RoPE, the stub frontends and the embedding-input models of the port
against the JAX package.

``mrope_angles`` mirrors ``tests/test_attention.py::test_mrope_sections``;
``mrope_positions`` and the configs' ``mrope_sections_`` are held to the
reference's; qwen2-vl-2b (M-RoPE, GQA, tied embeddings) and
musicgen-medium (MHA, gelu) at their smoke configs (fp32) take the same
numpy embeddings (and, for qwen2-vl, the (3, B, S) positions of a text
prefix and a 4 x 4 image) on both sides, the reference's own parameters
converted: forward logits, prefill (last logits and the K/V cache) and 8
decode steps fed zero embeddings, as the reference's launcher feeds them.

Tolerances:
  * ``mrope_positions``: exact (integer arithmetic), and so is
    ``mrope_sections_``.
  * ``mrope_angles``: inside the port, exact: each section is the plain
    RoPE table of its own axis, and equal t/h/w positions give the plain
    RoPE table bit for bit. Against the reference, cos and sin within
    ANGLE_ATOL = 2⁻²³ (one fp32 ULP at 1): the angles are the same
    products, but the frequencies' power and the cosine itself round
    differently in XLA and in PyTorch's CPU math (measured: one frequency
    of 64 differs by 1 ULP, and cos by up to half an ULP at 1).
  * The models: every float array within 1e-5 of its own scale, the
    decoded argmax tokens equal (the band of ``tests/test_torch_lm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import attention as jattn
from repro.models import frontends as jfront
from repro.models import model as JM
import repro_torch.configs as TC
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import frontends as tfront
from repro_torch.models import model as TM

torch.set_num_threads(1)

ANGLE_ATOL = 2.0 ** -23
RTOL = 1e-5
B, S, DECODE_STEPS = 2, 24, 8
GRID = (4, 4)


def _close(got, want, what):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: max |Δ| {err} > {RTOL} · {scale}"


def test_mrope_sections():
    """The reference's test: (3, 1, 8) equal positions give (1, 8, 16)
    tables equal to plain RoPE's (here bit for bit)."""
    pos = torch.arange(8, dtype=torch.int32)[None, None].expand(3, 1, 8)
    cos, sin = tattn.mrope_angles(pos, 32, 1e4, (4, 6, 6))
    assert cos.shape == (1, 8, 16)
    cos2, sin2 = tattn.rope_angles(torch.arange(8)[None], 32, 1e4)
    assert torch.equal(cos, cos2) and torch.equal(sin, sin2)


@pytest.mark.parametrize("dim,sections", [(32, (4, 6, 6)),
                                          (128, (16, 24, 24))])
def test_mrope_sections_take_their_axis(dim, sections):
    """Section j of the table is axis j's plain RoPE table there."""
    pos = tfront.mrope_positions(2, 300, (16, 16), device="cpu")
    cos, sin = tattn.mrope_angles(pos, dim, 1e6, sections)
    start = 0
    for axis, sec in enumerate(sections):
        c, s = tattn.rope_angles(pos[axis], dim, 1e6)
        assert torch.equal(cos[..., start:start + sec],
                           c[..., start:start + sec])
        assert torch.equal(sin[..., start:start + sec],
                           s[..., start:start + sec])
        start += sec


@pytest.mark.parametrize("dim,theta,sections", [(32, 1e4, (4, 6, 6)),
                                                (128, 1e6, (16, 24, 24))])
def test_mrope_angles_match_reference(dim, theta, sections):
    pos = np.array(jfront.mrope_positions(2, 300, (16, 16)))
    jc, js = jattn.mrope_angles(jnp.asarray(pos), dim, theta, sections)
    tc, ts = tattn.mrope_angles(torch.from_numpy(pos), dim, theta, sections)
    assert tuple(tc.shape) == jc.shape == (2, 300, dim // 2)
    assert float(np.abs(tc.numpy() - np.asarray(jc)).max()) <= ANGLE_ATOL
    assert float(np.abs(ts.numpy() - np.asarray(js)).max()) <= ANGLE_ATOL
    with pytest.raises(ValueError, match="sections"):
        tattn.mrope_angles(torch.from_numpy(pos), dim, theta, (1, 2, 3))


@pytest.mark.parametrize("batch,seq,grid", [(2, 300, (16, 16)),
                                            (1, 100, (16, 16)),
                                            (3, 24, (4, 4)), (2, 16, (4, 4)),
                                            (1, 2048, (16, 16))])
def test_mrope_positions_match_reference(batch, seq, grid):
    want = np.asarray(jfront.mrope_positions(batch, seq, grid))
    got = tfront.mrope_positions(batch, seq, grid, device="cpu")
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)


def test_mrope_sections_scale_as_the_reference():
    for arch in TC.list_archs():
        for get in ("get_config", "get_smoke_config"):
            j, t = getattr(JC, get)(arch), getattr(TC, get)(arch)
            assert t.mrope_sections_ == j.mrope_sections_, arch
    assert TC.get_smoke_config("qwen2-vl-2b").mrope_sections_ == (4, 6, 6)


def test_stub_frontends_are_drawn_from_their_generator():
    cfg = TC.get_smoke_config("qwen2-vl-2b")
    draws = [f(cfg, torch.Generator().manual_seed(3), 2, 5)
             for f in (tfront.vision_embeds, tfront.vision_embeds,
                       tfront.audio_embeds)]
    assert draws[0].shape == (2, 5, cfg.d_model)
    assert draws[0].dtype == cfg.torch_dtype
    assert torch.equal(draws[0], draws[1]) and torch.equal(draws[0],
                                                           draws[2])
    bf16 = cfg.with_(dtype="bfloat16")
    assert tfront.audio_embeds(bf16, torch.Generator(), 1, 2).dtype == \
        torch.bfloat16


def _setup(arch):
    jcfg = JC.get_smoke_config(arch).with_(remat=False)
    tcfg = TC.get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    embeds = np.random.default_rng(7).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = (np.array(jfront.mrope_positions(B, S, GRID)) if jcfg.mrope
           else None)
    return jcfg, tcfg, jp, tp, embeds, pos


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "musicgen-medium"])
def test_embedding_input_model_matches_reference(arch):
    jcfg, tcfg, jp, tp, embeds, pos = _setup(arch)
    assert not tcfg.embed_input
    je, te = jnp.asarray(embeds), torch.from_numpy(embeds)
    jpos = None if pos is None else jnp.asarray(pos)
    tpos = None if pos is None else torch.from_numpy(pos)

    j_logits, _ = JM.forward(jcfg, jp, embeds=je, positions=jpos)
    t_logits, aux = TM.forward(tcfg, tp, embeds=te, positions=tpos)
    assert float(aux) == 0.0
    _close(t_logits, j_logits, "forward logits")
    j_last, j_cache = JM.prefill(jcfg, jp, embeds=je, positions=jpos,
                                 max_seq=S + DECODE_STEPS)
    t_last, t_cache = TM.prefill(tcfg, tp, embeds=te, positions=tpos,
                                 max_seq=S + DECODE_STEPS)
    _close(t_last, j_last, "prefill logits")
    _close(t_cache.k, j_cache.k, "cache.k")
    _close(t_cache.v, j_cache.v, "cache.v")
    assert np.array_equal(t_cache.slot_pos.numpy(), j_cache.slot_pos)

    zero_j = jnp.zeros((B, 1, jcfg.d_model), jnp.float32)
    zero_t = torch.zeros((B, 1, tcfg.d_model))
    for step in range(DECODE_STEPS):
        j_last, j_cache = JM.decode_step(jcfg, jp, j_cache, embeds=zero_j)
        t_last, t_cache = TM.decode_step(tcfg, tp, t_cache, embeds=zero_t)
        _close(t_last, j_last, f"decode step {step} logits")
        assert np.array_equal(np.asarray(jnp.argmax(j_last, -1)),
                              torch.argmax(t_last, -1).numpy()), step
    _close(t_cache.k, j_cache.k, "cache.k after decode")
    assert t_cache.index == int(j_cache.index) == S + DECODE_STEPS


def test_mrope_positions_change_the_model_as_in_the_reference():
    """The image plan's positions move qwen2-vl's logits away from the
    default positions', on both sides alike."""
    jcfg, tcfg, jp, tp, embeds, pos = _setup("qwen2-vl-2b")
    j_plan, _ = JM.forward(jcfg, jp, embeds=jnp.asarray(embeds),
                           positions=jnp.asarray(pos))
    j_plain, _ = JM.forward(jcfg, jp, embeds=jnp.asarray(embeds))
    t_plain, _ = TM.forward(tcfg, tp, embeds=torch.from_numpy(embeds))
    _close(t_plain, j_plain, "forward logits, default positions")
    assert float(np.abs(np.asarray(j_plan) - np.asarray(j_plain)).max()) \
        > 10 * RTOL * float(np.abs(np.asarray(j_plain)).max())


@pytest.mark.parametrize("arch,extra", [
    ("qwen2-vl-2b", ["--image-grid", "4,4"]), ("qwen2-vl-2b", []),
    ("musicgen-medium", []), ("granite-moe-1b-a400m", []),
    ("grok-1-314b", ["--temperature", "0.8"])])
def test_serve_smoke_on_cpu(capsys, arch, extra):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--tokens", "4"]
                     + extra)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill(2x20) on cpu: ")
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["cache"].index == 24
    assert bool(torch.isfinite(out["logits"]).all())


def test_serve_refuses_an_image_grid_without_mrope():
    with pytest.raises(SystemExit, match="M-RoPE"):
        serve.main(["--arch", "musicgen-medium", "--smoke", "--device",
                    "cpu", "--image-grid", "4,4"])
