"""Modality frontend stubs: the port of the JAX package's
``models/frontends.py``.

qwen2-vl's ViT and musicgen's EnCodec are not implemented; the frontends
provide precomputed patch/frame embeddings of the right shape, random but
drawn from an explicit ``torch.Generator`` (on its device), and the
M-RoPE position ids of a (text, image-grid) plan, integer arithmetic equal
to the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def vision_embeds(cfg: ModelConfig, generator: torch.Generator, batch: int,
                  seq: int):
    """Stub ViT+projector output: (B, S, d) patch+text embedding stream,
    standard normal in fp32, then the model dtype."""
    return torch.randn((batch, seq, cfg.d_model), generator=generator,
                       dtype=torch.float32,
                       device=generator.device).to(cfg.torch_dtype)


def audio_embeds(cfg: ModelConfig, generator: torch.Generator, batch: int,
                 seq: int):
    """Stub EnCodec frame embeddings (sum over codebooks): (B, S, d)."""
    return torch.randn((batch, seq, cfg.d_model), generator=generator,
                       dtype=torch.float32,
                       device=generator.device).to(cfg.torch_dtype)


def mrope_positions(batch: int, seq: int, image_grid: tuple = (16, 16),
                    device=None):
    """(3, B, S) int32 t/h/w positions on ``device`` (None: the card): a
    text prefix followed by an image whose patches advance h/w but share t
    (the Qwen2-VL dynamic-resolution plan)."""
    device = resolve_device(device)
    gh, gw = image_grid
    n_img = gh * gw
    n_txt = max(seq - n_img, 0)
    n_fit = min(n_img, seq)
    t_txt = torch.arange(n_txt, device=device)
    img_t = torch.full((n_fit,), n_txt, device=device)
    h_img = torch.arange(gh, device=device).repeat_interleave(gw)[:n_fit]
    w_img = torch.arange(gw, device=device).repeat(gh)[:n_fit]
    t = torch.cat([t_txt, img_t])[:seq]
    h = torch.cat([t_txt, h_img + n_txt])[:seq]
    w = torch.cat([t_txt, w_img + n_txt])[:seq]
    pos = torch.stack([t, h, w])                             # (3, S)
    return pos[:, None, :].expand(3, batch, seq).to(torch.int32).contiguous()
