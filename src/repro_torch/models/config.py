"""Model configuration shared by the language-model architectures.

One frozen dataclass covers dense/GQA, MoE, Mamba1, Mamba2+shared-attention
hybrid, M-RoPE VLM and audio decoders; the per-arch files in
``repro_torch.configs`` instantiate it with the published numbers. The
port's copy of the JAX package's ``models/config.py``: ``torch_dtype``
takes the place of ``jnp_dtype``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

BLOCK_DENSE = "dense"
BLOCK_MOE = "moe"
BLOCK_MAMBA1 = "mamba1"
BLOCK_MAMBA2 = "mamba2"

ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # one of ARCH_TYPES (reporting only)
    block: str                # dense | moe | mamba1 | mamba2
    n_layers: int
    d_model: int
    vocab: int
    # attention (ignored by pure-SSM blocks)
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0         # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    rotary_pct: float = 1.0
    mrope: bool = False       # qwen2-vl M-RoPE (t/h/w sections)
    mrope_sections: tuple = (16, 24, 24)   # halves of head_dim/2 per axis
    # MLP
    d_ff: int = 0
    mlp_act: str = "swiglu"   # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coeff: float = 0.01
    moe_local_dispatch: bool = False
    # SSM (mamba1/mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0          # 0 -> d_model // 16   (mamba1)
    mamba_headdim: int = 64   # mamba2
    # hybrid: a single SHARED attention+MLP block applied every `attn_every`
    # SSM layers (zamba2-style). 0 disables.
    attn_every: int = 0
    # inference
    sliding_window: int = 0   # 0 = full attention; >0 = ring-buffer KV cache
    # embedding / IO
    embed_input: bool = True  # False: consumes precomputed embeddings
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True        # the reference's activation checkpointing
    source: str = ""          # paper / model-card citation

    # ------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.mamba_headdim

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def has_attention(self) -> bool:
        return self.block in ("dense", "moe") or self.attn_every > 0

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def validate(self) -> None:
        """Raises ValueError on an inconsistent configuration."""
        def need(cond, what):
            if not cond:
                raise ValueError(f"{self.name}: {what}")
        need(self.arch_type in ARCH_TYPES, f"arch_type {self.arch_type!r}")
        need(self.block in (BLOCK_DENSE, BLOCK_MOE, BLOCK_MAMBA1,
                            BLOCK_MAMBA2), f"block {self.block!r}")
        if self.block in (BLOCK_DENSE, BLOCK_MOE):
            need(self.n_heads > 0 and self.n_kv_heads > 0, "attention heads")
            need(self.n_heads % self.n_kv_heads == 0,
                 "n_heads a multiple of n_kv_heads")
        if self.block == BLOCK_MOE:
            need(0 < self.top_k <= self.n_experts, "0 < top_k <= n_experts")
        if self.block in (BLOCK_MAMBA1, BLOCK_MAMBA2):
            need(self.ssm_state > 0, "ssm_state > 0")
        if self.block == BLOCK_MAMBA2:
            need(self.d_inner % self.mamba_headdim == 0,
                 "d_inner a multiple of mamba_headdim")
        if self.attn_every:
            need(self.n_layers % self.attn_every == 0,
                 "n_layers a multiple of attn_every")
            need(self.n_heads > 0, "attention heads")


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (for 6ND model-FLOPs and memory napkin
    math; held against the real init in the tests)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    n = V * d  # embedding
    if not cfg.tie_embeddings:
        n += d * V  # lm head
    n += d  # final norm

    def attn_params():
        return (d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
                + cfg.n_heads * cfg.hd * d)

    def mlp_params(ff):
        mult = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
        return mult * d * ff

    if cfg.block == "dense":
        per = attn_params() + mlp_params(cfg.d_ff) + 2 * d
        n += L * per
    elif cfg.block == "moe":
        per = (attn_params() + d * cfg.n_experts
               + cfg.n_experts * mlp_params(cfg.d_ff) + 2 * d)
        n += L * per
    elif cfg.block == "mamba1":
        di, N, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
        per = (d * 2 * di + cfg.ssm_conv * di + di            # in_proj, conv
               + di * (r + 2 * N) + r * di + di               # x_proj, dt
               + di * N + di + di * d + d)                    # A, D, out, ln
        n += L * per
    elif cfg.block == "mamba2":
        di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per = (d * (2 * di + 2 * N + H) + cfg.ssm_conv * di + di
               + 3 * H + di + di * d + d)          # dt_bias/A/D, norm, out
        n += L * per
    if cfg.attn_every:
        n += attn_params() + mlp_params(cfg.d_ff) + 2 * d    # one shared block
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) params — MoE counts top_k experts only."""
    if cfg.block != "moe":
        return param_count(cfg)
    dense_like = param_count(cfg.with_(block="dense"))
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    extra = cfg.n_layers * (cfg.d_model * cfg.n_experts              # router
                            + (cfg.top_k - 1) * mult * cfg.d_model * cfg.d_ff)
    return dense_like + extra
