"""granite-4.0-h-micro — 36 Mamba2 layers beside 4 GQA attention layers,
an MLP after every mixer.
[huggingface.co/ibm-granite/granite-4.0-h-micro, config.json,
model_type granitemoehybrid] 40 layers (attention at 5, 15, 25, 35),
d_model=2048, vocab=100352, tied embeddings; Mamba2: 64 heads of 64
(d_inner 4096), d_state 128, one group, conv 4 with a bias over
[x, B, C]; attention: 32 query heads on 8 K/V heads of 64, no rotary
(NoPE), softmax scale 0.015625; SwiGLU 8192; μP multipliers: embedding
12, residual 0.22, logits / 8.

A port-only configuration (``models/config.py::PatternConfig``): the JAX
package has no such model, so it lives in the registry's port-only table
(``configs.base.register(..., port_only=True)``), outside ``list_archs``.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import (LAYER_ATTENTION, LAYER_MAMBA2,
                                       PatternConfig)

ATTENTION_AT = (5, 15, 25, 35)


def layer_types(n_layers: int, attention_at) -> tuple:
    return tuple(LAYER_ATTENTION if i in attention_at else LAYER_MAMBA2
                 for i in range(n_layers))


def config() -> PatternConfig:
    return PatternConfig(
        name="granite-4.0-h-micro", arch_type="hybrid", block="mamba2",
        n_layers=40, d_model=2048, vocab=100352,
        layer_types=layer_types(40, ATTENTION_AT),
        n_heads=32, n_kv_heads=8, head_dim=64, attn_scale=0.015625,
        ssm_state=128, ssm_conv=4, ssm_expand=2, mamba_headdim=64,
        d_ff=8192, mlp_act="swiglu",
        embedding_multiplier=12.0, residual_multiplier=0.22,
        logits_scaling=8.0,
        tie_embeddings=True, norm_eps=1e-5,
        source=("https://huggingface.co/ibm-granite/granite-4.0-h-micro/"
                "blob/main/config.json"),
    )


def smoke_config() -> PatternConfig:
    """Both layer kinds at smoke widths: one Mamba2 layer, then one
    attention layer."""
    return config().with_(
        name="granite-h-smoke", n_layers=2, d_model=128, vocab=256,
        layer_types=layer_types(2, (1,)),
        n_heads=4, n_kv_heads=2, head_dim=32, attn_scale=1 / 32,
        ssm_state=16, mamba_headdim=32, d_ff=256,
        dtype="float32", remat=False)


register("granite-4.0-h-micro", config, smoke_config, port_only=True)
