"""zamba2-2.7b — Mamba2 backbone + one SHARED attention block.
[arXiv:2411.15242] 54 Mamba2 layers, d_model=2560, d_inner=5120,
ssm_state=64, mamba head_dim=64 (80 SSM heads); a single shared
attention+MLP block (32 heads, MHA) applied every 6 SSM layers;
d_ff=10240, vocab=32000.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", arch_type="hybrid", block="mamba2",
        n_layers=54, d_model=2560, vocab=32000,
        ssm_state=64, ssm_conv=4, ssm_expand=2, mamba_headdim=64,
        attn_every=6, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, mlp_act="swiglu",
        tie_embeddings=True,
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="zamba2-smoke", n_layers=2, d_model=128, vocab=256,
        ssm_state=16, mamba_headdim=32, attn_every=2,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
        dtype="float32", remat=False)


register("zamba2-2.7b", config, smoke_config)
