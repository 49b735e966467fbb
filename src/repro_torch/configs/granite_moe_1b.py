"""granite-moe-1b-a400m — fine-grained MoE, 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L, d_model=1024, 16 heads
(GQA kv=8, hd=64), d_ff=512 per expert, vocab=49155, SwiGLU experts.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", arch_type="moe", block="moe",
        n_layers=24, d_model=1024, vocab=49155,
        n_heads=16, n_kv_heads=8, d_ff=512,
        n_experts=32, top_k=8, mlp_act="swiglu",
        rope_theta=1e4, tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="granite-moe-smoke", n_layers=2, d_model=128, vocab=256,
        n_heads=4, n_kv_heads=2, d_ff=64, n_experts=4, top_k=2,
        dtype="float32", remat=False)


register("granite-moe-1b-a400m", config, smoke_config)
