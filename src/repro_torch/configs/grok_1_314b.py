"""grok-1-314b — 314B MoE, 8 experts top-2.
[hf:xai-org/grok-1] 64L, d_model=6144, 48 heads (GQA kv=8, hd=128),
d_ff=32768 per expert, vocab=131072, gated-GeLU experts.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", arch_type="moe", block="moe",
        n_layers=64, d_model=6144, vocab=131072,
        n_heads=48, n_kv_heads=8, d_ff=32768,
        n_experts=8, top_k=2, mlp_act="geglu",
        rope_theta=1e4,
        source="hf:xai-org/grok-1",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="grok-1-smoke", n_layers=2, d_model=128, vocab=256,
        n_heads=4, n_kv_heads=2, d_ff=256, n_experts=4, top_k=2,
        dtype="float32", remat=False)


register("grok-1-314b", config, smoke_config)
