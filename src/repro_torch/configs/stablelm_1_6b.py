"""stablelm-1.6b — dense MHA LM with partial rotary embeddings.
[hf:stabilityai/stablelm-2-1_6b] 24L, d_model=2048, 32 heads (MHA, hd=64),
d_ff=5632 SwiGLU, vocab=100352, rotary_pct=0.25.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", arch_type="dense", block="dense",
        n_layers=24, d_model=2048, vocab=100352,
        n_heads=32, n_kv_heads=32, d_ff=5632, mlp_act="swiglu",
        rope_theta=1e4, rotary_pct=0.25,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="stablelm-smoke", n_layers=2, d_model=128, vocab=256,
        n_heads=4, n_kv_heads=4, d_ff=256, dtype="float32", remat=False)


register("stablelm-1.6b", config, smoke_config)
