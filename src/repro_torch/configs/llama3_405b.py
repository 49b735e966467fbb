"""llama3-405b — frontier-scale dense GQA.
[arXiv:2407.21783] 126L, d_model=16384, 128 heads (GQA kv=8, hd=128),
d_ff=53248 SwiGLU, vocab=128256, rope_theta=5e5.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", arch_type="dense", block="dense",
        n_layers=126, d_model=16384, vocab=128256,
        n_heads=128, n_kv_heads=8, d_ff=53248, mlp_act="swiglu",
        rope_theta=5e5,
        source="arXiv:2407.21783",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="llama3-smoke", n_layers=2, d_model=256, vocab=512,
        n_heads=8, n_kv_heads=2, d_ff=512, dtype="float32", remat=False)


register("llama3-405b", config, smoke_config)
