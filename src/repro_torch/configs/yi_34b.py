"""yi-34b — llama-arch dense GQA.
[arXiv:2403.04652] 60L, d_model=7168, 56 heads (GQA kv=8, hd=128),
d_ff=20480 SwiGLU, vocab=64000, rope_theta=5e6.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", arch_type="dense", block="dense",
        n_layers=60, d_model=7168, vocab=64000,
        n_heads=56, n_kv_heads=8, d_ff=20480, mlp_act="swiglu",
        rope_theta=5e6,
        source="arXiv:2403.04652",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="yi-34b-smoke", n_layers=2, d_model=128, vocab=256,
        n_heads=8, n_kv_heads=2, d_ff=384, dtype="float32", remat=False)


register("yi-34b", config, smoke_config)
