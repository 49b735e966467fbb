"""internlm2-1.8b — dense GQA LM.
[arXiv:2403.17297] 24L, d_model=2048, 16 heads (GQA kv=8, hd=128),
d_ff=8192 SwiGLU, vocab=92544.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", arch_type="dense", block="dense",
        n_layers=24, d_model=2048, vocab=92544,
        n_heads=16, n_kv_heads=8, d_ff=8192, mlp_act="swiglu",
        rope_theta=1e6,
        source="arXiv:2403.17297",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="internlm2-smoke", n_layers=2, d_model=128, vocab=256,
        n_heads=4, n_kv_heads=2, d_ff=256, dtype="float32", remat=False)


register("internlm2-1.8b", config, smoke_config)
