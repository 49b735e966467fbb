"""musicgen-medium — decoder-only LM over EnCodec audio tokens.
[arXiv:2306.05284] 48L, d_model=1536, 24 heads (MHA, hd=64), d_ff=6144
GeLU, codebook vocab=2048. The EnCodec/conditioning frontend is a stub:
``models/frontends.py`` draws the frame embeddings (B, S, d).
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", arch_type="audio", block="dense",
        n_layers=48, d_model=1536, vocab=2048,
        n_heads=24, n_kv_heads=24, d_ff=6144, mlp_act="gelu",
        rope_theta=1e4, embed_input=False,
        source="arXiv:2306.05284",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="musicgen-smoke", n_layers=2, d_model=128, vocab=256,
        n_heads=4, n_kv_heads=4, d_ff=256, dtype="float32", remat=False)


register("musicgen-medium", config, smoke_config)
