"""qwen2-vl-2b — VLM decoder backbone with M-RoPE.
[arXiv:2409.12191] 28L, d_model=1536, 12 heads (GQA kv=2, hd=128),
d_ff=8960 SwiGLU, vocab=151936, M-RoPE sections (16,24,24), dynamic
resolution. The ViT+projector frontend is a stub: ``models/frontends.py``
draws the patch/text embeddings (B, S, d) and the (3, B, S) t/h/w
positions.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", arch_type="vlm", block="dense",
        n_layers=28, d_model=1536, vocab=151936,
        n_heads=12, n_kv_heads=2, d_ff=8960, mlp_act="swiglu",
        rope_theta=1e6, mrope=True, mrope_sections=(16, 24, 24),
        embed_input=False, tie_embeddings=True,
        source="arXiv:2409.12191",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="qwen2-vl-smoke", n_layers=2, d_model=128, vocab=256,
        n_heads=4, n_kv_heads=2, d_ff=256, dtype="float32", remat=False)


register("qwen2-vl-2b", config, smoke_config)
