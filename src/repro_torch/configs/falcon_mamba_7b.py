"""falcon-mamba-7b — pure Mamba1 (attention-free) 7B LM.
[arXiv:2410.05355] Falcon Mamba: 64L, d_model=4096, d_inner=8192 (expand 2),
ssm_state=16, conv 4, dt_rank=d_model/16=256, vocab=65024.
"""
from repro_torch.configs.base import register
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", arch_type="ssm", block="mamba1",
        n_layers=64, d_model=4096, vocab=65024,
        ssm_state=16, ssm_conv=4, ssm_expand=2, dt_rank=256,
        tie_embeddings=True,
        source="arXiv:2410.05355",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        name="falcon-mamba-smoke", n_layers=2, d_model=128, vocab=256,
        dt_rank=8, ssm_state=8, dtype="float32", remat=False)


register("falcon-mamba-7b", config, smoke_config)
