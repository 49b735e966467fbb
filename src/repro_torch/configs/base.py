"""The architecture registry (the port's copy of the registry part of the
JAX package's ``configs/base.py``; its input shapes and spec builders come
with the dry-run tools)."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

_REGISTRY: dict[str, dict] = {}


def register(name: str, config_fn, smoke_fn):
    _REGISTRY[name] = {"config": config_fn, "smoke": smoke_fn}


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[name]["config"]()


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    cfg = _REGISTRY[name]["smoke"]()
    if cfg.n_layers > 2 or cfg.d_model > 512 or cfg.n_experts > 4:
        raise ValueError(f"{cfg.name} is not a smoke-sized config")
    return cfg


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
