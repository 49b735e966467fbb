"""Architecture registry of the port: the three language models it serves
so far. Importing this package registers every config."""
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    falcon_mamba_7b, internlm2_1_8b, zamba2_2_7b,
)
from repro_torch.configs.base import get_config, get_smoke_config, list_archs

__all__ = ["get_config", "get_smoke_config", "list_archs"]
