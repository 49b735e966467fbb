"""Architecture registry of the port: the ten language models of the JAX
package's registry. Importing this package registers every config."""
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    falcon_mamba_7b, granite_moe_1b, grok_1_314b, internlm2_1_8b,
    llama3_405b, musicgen_medium, qwen2_vl_2b, stablelm_1_6b, yi_34b,
    zamba2_2_7b,
)
from repro_torch.configs.base import get_config, get_smoke_config, list_archs

__all__ = ["get_config", "get_smoke_config", "list_archs"]
