"""repro_torch — the PyTorch and CUDA port of the JAX package ``repro``
("CADA: Communication-Adaptive Distributed Adam", Chen, Guo, Sun, Yin, 2020),
for an NVIDIA H100.

Public API (imported lazily, so ``import repro_torch`` loads no kernels):

    repro_torch.CommRule, repro_torch.CADAEngine   # paper Algorithm 1
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "CommRule":
        from repro_torch.core.rules import CommRule
        return CommRule
    if name in ("CommStrategy", "strategy_for", "strategy_kinds",
                "register"):
        from repro_torch.core import comm
        return getattr(comm, name)
    if name == "CADAEngine":
        from repro_torch.core.engine import CADAEngine
        return CADAEngine
    raise AttributeError(name)
