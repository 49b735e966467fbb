from repro_torch.optim.base import Optimizer, apply_updates
from repro_torch.optim.fused import FusedAMSGrad, FusedState
from repro_torch.optim import schedules

__all__ = ["Optimizer", "apply_updates", "FusedAMSGrad", "FusedState",
           "schedules"]
