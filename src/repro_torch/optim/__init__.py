from repro_torch.optim.adam import AdamState, adam, amsgrad
from repro_torch.optim.base import (Optimizer, apply_updates,
                                    chain_weight_decay)
from repro_torch.optim.fused import FusedAMSGrad, FusedState, as_optimizer
from repro_torch.optim.sgd import MomentumState, momentum, sgd
from repro_torch.optim import schedules

__all__ = ["Optimizer", "apply_updates", "chain_weight_decay",
           "FusedAMSGrad", "FusedState", "as_optimizer",
           "AdamState", "adam", "amsgrad", "MomentumState", "momentum",
           "sgd", "schedules"]
