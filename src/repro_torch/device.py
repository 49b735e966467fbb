"""Where the port's tensors live.

Every entry point runs on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and asking for ``cuda`` (by default or
by name) with no CUDA device present raises instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or ``cuda`` when None, with a CUDA device's index filled
    in so it compares equal to a tensor's ``.device``; raises when CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "present; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
