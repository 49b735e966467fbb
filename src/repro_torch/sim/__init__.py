"""Discrete-event heterogeneous-cluster simulation: CADA in wall-clock, on
the port's engine and kernels (the JAX package's ``sim``).

``clock`` and ``events`` are numpy-only copies of the reference's modules;
``runtime`` drives :class:`repro_torch.core.engine.CADAEngine` and the
strategies' flat hooks on the card (``device="cpu"`` on the CPU); ``report``
summarizes a run. Simulated seconds are computed by the clock models, not
measured.
"""
from repro_torch.sim.clock import (ComputeModel, LinkModel, NetworkProfile,
                                   PROFILES, network_profile)
from repro_torch.sim.events import EventQueue, ParticipationModel
from repro_torch.sim.report import summarize, time_to_target
from repro_torch.sim.runtime import (MODES, SimConfig, SimResult, SimRuntime,
                                     simulate)

__all__ = [
    "ComputeModel", "LinkModel", "NetworkProfile", "PROFILES",
    "network_profile", "EventQueue", "ParticipationModel", "summarize",
    "time_to_target", "MODES", "SimConfig", "SimResult", "SimRuntime",
    "simulate",
]
