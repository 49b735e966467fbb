"""Discrete-event machinery: the queue, worker/server processes, and the
participation model (a copy of the JAX package's ``sim/events.py``).

The queue is a plain time-ordered heap with a deterministic FIFO tie-break
(events at equal times pop in push order), so simulations replay exactly.
The numeric state (flat planes, strategies, the fused server optimizer)
lives in :mod:`repro_torch.sim.runtime`; this module owns only the *schedule*:

  * :class:`EventQueue` / :class:`Event` — the heap;
  * :class:`WorkerProc` — one async worker's timing state machine
    (``DOWNLOAD → COMPUTE → GATE → [UPLOAD]`` and back), tracking the
    utilization bookkeeping (busy compute seconds, bytes moved, local
    iteration count, last-upload server version);
  * :class:`ParticipationModel` — per-round worker sampling for barrier
    mode (⌈frac·M⌉ workers drawn without replacement, seeded per round).

Straggler *injection* is a compute-model concern (permanent and transient
slowdowns live on :class:`repro_torch.sim.clock.ComputeModel`); the processes
here simply experience the slowed draws.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field

import numpy as np

# async event kinds, in the order one worker cycles through them
DOWNLOAD_DONE = "download_done"   # worker received θ (and shared state)
COMPUTE_DONE = "compute_done"     # fresh (+ second) gradients ready → gate
UPLOAD_ARRIVE = "upload_arrive"   # wire reached the server → fused update


@dataclass(order=True)
class Event:
    time: float
    seq: int                      # FIFO tie-break at equal times
    kind: str = field(compare=False)
    worker: int = field(compare=False, default=-1)
    payload: dict = field(compare=False, default_factory=dict)


class EventQueue:
    """Time-ordered heap of :class:`Event` with deterministic ties."""

    def __init__(self):
        self._heap: list[Event] = []
        self._seq = itertools.count()

    def push(self, time: float, kind: str, worker: int = -1,
             **payload) -> Event:
        ev = Event(time=float(time), seq=next(self._seq), kind=kind,
                   worker=worker, payload=payload)
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


@dataclass
class WorkerProc:
    """Timing state of one async worker (the numeric row state stays with
    the runtime). ``since_upload`` is the worker's local iterations since
    it last uploaded — the sync rule's staleness counter lifted to the
    async loop (the version lag ``k_srv − upload_version`` is tracked
    separately; the τ_max cap fires on whichever is larger)."""
    worker: int
    local_iter: int = 0
    upload_version: int = 0       # server version at the last upload
    since_upload: int = 0         # local iterations since the last upload
    busy_s: float = 0.0           # compute seconds (utilization numerator)
    bytes_up: float = 0.0
    bytes_down: float = 0.0
    uploads: int = 0
    max_staleness: int = 0

    def staleness(self, k_srv: int) -> int:
        """Effective staleness: local rounds since upload, or server
        versions since upload — whichever is larger."""
        return max(self.since_upload, k_srv - self.upload_version)


class ParticipationModel:
    """Barrier-mode partial participation: each round, ⌈frac·M⌉ workers
    are drawn without replacement (at least one). Draws are keyed on
    ``(seed, round)``, so the schedule is independent of anything the
    trajectory does."""

    def __init__(self, m: int, frac: float = 1.0, seed: int = 0):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"participation frac must be in (0, 1], "
                             f"got {frac}")
        self.m = m
        self.frac = float(frac)
        self.seed = seed
        self.k_active = max(1, int(np.ceil(frac * m)))

    @property
    def full(self) -> bool:
        return self.k_active == self.m

    def mask(self, round_idx: int) -> np.ndarray:
        """(M,) bool participation mask for one round."""
        if self.full:
            return np.ones((self.m,), bool)
        rng = np.random.default_rng((self.seed, round_idx))
        mask = np.zeros((self.m,), bool)
        mask[rng.choice(self.m, self.k_active, replace=False)] = True
        return mask

    def masks(self, steps: int) -> np.ndarray:
        """(steps, M) bool matrix of per-round masks."""
        return np.stack([self.mask(k) for k in range(steps)])
