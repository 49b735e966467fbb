"""Continuous-batching decode scheduler (the serving substrate; the port of
the JAX package's ``distributed/scheduler.py``).

A fixed-size slot pool over one decode step. Scheduling is round-based, as
in the reference: a round takes up to ``n_slots`` requests from the queue,
right-pads their prompts with each prompt's last token, prefills the batch
once at the fixed ``max_seq``, then decodes greedily until every request
of the round is done or has produced ``max_new`` tokens; ``eos_id`` stops
a request early. New requests fill the slots only between rounds: per-step
refill would need per-slot positions in ``decode_step``, which neither
package has.

Slot state lives on the host (the requests' outputs, the active mask);
the device holds the slotted ``DecodeCache``. On the card a round's
prefill runs the scan and flash kernels (``models/model.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, prefill
from repro_torch.utils.trees import tree_leaves


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (len,) int32 token ids
    max_new: int = 32
    eos_id: int | None = None
    out: list = field(default_factory=list)
    done: bool = False


def greedy(logits, generator):
    """The default sampler: the argmax of each row."""
    del generator
    return torch.argmax(logits, dim=-1)


class DecodeScheduler:
    """Fixed-slot continuous batching over a single model, one round at a
    time. The device is the parameters'. ``sample_fn(logits, generator)``
    draws the next tokens (B,) from the last logits (B, V) with an explicit
    ``torch.Generator`` (the reference takes a PRNG key); the default is
    the argmax."""

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 max_seq: int = 256, sample_fn: Callable | None = None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._sample = sample_fn or greedy
        self.device = tree_leaves(params)[0].device

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # ------------------------------------------------------------- rounds
    def _next_batch(self) -> list[Request]:
        batch = self.queue[:self.n_slots]
        self.queue = self.queue[self.n_slots:]
        return batch

    def padded_tokens(self, batch: list[Request]) -> np.ndarray:
        """(n_slots, longest prompt) int32: each prompt right-padded with
        its last token, the empty slots all zeros, as the reference pads."""
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((self.n_slots, plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, :len(r.prompt)] = r.prompt
            toks[i, len(r.prompt):] = r.prompt[-1] if len(r.prompt) else 0
        return toks

    def run_round(self, generator: torch.Generator | None = None
                  ) -> list[Request]:
        """Serve one round: fill all slots, decode until every request in
        the round finishes (or hits max_new). Returns the round's
        requests."""
        batch = self._next_batch()
        if not batch:
            return []
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        toks = torch.as_tensor(self.padded_tokens(batch), dtype=torch.long,
                               device=self.device)
        logits, cache = prefill(self.cfg, self.params, tokens=toks,
                                max_seq=self.max_seq)

        active = np.array([True] * len(batch)
                          + [False] * (self.n_slots - len(batch)))
        remaining = np.array([r.max_new for r in batch]
                             + [0] * (self.n_slots - len(batch)))
        nxt = self._sample(logits, generator)
        steps = 0
        while active.any() and steps < max(r.max_new for r in batch):
            nxt_np = nxt.cpu().numpy()
            for i, r in enumerate(batch):
                if active[i]:
                    r.out.append(int(nxt_np[i]))
                    remaining[i] -= 1
                    if remaining[i] <= 0 or (r.eos_id is not None
                                             and nxt_np[i] == r.eos_id):
                        active[i] = False
                        r.done = True
            if not active.any():
                break
            logits, cache = decode_step(self.cfg, self.params, cache,
                                        tokens=nxt)
            nxt = self._sample(logits, generator)
            steps += 1
        for r in batch:
            r.done = True
            self.finished.append(r)
        return batch

    def run(self, generator: torch.Generator | None = None
            ) -> list[Request]:
        """Drain the whole queue. Every round starts from the generator's
        state at the call, as the reference hands every round one key."""
        start = None if generator is None else generator.get_state()
        while self.queue:
            if start is not None:
                generator.set_state(start)
            self.run_round(generator)
        return self.finished

    # ------------------------------------------------------------ metrics
    def utilization(self) -> float:
        """Fraction of decode-slot-steps that produced a kept token."""
        if not self.finished:
            return 0.0
        produced = sum(len(r.out) for r in self.finished)
        rounds = int(np.ceil(len(self.finished) / self.n_slots))
        worst = rounds * self.n_slots * max(
            (len(r.out) for r in self.finished), default=1)
        return produced / max(worst, 1)
