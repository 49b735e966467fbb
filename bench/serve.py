"""The serving loop: a closed loop of clients through the program's
``distributed/scheduler.py::DecodeScheduler``, each client sending its
next prompt as soon as its last one is answered.

Set-up draws the weights on the card and builds the scheduler; it warms
up with one round of each of the cycle's rounds (``traffic.rounds``), on
prompts of their own. The window then submits every client's first
request and runs ``run_round`` while the window is open; a round's
requests are answered when it returns (their first token is on the host),
and each answered client sends its next prompt, unless the window has
closed. ``prefill_tokens_per_s`` is the prompt tokens (without padding)
of every request answered in the window over the window's time, from its
start to the end of its last round; ``ttft_ms_p95`` the 95th percentile
(nearest rank) of every answered request's time from its submission to
its answer. With ``--trace 1`` a traced sub-window of ``trace_rounds``
more rounds follows.

The mix's parameters: ``clients``, ``n_slots`` and ``max_seq`` of the
scheduler, ``max_new`` tokens a request, prompt lengths log-uniform on
[``min_len``, ``max_len``] in cycles of ``cycle`` (``bench/traffic.py``),
``zipf_a`` of the prompts' tokens, ``check_requests`` answers compared
with the reference (``judge.py``).
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from bench import judge, reference, traffic, weights
from bench.cell import Record

# the trace's kernel of each launch counted in a round
PER_ROUND_KERNELS = {"flash_fwd_kernel_wgmma": "flash_attention"}


def route(model: dict) -> dict:
    """Launches of the program's kernels in one prefill round of a dense
    decoder: a flash launch a layer, nothing else."""
    return {"flash_attention": model["n_layers"],
            "selective_scan_heads": 0, "selective_scan": 0,
            "fused_amsgrad_flat": 0, "batched_diff_sq_norm_flat": 0,
            "batched_sq_norm_flat": 0, "diff_sq_norm_flat": 0,
            "eq3_row_mean_flat": 0}


class Loop:
    """The closed loop's clients around one scheduler."""

    def __init__(self, cell, seed: int, sched, request_cls):
        self.tr, self.seed, self.sched = cell.traffic, seed, sched
        self.vocab = cell.config["model"]["vocab"]
        self.Request = request_cls
        self.lengths = traffic.client_lengths(self.tr, seed, 100_000)
        self.sent = [0] * self.tr["clients"]
        self.meta = {}            # uid -> (client, index, length, t_submit)
        self.done = []            # (uid, length, padded, ttft_s, token)
        self.rounds = []          # (slots, padded, [lengths])

    def submit(self, client: int, now: float) -> None:
        i = self.sent[client]
        n = self.lengths[client][i]
        prompt = traffic.prompt_tokens(self.tr, self.vocab, self.seed,
                                       client, i, n).astype(np.int32)
        uid = len(self.meta)
        self.meta[uid] = (client, i, n, now)
        self.sched.submit(self.Request(uid=uid, prompt=prompt,
                                       max_new=self.tr["max_new"]))
        self.sent[client] += 1

    def round(self, deadline: float) -> float:
        """One round; its answered clients send again if it ended before
        ``deadline``."""
        reqs = self.sched.run_round()
        now = time.perf_counter()
        padded = max(len(r.prompt) for r in reqs)
        self.rounds.append((self.sched.n_slots, padded,
                            [len(r.prompt) for r in reqs]))
        for r in reqs:
            client, _, n, t_sub = self.meta[r.uid]
            token = r.out[0] if len(r.out) == self.tr["max_new"] else None
            self.done.append((r.uid, n, padded, now - t_sub, token))
            if now < deadline:
                self.submit(client, now)
        return now


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-quantile of ``values``."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        peak: dict) -> Record:
    import torch
    from bench import devtrace
    from bench.train import check_route, launch_counts
    from repro_torch.distributed.scheduler import DecodeScheduler, Request
    from repro_torch.models.config import ModelConfig
    tr, model = cell.traffic, cell.config["model"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rec = Record(kind="serve", model=model, traffic=tr, peak=peak)
    cfg = ModelConfig(**model)
    stamps = {"imports": time.perf_counter() - t0}
    theta = weights.draw(weights.program_shapes(cfg), cell.config["init"],
                         seed, device)
    sync()
    stamps["weights"] = time.perf_counter() - t0
    rec.n_params = sum(t.numel() for t in theta.values())
    sched = DecodeScheduler(cfg, weights.unflatten(dict(theta)),
                            n_slots=tr["n_slots"], max_seq=tr["max_seq"])
    warm = np.random.default_rng([int(seed), 9])
    for group in traffic.rounds(tr):
        for n in group:
            prompt = traffic.zipf_tokens(warm, (n,), cfg.vocab)
            sched.submit(Request(uid=-1, prompt=prompt.astype(np.int32),
                                 max_new=tr["max_new"]))
        sched.run_round()
    sched.finished.clear()
    sync()
    rec.setup_s = time.perf_counter() - t0
    stamps["warm_up"] = rec.setup_s
    rec.notes["setup"] = stamps

    loop = Loop(cell, seed, sched, Request)
    before = launch_counts()
    start = time.perf_counter()
    for c in range(tr["clients"]):
        loop.submit(c, start)
    end = start
    while loop.sched.queue:
        end = loop.round(start + seconds)
    rec.window_s = end - start
    if on_card:     # the plain versions off the card count nothing
        check_route(route(model), before, launch_counts(),
                    len(loop.rounds))
    rec.rounds = list(loop.rounds)
    rec.requests = list(loop.done)
    rec.attempted = len(loop.meta)
    rec.failed = rec.attempted - sum(d[4] is not None for d in loop.done)
    answered = [d for d in loop.done if d[4] is not None]
    rec.end_to_end = {
        "prefill_tokens_per_s": sum(d[1] for d in answered) / rec.window_s,
        "ttft_ms_p95": 1e3 * percentile([d[3] for d in answered], 0.95),
        "setup_s": rec.setup_s}

    if trace:
        n = tr["trace_rounds"]
        window_rounds = len(loop.rounds)
        for c in range(tr["clients"]):
            loop.submit(c, time.perf_counter())
        before = launch_counts()

        def traced(span):
            for j in range(n):
                with span("run_round"):
                    loop.round(math.inf if j < n - 1 else -math.inf)
        rec.trace = devtrace.capture(traced)
        check_route(route(model), before, launch_counts(), n)
        rec.trace.units = {"rounds": loop.rounds[window_rounds:]}
        per = route(model)
        for name, fn in PER_ROUND_KERNELS.items():
            seen = len(rec.trace.kernels(name))
            if seen != per[fn] * n:
                raise devtrace.EmptyTrace(
                    f"the trace holds {seen} {name} launches for {n} rounds")
    rec.notes["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated() if on_card else 0)

    checked = [(*loop.meta[uid][:3], padded, token) for uid, _, padded, _,
               token in check_sample(rec.requests, tr["check_requests"], seed)]
    del sched, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference.no_tf32()
    ref = reference_logits(cell, theta, seed, checked, device, reference.FP32)
    gaps = judge.logit_gaps([c[4] for c in checked], ref)
    numbers = {"logit_gap_max": max(gaps)}
    rec.notes["readings"] = {"mean_gap": sum(gaps) / len(gaps), "gaps": gaps,
                             "checked": checked}
    rec.correct, rec.checks = judge.verdict(numbers, cell.limits)
    return rec


def reference_logits(cell, theta: dict, seed: int, checked: list, device,
                     num) -> list:
    """The reference's logits (V,) on the host at the served position of
    each ``checked`` (client, index, length, padded, token), one prompt at
    a time."""
    import torch
    tr, model = cell.traffic, cell.config["model"]
    out = []
    for client, index, n, padded, _ in checked:
        toks = padded_prompt(tr, model["vocab"], seed, client, index, n,
                             padded, device)
        with torch.no_grad():
            out.append(reference.dense_last_logits(
                theta, model, toks[None], num)[0].cpu())
    return out


def check_sample(done: list, k: int, seed: int) -> list:
    """The answered requests compared: the one with the longest padded
    prompt, and ``k − 1`` more drawn from the seed."""
    answered = [d for d in done if d[4] is not None]
    longest = max(range(len(answered)), key=lambda j: answered[j][2])
    rest = [j for j in range(len(answered)) if j != longest]
    rng = np.random.default_rng([int(seed), 5])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [answered[longest]] + [answered[rest[j]] for j in sorted(pick)]


def padded_prompt(tr: dict, vocab: int, seed: int, client: int, index: int,
                  n: int, padded: int, device):
    """The prompt as its round served it: right-padded with its last
    token to the round's longest, as the scheduler pads (module
    docstring of ``distributed/scheduler.py``)."""
    import torch
    p = traffic.prompt_tokens(tr, vocab, seed, client, index, n)
    p = np.concatenate([p, np.full(padded - n, p[-1], dtype=p.dtype)])
    return torch.from_numpy(p).to(device)
