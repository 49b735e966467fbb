"""The serving loop of a decoder with a per-layer pattern of mixers
(granite-4.0-h: Mamba2 beside attention, ``PatternConfig``): the closed
loop of ``bench/serve.py`` (its ``Loop``, the same window, metrics and
check sample) around the program's ``DecodeScheduler``, with the route,
the reference and the traced sub-window of the pattern:

  * the route: a round's prefill launches ``flash_attention`` once an
    attention layer and ``selective_scan_heads`` once a Mamba2 layer, and
    no other counted kernel;
  * ``correct``: at the served position of each checked request (the
    sample of ``bench/serve.py``), the served token against
    ``bench/ref_granite_h.py``'s fp32 logits (``logit_gap_max``,
    ``judge.logit_gaps``), and the program's logits themselves against
    them: ``logit_err_max``, the largest ||logits − ref|| / ||ref|| over
    the sample. The tied head over a stream that the embedding (times 12)
    dominates puts random weights' top logit far above the rest, so no
    rounding flips a served token (every gap read 0, the fp8 control's
    too: PERF.md); the logits are what tells a lower precision or a fault
    apart. The scheduler's sampler (``LogitsTap``: the default argmax)
    keeps each round's logits on the host for it;
  * ``--trace 1``: ``trace_rounds`` more rounds under
    ``bench/progtrace.py::capture``, the program's tracer handed to each
    ``run_round(trace=)``, so that its ``prefill.ssm`` / ``prefill.attn`` /
    ``prefill.mlp`` spans own the device operations they launched.

The mix's parameters are ``bench/serve.py``'s.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from bench import judge, ref_granite_h, reference, traffic, weights
from bench.cell import Record
from bench.serve import Loop, check_sample, padded_prompt, percentile

# the trace's kernel of each launch counted in a round
PER_ROUND_KERNELS = {"flash_fwd_kernel_wgmma": "flash_attention",
                     "ssm_scan_kernel_ssd": "selective_scan_heads"}


def route(model: dict) -> dict:
    """Launches of the program's kernels in one prefill round: a flash
    launch an attention layer, a per-head scan a Mamba2 layer."""
    n_attn = list(model["layer_types"]).count("attention")
    return {"flash_attention": n_attn,
            "selective_scan_heads": len(model["layer_types"]) - n_attn,
            "selective_scan": 0, "fused_amsgrad_flat": 0,
            "batched_diff_sq_norm_flat": 0, "batched_sq_norm_flat": 0,
            "diff_sq_norm_flat": 0, "eq3_row_mean_flat": 0}


class LogitsTap:
    """The scheduler's sampler: ``scheduler.greedy`` (the default, looked
    up at each call), keeping the round's last logits (B, V) on the
    host."""

    def __init__(self):
        self.last = None

    def __call__(self, logits, generator):
        from repro_torch.distributed import scheduler
        tokens = scheduler.greedy(logits, generator)
        self.last = logits.cpu()
        return tokens


def logit_errors(served: list, ref_logits: list) -> list:
    """||logits − ref|| / ||ref|| of each ``served`` (V,) against the
    reference's (V,) at its position."""
    return [float((s.float() - r).norm() / r.norm())
            for s, r in zip(served, ref_logits)]


class Traced:
    """The scheduler as ``Loop`` drives it, each round handed the
    program's tracer ``trace`` (None: off)."""

    def __init__(self, sched):
        self.sched, self.trace = sched, None

    def __getattr__(self, name):
        return getattr(self.sched, name)

    def run_round(self):
        return self.sched.run_round(trace=self.trace)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        peak: dict) -> Record:
    import torch
    from bench import progtrace
    from bench.train import check_route, launch_counts
    from repro_torch.distributed.scheduler import DecodeScheduler, Request
    from repro_torch.models.config import PatternConfig
    tr, model = cell.traffic, cell.config["model"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rec = Record(kind="serve", model=model, traffic=tr, peak=peak)
    cfg = PatternConfig(**model)
    stamps = {"imports": time.perf_counter() - t0}
    theta = weights.draw(weights.program_shapes(cfg), cell.config["init"],
                         seed, device)
    sync()
    stamps["weights"] = time.perf_counter() - t0
    rec.n_params = sum(t.numel() for t in theta.values())
    tap = LogitsTap()
    sched = Traced(DecodeScheduler(cfg, weights.unflatten(dict(theta)),
                                   n_slots=tr["n_slots"],
                                   max_seq=tr["max_seq"], sample_fn=tap))
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
    served = {}           # uid -> the program's logits at its position

    def round_(deadline: float) -> float:
        k = len(loop.done)
        end = loop.round(deadline)
        for d, row in zip(loop.done[k:], tap.last):
            served[d[0]] = row
        return end

    before = launch_counts()
    start = time.perf_counter()
    for c in range(tr["clients"]):
        loop.submit(c, start)
    end = start
    while loop.sched.queue:
        end = round_(start + seconds)
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
        before = launch_counts()

        def traced(span, tracer):
            sched.trace = tracer
            for c in range(tr["clients"]):
                loop.submit(c, time.perf_counter())
            for j in range(n):
                with span("run_round"):
                    round_(math.inf if j < n - 1 else -math.inf)
            sched.trace = None
        rec.trace = progtrace.capture(traced)
        check_route(route(model), before, launch_counts(), n)
        rec.trace.units = {"rounds": loop.rounds[window_rounds:]}
        per = route(model)
        for name, fn in PER_ROUND_KERNELS.items():
            seen = len(rec.trace.kernels(name))
            if seen != per[fn] * n:
                raise RuntimeError(f"the trace holds {seen} {name} "
                                   f"launches for {n} rounds")
    rec.notes["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated() if on_card else 0)

    sample = check_sample(rec.requests, tr["check_requests"], seed)
    checked = [(*loop.meta[uid][:3], padded, token) for uid, _, padded, _,
               token in sample]
    prog = [served[d[0]] for d in sample]
    del sched, loop, served
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference.no_tf32()
    ref = reference_logits(cell, theta, seed, checked, device)
    gaps = judge.logit_gaps([c[4] for c in checked], ref)
    errs = logit_errors(prog, ref)
    numbers = {"logit_gap_max": max(gaps), "logit_err_max": max(errs)}
    rec.notes["readings"] = {"mean_gap": sum(gaps) / len(gaps), "gaps": gaps,
                             "errs": errs, "checked": checked}
    rec.correct, rec.checks = judge.verdict(numbers, cell.limits)
    return rec


def reference_logits(cell, theta: dict, seed: int, checked: list, device,
                     variant=ref_granite_h.PLAIN) -> list:
    """The reference's logits (V,) on the host at the served position of
    each ``checked`` (client, index, length, padded, token), one prompt at
    a time; ``variant`` a control or a fault (``ref_granite_h.Variant``)."""
    import torch
    tr, model = cell.traffic, cell.config["model"]
    out = []
    for client, index, n, padded, _ in checked:
        toks = padded_prompt(tr, model["vocab"], seed, client, index, n,
                             padded, device)
        with torch.no_grad():
            out.append(ref_granite_h.last_logits(
                theta, model, toks[None], variant)[0].cpu())
    return out
