"""Event-driven heterogeneous-cluster runtimes: Algorithm 1 in wall-clock
(the JAX package's ``sim/runtime.py`` on the port's engine and kernels).

Two runtimes lift the engine's lock-step rounds onto simulated time:

  * **barrier** (synchronous): the numerics ARE the engine's own rounds,
    ``CADAEngine.run`` with an optional per-round participation mask, and
    the discrete-event layer prices each round afterwards: every
    participating worker downloads θ^k, computes its
    ``grad_evals_per_iter`` gradient evaluations, uploads if its rule
    fired, and the server closes the round when the LAST participant
    finishes (a straggler stalls everyone). Under the ``zero`` profile with
    full participation the run calls ``CADAEngine.run`` exactly as a plain
    engine run does, so masks, staleness, losses and params are the
    engine's bit for bit, for every rule kind.

  * **async** (bounded staleness): workers free-run: download θ, compute,
    gate with the UNMODIFIED strategy hooks of :mod:`repro_torch.core.comm`
    against their own row of the (M, n_flat) plane, and upload when the
    rule fires or their staleness reaches τ_max. The server applies the
    fused AMSGrad step (``FusedAMSGrad.apply_flat``, the kernel on the
    card) the moment each upload arrives. Staleness is the larger of the
    worker's local iterations since its last upload and the server
    versions since then; τ_max defaults to the rule's ``max_delay``.

The link models price bytes by each strategy's ``bytes_per_upload``, so
compressed wires (laq 8-bit, topk sparse) are faster, not just cheaper in
rounds; the downlink broadcast of θ is charged dense (``4n`` bytes by
default) every download. Transfers are priced at the bandwidth in effect
when they start (``now=`` on the link calls).

Federated scale rides the cohort plane: ``cohort_size > 0`` (barrier)
samples C workers a round through the host
:class:`repro_torch.core.flat.WorkerPool` and the engine's pipelined cohort
rounds, so the device holds O(C·n) worker rows, and ``host_pool=True``
(async) streams single worker rows from the same pool instead of holding
the (M, n_flat) plane on the device.

Everything runs on the engine's device: the card unless ``device="cpu"``
is given, and no card raises. Simulated seconds are computed by the clock
models, never measured. The host reads device values at fixed points: a
barrier run fetches its metrics once (cohort rounds every
``metrics_every`` rounds), an async gate once per gate (its loss, upload
bit and gate margin), which orders the event loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.core.comm import STRATEGIES, adapt_period
from repro_torch.core.engine import CADAEngine, sample_cohorts
from repro_torch.core.rules import CommRule
from repro_torch.obs.metrics import CommLedger
from repro_torch.obs.trace import as_tracer
from repro_torch.optim.fused import FusedAMSGrad
from repro_torch.sim.clock import NetworkProfile, network_profile
from repro_torch.sim.events import (COMPUTE_DONE, DOWNLOAD_DONE,
                                    UPLOAD_ARRIVE, EventQueue,
                                    ParticipationModel, WorkerProc)
from repro_torch.utils.trees import tree_map, tree_size

MODES = ("barrier", "async")

# async host_pool: most deferred-writeback rows parked on the device at
# once. Past the cap the OLDEST parked row is flushed, so the async device
# overhead is a constant number of (P, 1, n_flat) rows however large M
# gets, never the O(M·n) plane the pool exists to avoid.
ASYNC_PENDING_CAP = 4


@dataclass(frozen=True)
class SimConfig:
    """What to simulate: the network scenario and the runtime mode."""
    network: NetworkProfile
    mode: str = "barrier"
    async_tau: int = 0            # staleness cap τ_max (0 → rule.max_delay)
    participation: float = 1.0    # barrier mode: fraction of workers/round
    server_update_s: float = 0.0  # simulated cost of the fused Adam step
    download_bytes: float | None = None   # None → dense fp32 θ (4·n bytes)
    async_lr_scale: float | None = None   # None → 1/M: the Adam step fires
    #                               per ARRIVAL, so M arrivals ≈ one sync
    #                               round; unscaled, async runs at an
    #                               effective M× learning rate
    cohort_size: int = 0          # barrier mode: > 0 runs the FEDERATED
    #                               cohort plane (C sampled workers a round
    #                               through the host WorkerPool, O(C·n)
    #                               device state, rounds priced over cohort
    #                               members only)
    host_pool: bool = False       # async mode: per-worker rows (grads +
    #                               pooled extras) live in a host
    #                               WorkerPool instead of an (M, n_flat)
    #                               device plane
    pipeline: bool = True         # cohort rounds: pipelined copies
    #                               (False = the serial parity oracle)
    metrics_every: int = 8        # cohort rounds: fetch device metrics
    #                               every K rounds instead of per round
    pool_storage: str = "ram"     # "memmap" puts the WorkerPool's O(M·n)
    #                               planes in files under pool_path
    pool_path: str | None = None
    seed: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, "
                             f"got {self.mode!r}")
        if self.async_tau < 0:
            raise ValueError("async_tau must be >= 0")
        if self.cohort_size < 0:
            raise ValueError("cohort_size must be >= 0")
        if self.cohort_size and self.mode != "barrier":
            raise ValueError("cohort_size is a barrier-mode knob (async "
                             "workers free-run; use host_pool to bound "
                             "async device state instead)")
        if self.host_pool and self.mode != "async":
            raise ValueError("host_pool is an async-mode knob (barrier "
                             "federated runs get the pool via cohort_size)")
        if self.cohort_size and self.participation != 1.0:
            raise ValueError("cohort_size and participation are two ways "
                             "to sample the same thing — set one")
        if self.mode == "async" and self.participation != 1.0:
            raise ValueError(
                "participation sampling is a barrier-mode knob (async "
                "workers free-run; model slow/absent workers with the "
                "ComputeModel's straggler injection instead)")
        if self.metrics_every < 1:
            raise ValueError("metrics_every must be >= 1")
        if self.pool_storage not in ("ram", "memmap"):
            raise ValueError('pool_storage must be "ram" or "memmap", '
                             f"got {self.pool_storage!r}")
        if self.pool_storage == "memmap" and self.pool_path is None:
            raise ValueError('pool_storage="memmap" needs pool_path=')
        if self.pool_storage == "memmap" and not (self.cohort_size
                                                  or self.host_pool):
            raise ValueError("pool_storage is a WorkerPool knob — set "
                             "cohort_size (barrier) or host_pool (async)")


@dataclass
class SimResult:
    """One simulated run. ``loss_times``/``losses`` are the wall-clock loss
    series (barrier: per round; async: per worker gate); ``times`` are the
    server-update completion times. Every time is simulated seconds. The
    arrays are host numpy; ``final_params`` stays on the engine's
    device."""
    mode: str
    profile: str
    steps: int                     # server updates completed
    wall_s: float
    times: np.ndarray              # (steps,) server-update times
    loss_times: np.ndarray
    losses: np.ndarray
    uploads: int
    grad_evals: int
    bytes_up: float
    bytes_down: float
    utilization: np.ndarray        # (M,) compute-busy fraction of wall
    max_staleness: int
    final_params: Any
    upload_masks: np.ndarray | None = None    # barrier: (steps, M)
    staleness: np.ndarray | None = None       # barrier: (steps, M)
    participation_masks: np.ndarray | None = None  # barrier: (steps, M)
    metrics: dict = field(default_factory=dict)  # barrier: engine metrics
    ledger: dict | None = None     # obs.metrics.CommLedger.summary()


def _leaf(batch) -> torch.Tensor:
    """The first tensor of a batch (an (x, y) tuple, a dict or a tensor)."""
    if isinstance(batch, dict):
        return _leaf(next(iter(batch.values())))
    if isinstance(batch, (tuple, list)):
        return _leaf(batch[0])
    return batch


def _host(mets: dict) -> dict:
    """A run's stacked device metrics -> host numpy, one copy per key."""
    return {k: v.cpu().numpy() for k, v in mets.items()}


class SimRuntime:
    """Simulate Algorithm 1 under a :class:`SimConfig`.

    The engine's numerics are reused wholesale: barrier mode IS
    ``CADAEngine.run`` (plus participation); async mode drives the same
    strategy flat hooks one worker row at a time and the same fused AMSGrad
    kernel on the server. ``impl`` is the engine's dispatch override of
    ``kernels/ops.py`` (None on the main path); ``device`` None means the
    card.
    """

    def __init__(self, loss_fn, rule: CommRule, n_workers: int,
                 config: SimConfig, *, lr: float = 0.01, optimizer=None,
                 impl=None, device=None, trace=None):
        self.cfg = config
        self.m = n_workers
        self.rule = rule
        # obs.trace.Tracer or None: every simulated download/compute/
        # upload/gate/server-apply becomes a span on the SIMULATED clock,
        # one track per worker plus a "server" track
        self.tracer = as_tracer(trace)
        if STRATEGIES[rule.kind].delta_payload:
            # delta-payload rules PRESCRIBE their server optimizer (the
            # engine takes strategy.server_optimizer() on None); the sim's
            # FusedAMSGrad default would silently override it
            if config.mode == "async":
                raise ValueError(
                    "async mode gates one fresh gradient per local "
                    "iteration; delta-payload rules (local_momentum / "
                    "fedadam — local steps between uploads) are "
                    "barrier-only")
            if rule.adapt_local_steps and config.cohort_size:
                raise ValueError(
                    "adapt_local_steps is not supported on the cohort "
                    "plane yet — run adaptive H dense, or fixed "
                    "local_steps cohort-virtualized")
        elif optimizer is None:
            optimizer = FusedAMSGrad(lr=lr)
        # the sim IS the clock adapt_local_steps needs: it opts in (the
        # bare engine refuses such a rule)
        self.engine = CADAEngine(
            loss_fn, optimizer, rule, n_workers, impl=impl, device=device,
            allow_adaptive_local_steps=True)
        if config.mode == "async" and not self.engine._fused_opt:
            raise ValueError("async mode applies the fused flat-plane Adam "
                             "update server-side; pass a FusedAMSGrad")

    # ------------------------------------------------------------- shared
    def _byte_costs(self, n: int) -> tuple[float, float]:
        up = self.engine.strategy.bytes_per_upload(n)
        down = (4.0 * n if self.cfg.download_bytes is None
                else float(self.cfg.download_bytes))
        return up, down

    def _new_ledger(self) -> CommLedger:
        return CommLedger.for_strategy(self.engine.strategy)

    def _observe_ring(self, led: CommLedger, extras: dict) -> None:
        """Fold stale-ring occupancy (cada2's slot map) into the ledger."""
        if "slot" in extras and "ring_version" in extras:
            led.observe_ring(extras["slot"].cpu().numpy(),
                             capacity=int(extras["ring_version"].shape[0]))

    def _on_device(self, batches):
        """Array batches on the engine's device (a no-op where they are)."""
        return F.batch_map(
            lambda x: torch.as_tensor(x).to(self.engine.device), batches)

    def run(self, params, batches, rounds: int | None = None) -> SimResult:
        """Simulate over pre-sampled batches with leading axis
        (steps, M, ...). Barrier mode runs exactly ``steps`` rounds; async
        mode runs until the server has applied ``steps`` updates (batches
        are cycled per worker as needed).

        Federated cohort mode (``cohort_size > 0``) also accepts a
        CALLABLE ``batches(round_idx, cohort) -> (C, b, ...)`` leaves: at
        M = 10⁴ a dense (steps, M, b, ...) batch plane is itself the memory
        wall, so the sampler makes one cohort's rows at a time. ``rounds``
        is required with a callable (arrays carry their own step
        count)."""
        if self.cfg.mode == "barrier":
            if self.cfg.cohort_size:
                return self._run_barrier_cohort(params, batches, rounds)
            return self._run_barrier(params, self._on_device(batches))
        return self._run_async(params, self._on_device(batches))

    # ------------------------------------------------------------ barrier
    def _run_barrier(self, params, batches) -> SimResult:
        eng, cfg = self.engine, self.cfg
        if eng.strategy.delta_payload:
            return self._run_barrier_delta(params, batches)
        compute, link = cfg.network.compute, cfg.network.link
        steps = F.batch_lead(batches)
        part = ParticipationModel(self.m, cfg.participation, cfg.seed)

        st = eng.init(params)
        if part.full:
            # no participation argument at all: the plain engine's calls,
            # the degenerate-parity anchor
            pmasks = np.ones((steps, self.m), bool)
            fst, mets = eng.run(st, batches)
        else:
            pmasks = part.masks(steps)
            fst, mets = eng.run(st, batches,
                                torch.as_tensor(pmasks, device=eng.device))
        mets = _host(mets)

        masks = mets["upload_mask"]                      # (steps, M)
        staleness = mets["staleness"]
        losses = np.asarray(mets["loss"], np.float64)
        up_bytes, down_bytes = self._byte_costs(
            eng._layout.n if eng.fused else tree_size(params))
        evals = eng.strategy.grad_evals_per_iter

        tr = self.tracer
        t = 0.0
        t_end = np.zeros(steps)
        busy = np.zeros(self.m)
        bytes_up = bytes_down = 0.0
        for k in range(steps):
            finish = t
            for w in range(self.m):
                if not pmasks[k, w]:
                    continue
                dt_down = link.down_time(w, down_bytes, now=t)
                dt_comp = compute.iter_time(w, k, t + dt_down, evals)
                dt_up = (link.up_time(w, up_bytes,
                                      now=t + dt_down + dt_comp)
                         if masks[k, w] else 0.0)
                busy[w] += dt_comp
                bytes_down += down_bytes
                if masks[k, w]:
                    bytes_up += up_bytes
                if tr:
                    trk = f"worker {w}"
                    tr.add_span("download", t, dt_down, track=trk,
                                cat="transfer")
                    tr.add_span("compute", t + dt_down, dt_comp,
                                track=trk, cat="compute")
                    tr.instant("gate", t + dt_down + dt_comp, track=trk,
                               args={"round": k,
                                     "upload": bool(masks[k, w]),
                                     "staleness": int(staleness[k, w])})
                    if masks[k, w]:
                        tr.add_span("upload", t + dt_down + dt_comp,
                                    dt_up, track=trk, cat="transfer")
                finish = max(finish, t + dt_down + dt_comp + dt_up)
            if tr:
                tr.add_span("round", t, finish + cfg.server_update_s - t,
                            track="server",
                            args={"round": k,
                                  "uploads": int(masks[k].sum())})
            t = finish + cfg.server_update_s
            t_end[k] = t

        led = self._new_ledger()
        led.observe_run(mets, participation=pmasks)
        led.add_bytes_down(bytes_down)
        self._observe_ring(led, fst.comm.extras)
        wall = float(t)
        return SimResult(
            mode="barrier", profile=cfg.network.name, steps=steps,
            wall_s=wall, times=t_end, loss_times=t_end, losses=losses,
            uploads=int(masks.sum()),
            grad_evals=int(mets["grad_evals"].sum()),
            bytes_up=bytes_up, bytes_down=bytes_down,
            utilization=busy / wall if wall > 0 else np.zeros(self.m),
            max_staleness=int(staleness.max()),
            final_params=fst.params,
            upload_masks=masks, staleness=staleness,
            participation_masks=pmasks, metrics=mets,
            ledger=led.summary())

    # ------------------------------------------ barrier, delta payloads
    def _run_barrier_delta(self, params, batches) -> SimResult:
        """Barrier rounds of the delta-payload (local-steps) rules.

        Batches carry a local axis, (rounds, H, M, b, ...), or the plain
        (rounds, M, b, ...) form at H = 1. Delta rules always upload, so
        the wall-clock schedule does not depend on the trajectory: each
        round's per-worker local-step counts H_m and every link and
        compute time are computed on the host in one pass BEFORE the
        numeric run, then (adaptive H) handed to the engine as a
        (rounds, M) int32 schedule that runs each worker's first H_m local
        steps.

        Adaptation is avp's period rule turned from "skip uploads" to
        "take local steps": a worker whose comm time (download + upload)
        exceeded its compute time for the round grows H by one, else
        shrinks, clipped to [local_steps_min, min(local_steps_max, the
        batch's H)] by :func:`repro_torch.core.comm.adapt_period`. Offline
        rounds freeze a worker's H. A round is priced as
        ``compute.round_time(w, k * h_pad, ·, H_m, evals)``: H_m successive
        local-iteration draws, rounds spaced by the batch's H so draws
        never collide across rounds."""
        eng, cfg, rule = self.engine, self.cfg, self.rule
        compute, link = cfg.network.compute, cfg.network.link
        leaves = _leaf(batches)
        has_h = rule.local_steps > 1 or rule.adapt_local_steps
        steps = leaves.shape[0]
        h_pad = leaves.shape[1] if has_h else 1
        adaptive = rule.adapt_local_steps
        h_min = rule.local_steps_min
        h_cap = (min(rule.resolved_local_steps_max, h_pad) if adaptive
                 else min(rule.local_steps, h_pad))
        if adaptive and h_pad < h_min:
            raise ValueError(
                f"adaptive local steps need batches with at least "
                f"local_steps_min={h_min} local iterations per round; "
                f"got H axis {h_pad}")
        part = ParticipationModel(self.m, cfg.participation, cfg.seed)
        pmasks = (np.ones((steps, self.m), bool) if part.full
                  else part.masks(steps))

        st = eng.init(params)
        up_bytes, down_bytes = self._byte_costs(
            eng._layout.n if eng.fused else tree_size(params))
        evals = eng.strategy.grad_evals_per_iter

        tr = self.tracer
        h = np.full(self.m, min(max(rule.local_steps, h_min), h_cap)
                    if adaptive else h_cap, np.int64)
        hsched = np.zeros((steps, self.m), np.int64)
        t = 0.0
        t_end = np.zeros(steps)
        busy = np.zeros(self.m)
        bytes_up = bytes_down = 0.0
        comm_s = np.zeros(self.m)
        comp_s = np.zeros(self.m)
        for k in range(steps):
            hsched[k] = h
            finish = t
            for w in range(self.m):
                if not pmasks[k, w]:
                    continue
                dt_down = link.down_time(w, down_bytes, now=t)
                dt_comp = compute.round_time(w, k * h_pad, t + dt_down,
                                             int(h[w]), evals)
                dt_up = link.up_time(w, up_bytes,
                                     now=t + dt_down + dt_comp)
                busy[w] += dt_comp
                bytes_down += down_bytes
                bytes_up += up_bytes
                comm_s[w] = dt_down + dt_up
                comp_s[w] = dt_comp
                if tr:
                    trk = f"worker {w}"
                    tr.add_span("download", t, dt_down, track=trk,
                                cat="transfer")
                    tr.add_span("compute", t + dt_down, dt_comp,
                                track=trk, cat="compute",
                                args={"round": k, "local_steps": int(h[w])})
                    tr.add_span("upload", t + dt_down + dt_comp, dt_up,
                                track=trk, cat="transfer")
                finish = max(finish, t + dt_down + dt_comp + dt_up)
            if tr:
                tr.add_span("round", t, finish + cfg.server_update_s - t,
                            track="server",
                            args={"round": k,
                                  "uploads": int(pmasks[k].sum())})
            if adaptive:
                h = np.where(
                    pmasks[k],
                    adapt_period(torch.from_numpy(h),
                                 torch.from_numpy(comm_s > comp_s),
                                 h_min, h_cap).numpy(),
                    h)
            t = finish + cfg.server_update_s
            t_end[k] = t

        part_arg = (None if part.full
                    else torch.as_tensor(pmasks, device=eng.device))
        hs_arg = (torch.as_tensor(hsched, dtype=torch.int32,
                                  device=eng.device) if adaptive else None)
        fst, mets = eng.run(st, batches, part_arg, hs_arg)
        mets = _host(mets)

        masks = mets["upload_mask"]                      # (steps, M)
        staleness = mets["staleness"]
        losses = np.asarray(mets["loss"], np.float64)
        led = self._new_ledger()
        led.observe_run(mets, participation=pmasks)
        led.add_bytes_down(bytes_down)
        self._observe_ring(led, fst.comm.extras)
        wall = float(t)
        return SimResult(
            mode="barrier", profile=cfg.network.name, steps=steps,
            wall_s=wall, times=t_end, loss_times=t_end, losses=losses,
            uploads=int(masks.sum()),
            grad_evals=int(mets["grad_evals"].sum()),
            bytes_up=bytes_up, bytes_down=bytes_down,
            utilization=busy / wall if wall > 0 else np.zeros(self.m),
            max_staleness=int(staleness.max()),
            final_params=fst.params,
            upload_masks=masks, staleness=staleness,
            participation_masks=pmasks,
            metrics={**mets, "local_steps": hsched},
            ledger=led.summary())

    # -------------------------------------------- barrier, federated cohort
    def _run_barrier_cohort(self, params, batches,
                            rounds: int | None = None) -> SimResult:
        """Federated barrier rounds on the cohort plane.

        Each round a fresh C-worker cohort (seeded as
        :class:`ParticipationModel` draws: independent per round) runs one
        cohort round through the engine's pipelined ``run_cohort``
        (``cfg.pipeline``, ``cfg.metrics_every``): the device holds O(C·n)
        worker rows whatever M is. The round is priced over COHORT MEMBERS
        ONLY (the
        others are idle: no download, no compute, no upload). The numerics
        run FIRST; the pricing loop then replays the fetched host metrics,
        and never feeds back, so the split is exact."""
        eng, cfg = self.engine, self.cfg
        compute, link = cfg.network.compute, cfg.network.link
        c = cfg.cohort_size
        if c > self.m:
            raise ValueError(f"cohort_size {c} > n_workers {self.m}")
        if callable(batches):
            if not rounds:
                raise ValueError("a callable batch sampler needs rounds=")
            steps = int(rounds)
        else:
            batches = self._on_device(batches)
            steps = F.batch_lead(batches)
        cohorts = sample_cohorts(self.m, c, steps, seed=cfg.seed)

        st, pool = eng.init_cohort(params, pool_storage=cfg.pool_storage,
                                   pool_path=cfg.pool_path)
        up_bytes, down_bytes = self._byte_costs(eng._layout.n)
        evals = eng.strategy.grad_evals_per_iter
        # delta-payload rules run a fixed H local steps a round on the
        # cohort plane; gradient rules price one iteration (h = 1 makes
        # round_time iter_time bit for bit)
        h_static = (self.rule.local_steps if eng.strategy.delta_payload
                    else 1)
        has_h = eng.strategy.delta_payload and self.rule.local_steps > 1

        if callable(batches):
            batch_fn = batches
        else:
            # the cohort indexes the batch on the batch's device
            cohorts_dev = torch.as_tensor(cohorts, dtype=torch.long,
                                          device=_leaf(batches).device)

            def batch_fn(k, _cohort):
                idx = cohorts_dev[k]
                return F.batch_map((lambda x: x[k][:, idx]) if has_h
                                   else (lambda x: x[k][idx]), batches)

        # numerics first, through the pipelined run_cohort
        st, all_mets = eng.run_cohort(st, pool, batch_fn, cohorts,
                                      pipeline=cfg.pipeline,
                                      metrics_every=cfg.metrics_every)

        # the wall-clock pricing replays the host metrics
        tr = self.tracer
        led = self._new_ledger()
        t = 0.0
        t_end = np.zeros(steps)
        busy = np.zeros(self.m)
        bytes_up = bytes_down = 0.0
        masks = np.zeros((steps, c), bool)
        stal = np.zeros((steps, c), np.int64)
        losses = np.zeros(steps, np.float64)
        grad_evals = 0
        max_stale = 0
        for k in range(steps):
            cohort = cohorts[k]
            mets = all_mets[k]
            masks[k] = mets["upload_mask"]
            stal[k] = mets["staleness"]
            losses[k] = float(mets["loss"])
            grad_evals += int(mets["grad_evals"])
            max_stale = max(max_stale, int(mets["max_staleness"]))
            led.observe_round(mets)
            finish = t
            for j, w in enumerate(int(x) for x in cohort):
                dt_down = link.down_time(w, down_bytes, now=t)
                dt_comp = compute.round_time(w, k * h_static, t + dt_down,
                                             h_static, evals)
                dt_up = (link.up_time(w, up_bytes,
                                      now=t + dt_down + dt_comp)
                         if masks[k, j] else 0.0)
                busy[w] += dt_comp
                bytes_down += down_bytes
                if masks[k, j]:
                    bytes_up += up_bytes
                if tr:
                    trk = f"worker {w}"
                    tr.add_span("download", t, dt_down, track=trk,
                                cat="transfer")
                    tr.add_span("compute", t + dt_down, dt_comp,
                                track=trk, cat="compute",
                                args={"round": k})
                    tr.instant("gate", t + dt_down + dt_comp, track=trk,
                               args={"round": k,
                                     "upload": bool(masks[k, j]),
                                     "staleness": int(stal[k, j])})
                    if masks[k, j]:
                        tr.add_span("upload", t + dt_down + dt_comp,
                                    dt_up, track=trk, cat="transfer")
                finish = max(finish, t + dt_down + dt_comp + dt_up)
            if tr:
                tr.add_span("round", t, finish + cfg.server_update_s - t,
                            track="server",
                            args={"round": k, "cohort_size": c,
                                  "uploads": int(masks[k].sum())})
            t = finish + cfg.server_update_s
            t_end[k] = t

        led.add_bytes_down(bytes_down)
        led.observe_pool(pool)
        self._observe_ring(led, st.server.extras)
        wall = float(t)
        return SimResult(
            mode="barrier", profile=cfg.network.name, steps=steps,
            wall_s=wall, times=t_end, loss_times=t_end, losses=losses,
            uploads=int(masks.sum()), grad_evals=grad_evals,
            bytes_up=bytes_up, bytes_down=bytes_down,
            utilization=busy / wall if wall > 0 else np.zeros(self.m),
            max_staleness=max_stale,
            final_params=st.params,
            upload_masks=masks, staleness=stal,
            metrics={"cohorts": cohorts,
                     "host_pool_bytes": pool.nbytes,
                     "host_pool_mapped_bytes": pool.mapped_nbytes,
                     "host_pool_resident_bytes": pool.resident_nbytes,
                     "pipeline": cfg.pipeline,
                     "device_worker_plane_bytes": pool.device_row_bytes(c)},
            ledger=led.summary())

    # -------------------------------------------------------------- async
    def _slice_extras(self, extras: dict, w: int, stale_point=None) -> dict:
        """Worker w's one-row view of the flat extras.

        Three families: ``async_shared_extras`` pass through whole (CADA1's
        snapshot); ``async_indexed_extras`` (the stale-iterate RING) are
        REPLACED by a one-row ring built from ``stale_point``, the worker's
        own θ^{k−τ_m} that :meth:`_run_async` tracks on the host (the
        bounded server ring assumes the synchronous schedule and cannot
        hold per-worker async staleness); everything else is sliced on
        its leading (M,) axis (views: the gate reads them and returns new
        rows)."""
        strat = self.engine.strategy
        shared, indexed = strat.async_shared_extras, strat.async_indexed_extras
        row = {key: (val if key in shared
                     else tree_map(lambda x: x[w:w + 1], val))
               for key, val in extras.items() if key not in indexed}
        if indexed:
            row.update(strat.async_indexed_row(stale_point))
        return row

    def _merge_extras(self, extras: dict, row: dict, w: int) -> dict:
        """Write worker w's gate-updated extras row back. Shared extras
        pass through; INDEXED (ring) keys are skipped: the server's ring is
        dead state in async mode (each gate sees a fresh one-row ring; the
        real stale points live in :meth:`_run_async`'s host list).

        The (M,)-leading entries are written IN PLACE: the async loop owns
        them, a gate reads only its row's views and returns new tensors,
        and the server's apply passes them through untouched, so nothing
        else holds their old rows (an (M, n_flat) copy per gate would
        double the plane at an LM's width)."""
        strat = self.engine.strategy
        shared, indexed = strat.async_shared_extras, strat.async_indexed_extras

        def put(full, r):
            full[w] = r[0]
            return full

        return {key: (val if key in shared or key in indexed
                      else tree_map(put, val, row[key]))
                for key, val in extras.items()}

    def _build_gate(self, tau: int):
        """The per-worker gate: the fresh (and second) gradient
        evaluation, the strategy's LHS against the server's RHS, the wire
        and the worker row's transition: ``flat.flat_comm_round``'s lines
        7-14 on one (1, n_flat) row."""
        eng = self.engine
        strategy, layout, rule = eng.strategy, eng._layout, self.rule

        def gate(wparams, batch1, wg_row, stale1, diff_hist, extras_row):
            # the shared dispatch: on the one-row view the ring gather is
            # the per-worker evaluation
            losses, fresh, second = F.eval_two_point(
                strategy, layout, extras_row, wparams, batch1, 1,
                vgrad=eng._vgrad, vgrad_per=eng._vgrad_per,
                fuse_evals=False)
            comm_row = F.FlatCommState(
                nabla=torch.zeros_like(wg_row[0]), worker_grads=wg_row,
                staleness=stale1, diff_hist=diff_hist, extras=extras_row)
            ctx = F.FlatCommContext(
                layout=layout, params=wparams, fresh=fresh, second=second,
                comm=comm_row, step=0, m=1, impl=eng._impl)
            lhs, cache = strategy.flat_lhs(ctx, extras_row)
            rhs = rule.rhs(diff_hist)
            upload = (lhs > rhs) | (stale1 >= tau)
            wg32 = wg_row.float()
            delta = strategy.flat_wire_delta(ctx, extras_row, cache,
                                             fresh - wg32)
            wire = torch.where(upload[:, None], delta, 0.0).to(wg_row.dtype)
            new_wg = (wg32 + wire.float()).to(wg_row.dtype)
            new_extras = strategy.flat_post_upload(extras_row, cache,
                                                   upload, ctx)
            # lhs/rhs ride out for the ledger's gate-margin split
            return (losses[0], upload[0], wire[0], new_wg[0], new_extras,
                    lhs[0], rhs)

        return gate

    def _build_apply(self):
        """The server's transition on an upload's arrival: eq. (3)'s ∇
        refined by ONE worker's wire, the fused AMSGrad step, the RHS ring
        push and the strategy's shared pre-step (CADA1's snapshot refresh
        counts server versions). Every output is a new tensor: the
        workers' stale points alias the old θ and params."""
        eng, cfg = self.engine, self.cfg
        strategy, layout = eng.strategy, eng._layout
        m, d_max = self.m, self.rule.d_max
        scale = (1.0 / m if cfg.async_lr_scale is None
                 else cfg.async_lr_scale)
        lr = eng.optimizer.lr
        opt = eng.optimizer._replace(
            lr=(lambda k, _lr=lr: _lr(k) * scale) if callable(lr)
            else lr * scale)

        def apply(theta, opt_state, nabla, wire, diff_hist, k_srv, extras):
            nabla32 = nabla.float() + wire.float() / m
            new_nabla = nabla32.to(nabla.dtype)
            theta, opt_state, dsq = opt.apply_flat(theta, opt_state, nabla32,
                                                   impl=eng._impl)
            theta = layout.cast_roundtrip(theta)
            slot = torch.full((1,), k_srv % d_max, dtype=torch.long,
                              device=diff_hist.device)
            diff_hist = diff_hist.index_copy(0, slot, dsq.float()[None])
            params = layout.unpack(theta)
            extras = strategy.flat_pre_step(extras, params, theta,
                                            k_srv + 1)
            return theta, params, opt_state, new_nabla, diff_hist, extras

        return apply

    def _run_async(self, params, batches) -> SimResult:
        eng, cfg = self.engine, self.cfg
        compute, link = cfg.network.compute, cfg.network.link
        n_batches = F.batch_lead(batches)
        steps = n_batches                      # target server versions
        tau = cfg.async_tau or self.rule.max_delay
        evals = eng.strategy.grad_evals_per_iter

        st = eng.init(params)
        layout = eng._layout
        up_bytes, down_bytes = self._byte_costs(layout.n)
        gate = self._build_gate(tau)
        apply = self._build_apply()

        # server numeric state (st itself is dropped: with a host pool its
        # device planes must not stay alive)
        theta, opt_state = st.params_flat, st.opt_state
        srv_params = st.params
        nabla, diff_hist = st.comm.nabla, st.comm.diff_hist
        worker_grads, extras = st.comm.worker_grads, dict(st.comm.extras)
        del st
        k_srv = 0

        # host_pool: the O(M·n) per-worker rows (grads and pooled extras)
        # move to a host WorkerPool; each gate streams ONE row in and out.
        # The row comes up as one fused H2D block (staging slot 0) and the
        # gate's writeback is DEFERRED: parked on the device and flushed
        # (staging slot 1) before the same worker's next gather, at loop
        # exit, or, oldest first, whenever more than ASYNC_PENDING_CAP
        # rows are parked. Only w's own gate reads w's row, so a flush at
        # any point up to its next gather is bit-exact. Each flush lands
        # its rows before it returns, and a gather waits on its slot's
        # last copies (the pool's events), so no pinned slot is refilled
        # under a copy.
        pool = None
        pooled = ()
        pending_rows: dict = {}        # w -> (P, 1, n_flat) device block
        if cfg.host_pool:
            pooled = eng.strategy.pooled_extras()
            planes = {"worker_grads": worker_grads}
            for name in pooled:
                planes[name] = extras.pop(name)
            pool = F.WorkerPool(planes, storage=cfg.pool_storage,
                                path=cfg.pool_path, device=eng.device)
            worker_grads = planes = None

        def flush_pending(w=None):
            if w is None:
                while pending_rows:
                    flush_pending(next(iter(pending_rows)))
            elif w in pending_rows:
                pool.scatter_fused(np.asarray([w], np.int32),
                                   pending_rows.pop(w), slot=1)

        # per-worker copies of θ (everyone starts at the init point, free)
        wparams = [srv_params] * self.m
        # per-worker stale evaluation point θ^{k−τ_m} of the ring-indexed
        # rules (cada2): host-side references to server params, never
        # written in place, so O(distinct iterates) device memory
        stale_eval = [srv_params] * self.m
        procs = [WorkerProc(w, since_upload=tau, upload_version=-tau)
                 for w in range(self.m)]

        q = EventQueue()
        for w in range(self.m):
            dt = compute.iter_time(w, 0, 0.0, evals)
            procs[w].busy_s += dt
            q.push(dt, COMPUTE_DONE, w)
            self.tracer.add_span("compute", 0.0, dt, track=f"worker {w}",
                                 cat="compute")

        tr = self.tracer
        led = self._new_ledger()
        loss_t, loss_v, srv_times = [], [], []
        t = 0.0
        max_events = steps * self.m * 64 + 1024    # runaway guard
        n_events = 0
        while q and k_srv < steps:
            n_events += 1
            if n_events > max_events:
                raise RuntimeError(
                    f"async sim exceeded {max_events} events at version "
                    f"{k_srv}/{steps} — check the rule's staleness cap")
            ev = q.pop()
            t, w = ev.time, ev.worker
            p = procs[w]

            if ev.kind == COMPUTE_DONE:
                i = p.local_iter % n_batches
                batch1 = F.batch_map(lambda x: x[i, w:w + 1], batches)
                stale = p.staleness(k_srv)
                p.max_staleness = max(p.max_staleness, stale)
                row_view = self._slice_extras(extras, w, stale_eval[w])
                if pool is not None:
                    flush_pending(w)   # w's deferred writeback, if parked
                    fused_row = pool.gather_fused(
                        np.asarray([w], np.int32))   # one H2D, all planes
                    rowd = F.split_fused_rows(fused_row, pool.plane_order)
                    wg_in = rowd["worker_grads"]
                    row_view.update({name: rowd[name] for name in pooled})
                else:
                    wg_in = worker_grads[w:w + 1]
                loss, upload, wire, wg_row, extras_row, g_lhs, g_rhs = gate(
                    wparams[w], batch1, wg_in,
                    torch.full((1,), stale, dtype=torch.int32,
                               device=eng.device), diff_hist, row_view)
                # the gate's one host read: the loop branches on it
                loss_f, up_f, lhs_f, rhs_f = torch.stack(
                    [loss.float(), upload.float(), g_lhs.float(),
                     g_rhs.float()]).tolist()
                uploaded = up_f != 0.0
                led.observe_margin(lhs_f, rhs_f)
                led.observe_staleness(stale)
                if pool is not None:
                    # defer the D2H copy: park the fused row on the device;
                    # it lands in the pool before w's next gather (or at
                    # loop exit)
                    pending_rows[w] = F.stack_fused_rows(
                        {"worker_grads": wg_row[None],
                         **{name: extras_row[name] for name in pooled}},
                        pool.plane_order, pool.plane_dtype)
                    # bounded parking: dict order is parking order, so
                    # this evicts the OLDEST row(s) past the cap
                    while len(pending_rows) > ASYNC_PENDING_CAP:
                        flush_pending(next(iter(pending_rows)))
                else:
                    # in place: the loop owns the plane, and the gate's row
                    # view is dead (its outputs are new tensors)
                    worker_grads[w] = wg_row
                extras = self._merge_extras(extras, extras_row, w)
                loss_t.append(t)
                loss_v.append(loss_f)
                p.local_iter += 1
                if tr:
                    tr.instant("gate", t, track=f"worker {w}",
                               args={"upload": uploaded,
                                     "staleness": int(stale)})
                if uploaded:
                    # restart at 1, as the sync round's post-upload
                    # staleness does, so τ_max = max_delay reproduces the
                    # rule's cap (τ_max = 1 uploads every local iteration)
                    p.since_upload = 1
                    p.uploads += 1
                    # the worker's stale point becomes the iterate it just
                    # evaluated (post_upload's θ̂_m ← θ^k, async form)
                    stale_eval[w] = wparams[w]
                    p.bytes_up += up_bytes
                    dt_up = link.up_time(w, up_bytes, now=t)
                    if tr:
                        tr.add_span("upload", t, dt_up,
                                    track=f"worker {w}", cat="transfer")
                    q.push(t + dt_up, UPLOAD_ARRIVE, w, wire=wire)
                else:
                    p.since_upload += 1
                    p.bytes_down += down_bytes
                    dt_down = link.down_time(w, down_bytes, now=t)
                    if tr:
                        tr.add_span("download", t, dt_down,
                                    track=f"worker {w}", cat="transfer")
                    q.push(t + dt_down, DOWNLOAD_DONE, w)
                if pool is not None:
                    led.observe_pending(len(pending_rows))

            elif ev.kind == UPLOAD_ARRIVE:
                theta, srv_params, opt_state, nabla, diff_hist, extras = \
                    apply(theta, opt_state, nabla, ev.payload["wire"],
                          diff_hist, k_srv, extras)
                k_srv += 1
                srv_times.append(t + cfg.server_update_s)
                p.upload_version = k_srv
                p.bytes_down += down_bytes
                if tr:
                    tr.add_span("apply_update", t, cfg.server_update_s,
                                track="server",
                                args={"version": k_srv, "worker": w})
                dt_down = link.down_time(w, down_bytes,
                                         now=t + cfg.server_update_s)
                if tr:
                    tr.add_span("download", t + cfg.server_update_s,
                                dt_down, track=f"worker {w}",
                                cat="transfer")
                q.push(t + cfg.server_update_s + dt_down,
                       DOWNLOAD_DONE, w)

            elif ev.kind == DOWNLOAD_DONE:
                wparams[w] = srv_params
                dt = compute.iter_time(w, p.local_iter, t, evals)
                p.busy_s += dt
                if tr:
                    tr.add_span("compute", t, dt, track=f"worker {w}",
                                cat="compute")
                q.push(t + dt, COMPUTE_DONE, w)

        if pool is not None:
            flush_pending()            # drain the deferred rows on exit
            led.observe_pool(pool)
        led.uploads = sum(p.uploads for p in procs)
        led.rounds = k_srv
        led.bytes_up = sum(p.bytes_up for p in procs)
        led.add_bytes_down(sum(p.bytes_down for p in procs))
        wall = float(srv_times[-1] if srv_times else t)
        return SimResult(
            mode="async", profile=cfg.network.name, steps=k_srv,
            wall_s=wall, times=np.asarray(srv_times),
            loss_times=np.asarray(loss_t),
            losses=np.asarray(loss_v, np.float64),
            uploads=sum(p.uploads for p in procs),
            grad_evals=sum(p.local_iter for p in procs) * evals,
            bytes_up=sum(p.bytes_up for p in procs),
            bytes_down=sum(p.bytes_down for p in procs),
            utilization=(np.asarray([p.busy_s for p in procs]) / wall
                         if wall > 0 else np.zeros(self.m)),
            max_staleness=max(p.max_staleness for p in procs),
            final_params=srv_params,
            ledger=led.summary())


def simulate(loss_fn, rule: CommRule, params, batches, *,
             n_workers: int, network: str | NetworkProfile = "zero",
             mode: str = "barrier", async_tau: int = 0,
             participation: float = 1.0, cohort_size: int = 0,
             host_pool: bool = False, pipeline: bool = True,
             metrics_every: int = 8, pool_storage: str = "ram",
             pool_path: str | None = None, rounds: int | None = None,
             lr: float = 0.01, eval_s: float = 1e-3, seed: int = 0,
             optimizer=None, impl=None, device=None,
             trace=None) -> SimResult:
    """One-call front door: build the profile, the config and the runtime,
    and run. ``device`` None runs on the card (and raises without one).

    ``trace`` (an ``obs.trace.Tracer`` or None) records every simulated
    compute/transfer/gate event as a span on the simulated clock; export
    it with ``obs.export.write_chrome_trace``."""
    if isinstance(network, str):
        network = network_profile(network, n_workers, eval_s=eval_s,
                                  seed=seed)
    cfg = SimConfig(network=network, mode=mode, async_tau=async_tau,
                    participation=participation, cohort_size=cohort_size,
                    host_pool=host_pool, pipeline=pipeline,
                    metrics_every=metrics_every, pool_storage=pool_storage,
                    pool_path=pool_path, seed=seed)
    rt = SimRuntime(loss_fn, rule, n_workers, cfg, lr=lr,
                    optimizer=optimizer, impl=impl, device=device,
                    trace=trace)
    return rt.run(params, batches, rounds=rounds)
