"""Wall-clock models of the heterogeneous-cluster simulation (a copy of the
JAX package's ``sim/clock.py``, numpy only: the same seeds give the same
draws, bit for bit).

Two model families turn the engine's round-accounting into simulated
seconds:

  * :class:`ComputeModel` — per-worker gradient-evaluation times. Three
    kinds: ``deterministic`` (fixed per-worker mean), ``lognormal``
    (mean-preserving multiplicative jitter), ``trace`` (replay recorded
    per-eval durations). Rules that evaluate twice per iteration (CADA1's
    snapshot gradient, CADA2's stale-iterate gradient) are charged per
    ``strategy.grad_evals_per_iter`` — the runtime asks for ``n_evals``
    draws per iteration, so the second evaluation costs real simulated
    time, exactly as §2.2 counts it (discountable via
    ``second_eval_factor`` when the fused/grouped second-eval forms make
    it cheaper than a full extra pass).
  * :class:`LinkModel` — per-worker latency + bandwidth. Transfer time is
    ``latency + nbytes / bandwidth``; the byte counts come from each
    strategy's ``bytes_per_upload`` accounting, so quantized (laq/cinn)
    and sparse (topk ``--sparse-wire``) rules get *faster* uploads, not
    just cheaper-in-rounds ones.

Both models are deterministic given their seed: random draws are keyed on
``(seed, worker, local_iter)``, never on call order, so barrier and async
runtimes (which visit workers in different orders) see identical samples
and every simulation replays exactly.

Straggler injection lives here too: permanent per-worker slowdown factors
and transient windows ``(worker, t_start, t_end, factor)`` multiply the
compute draw for events that start inside the window.

:func:`network_profile` packages the named scenario presets the launcher
and benchmarks expose (``zero`` / ``lan`` / ``wan`` / ``hetero``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def _per_worker(value, m: int) -> np.ndarray:
    """Broadcast a scalar or length-M sequence to an (M,) float array."""
    arr = np.asarray(value, np.float64)
    if arr.ndim == 0:
        arr = np.full((m,), float(arr))
    if arr.shape != (m,):
        raise ValueError(f"expected scalar or shape ({m},), got {arr.shape}")
    return arr


@dataclass(frozen=True)
class ComputeModel:
    """Per-worker gradient-evaluation times (simulated seconds).

    ``eval_s`` is the mean seconds per single gradient evaluation (scalar
    or per-worker). ``kind``:

      * ``deterministic`` — every eval takes exactly its worker's mean;
      * ``lognormal`` — each eval draws ``eval_s · exp(N(−σ²/2, σ))``
        (mean-preserving, heavy right tail — the classic straggler shape);
      * ``trace`` — ``traces[m][j]`` is worker m's j-th eval duration,
        cycled when the trace is shorter than the run.

    ``second_eval_factor`` scales every evaluation after the first of an
    iteration (``eval_idx >= 1``). The default 1.0 is the paper's flat
    ``grad_evals_per_iter = 2`` charge for cada1/cada2; the optimized
    second-eval forms are cheaper than a full extra pass — the stacked
    ``fuse_evals`` eval shares dispatch/activation traffic with the fresh
    one, and the grouped ring eval fetches R ≪ M weight copies — so
    simulated wall-clock (``BENCH_sim.json``) can reflect the optimization
    (e.g. 0.5 ≈ "the second eval costs half a pass") instead of
    double-charging it.
    """
    m: int
    eval_s: tuple
    kind: str = "deterministic"
    sigma: float = 0.0
    traces: tuple = ()
    slowdown: tuple = ()            # per-worker permanent factors (M,)
    transient: tuple = ()           # (worker, t_start, t_end, factor) rows
    seed: int = 0
    second_eval_factor: float = 1.0

    @classmethod
    def make(cls, m: int, eval_s=1e-3, kind: str = "deterministic",
             sigma: float = 0.0, traces=None, slowdown=None,
             transient=(), seed: int = 0,
             second_eval_factor: float = 1.0) -> "ComputeModel":
        if kind not in ("deterministic", "lognormal", "trace"):
            raise ValueError(f"unknown compute kind {kind!r}")
        if kind == "trace" and not traces:
            raise ValueError("kind='trace' needs per-worker traces")
        return cls(
            m=m,
            eval_s=tuple(_per_worker(eval_s, m)),
            kind=kind,
            sigma=float(sigma),
            traces=tuple(tuple(float(t) for t in tr)
                         for tr in (traces or ())),
            slowdown=tuple(_per_worker(1.0 if slowdown is None else slowdown,
                                       m)),
            transient=tuple(tuple(row) for row in transient),
            seed=seed,
            second_eval_factor=float(second_eval_factor),
        )

    def _factor(self, worker: int, now: float) -> float:
        f = self.slowdown[worker]
        for w, t0, t1, fac in self.transient:
            if w == worker and t0 <= now < t1:
                f *= fac
        return f

    def eval_time(self, worker: int, local_iter: int, eval_idx: int,
                  now: float) -> float:
        """Seconds for ONE gradient evaluation (the ``eval_idx``-th of
        iteration ``local_iter``), starting at simulated time ``now``."""
        if self.kind == "trace":
            tr = self.traces[worker % len(self.traces)]
            base = tr[(local_iter + eval_idx) % len(tr)]
        else:
            base = self.eval_s[worker]
            if self.kind == "lognormal" and self.sigma > 0.0:
                rng = np.random.default_rng(
                    (self.seed, worker, local_iter, eval_idx))
                base *= math.exp(rng.normal(-0.5 * self.sigma ** 2,
                                            self.sigma))
        if eval_idx >= 1:
            base *= self.second_eval_factor
        return base * self._factor(worker, now)

    def iter_time(self, worker: int, local_iter: int, now: float,
                  n_evals: int) -> float:
        """Seconds of compute for one local iteration = ``n_evals``
        sequential gradient evaluations."""
        t = 0.0
        for e in range(n_evals):
            t += self.eval_time(worker, local_iter, e, now + t)
        return t

    def round_time(self, worker: int, first_iter: int, now: float,
                   h: int, n_evals: int) -> float:
        """Seconds of compute for one COMM ROUND of ``h`` sequential local
        iterations starting at local iteration index ``first_iter`` — the
        delta-payload rules' pricing unit (a worker runs h local optimizer
        steps between uploads). Each local iteration draws its own
        eval times at index ``first_iter + j`` (callers space rounds by
        the schedule's H cap so draws never collide across rounds), and
        transient slowdown windows apply at the accumulated clock.
        ``h=1`` is bitwise :meth:`iter_time` at ``first_iter``.
        """
        t = 0.0
        for j in range(h):
            t += self.iter_time(worker, first_iter + j, now + t, n_evals)
        return t


_BYTES_PER_MBIT = 1e6 / 8.0


@dataclass(frozen=True)
class LinkModel:
    """Per-worker link: transfer time = latency + bytes / bandwidth.

    ``bandwidth`` is bytes/second; ``math.inf`` (or 0 latency with inf
    bandwidth — the ``zero`` profile) makes transfers free. Uplink and
    downlink are symmetric unless ``down_bandwidth`` is given (WAN links
    are usually asymmetric; the broadcast direction is the fat one).

    ``trace`` makes the bandwidth TIME-VARYING: per-worker series of
    ``(t_seconds, up_mbit_s[, down_mbit_s])`` rows (Mbit/s, the unit
    network traces ship in; two-column rows mean a symmetric link).
    Between points the bandwidth is linearly interpolated; before the
    first and after the last point it HOLDS the edge value (``np.interp``
    semantics). When fewer traces than workers are given they cycle
    (``worker % len(trace)``), like :class:`ComputeModel` traces. A
    transfer is priced at the bandwidth in effect at its START time
    (``now``) — the piecewise-constant-per-transfer approximation; the
    event-driven runtimes pass their current simulated clock.
    """
    m: int
    latency_s: tuple
    bandwidth: tuple
    down_bandwidth: tuple
    trace: tuple = ()       # per-worker ((t,...), (up_Bps,...), (down_Bps,...))

    @classmethod
    def make(cls, m: int, latency_s=0.0, bandwidth=math.inf,
             down_bandwidth=None, trace=None) -> "LinkModel":
        return cls(
            m=m,
            latency_s=tuple(_per_worker(latency_s, m)),
            bandwidth=tuple(_per_worker(bandwidth, m)),
            down_bandwidth=tuple(_per_worker(
                bandwidth if down_bandwidth is None else down_bandwidth, m)),
            trace=tuple(cls._norm_trace(tr) for tr in (trace or ())),
        )

    @staticmethod
    def _norm_trace(tr):
        rows = np.asarray(tr, np.float64)
        if rows.ndim != 2 or rows.shape[1] not in (2, 3) or not rows.size:
            raise ValueError(
                "a bandwidth trace is (t_seconds, up_mbit_s[, down_mbit_s]) "
                f"rows, got shape {rows.shape}")
        if np.any(np.diff(rows[:, 0]) < 0):
            raise ValueError("bandwidth trace times must be non-decreasing")
        up = rows[:, 1] * _BYTES_PER_MBIT
        down = (rows[:, 2] * _BYTES_PER_MBIT if rows.shape[1] == 3 else up)
        if np.any(up <= 0) or np.any(down <= 0):
            raise ValueError("bandwidth trace rates must be positive")
        return (tuple(rows[:, 0]), tuple(up), tuple(down))

    def _bw(self, worker: int, now: float, down: bool) -> float:
        if self.trace:
            t, up, dn = self.trace[worker % len(self.trace)]
            return float(np.interp(now, t, dn if down else up))
        return (self.down_bandwidth if down else self.bandwidth)[worker]

    def _xfer(self, latency: float, bw: float, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return latency + (0.0 if math.isinf(bw) else nbytes / bw)

    def up_time(self, worker: int, nbytes: float,
                now: float = 0.0) -> float:
        return self._xfer(self.latency_s[worker],
                          self._bw(worker, now, down=False), nbytes)

    def down_time(self, worker: int, nbytes: float,
                  now: float = 0.0) -> float:
        return self._xfer(self.latency_s[worker],
                          self._bw(worker, now, down=True), nbytes)


@dataclass(frozen=True)
class NetworkProfile:
    """A named (compute, link) scenario the runtime simulates under."""
    name: str
    compute: ComputeModel
    link: LinkModel


PROFILES = ("zero", "lan", "wan", "hetero")


def network_profile(name: str, m: int, *, eval_s: float = 1e-3,
                    seed: int = 0, second_eval_factor: float = 1.0,
                    trace=None) -> NetworkProfile:
    """The scenario presets (`--network` on the launcher, swept by
    ``benchmarks.ablations.sweep_network``):

      * ``zero``   — zero latency, infinite bandwidth, homogeneous
        deterministic compute: wall-clock is compute only. This is the
        DEGENERATE config whose barrier-mode trajectories must reproduce
        the plain engine bit-exactly (the sim parity gate).
      * ``lan``    — 0.1 ms latency, 10 GB/s links, homogeneous compute:
        communication is nearly free, so per-iteration convergence wins.
      * ``wan``    — 20 ms latency, 1 Mbit/s up / 10 Mbit/s down (the
        constrained federated-uplink regime), homogeneous compute:
        uploads dominate and are BANDWIDTH-bound — skipping rounds and
        shrinking wires is where the communication-adaptive rules earn
        wall-clock.
      * ``hetero`` — heterogeneous cluster: per-worker compute means
        spread ×1..×3 with lognormal jitter (σ=0.3), the last worker a
        permanent ×4 straggler, per-worker bandwidth spread around LAN
        numbers. The straggler-tolerance scenario of Adaptive Worker
        Grouping (PAPERS.md).

    ``eval_s`` rescales the compute grain (a real LM step is not a logreg
    step); all link numbers are absolute. ``second_eval_factor`` is
    forwarded to :class:`ComputeModel` (see there — the fused/grouped
    second-eval discount). ``trace`` overlays TIME-VARYING bandwidth on
    any preset: per-worker ``(t_seconds, up_mbit_s[, down_mbit_s])`` row
    series (see :class:`LinkModel`) replace the preset's static rates
    while keeping its latency — e.g. ``wan`` latency with a measured
    diurnal uplink trace.
    """
    sef = second_eval_factor
    if trace is not None:
        prof = network_profile(name, m, eval_s=eval_s, seed=seed,
                               second_eval_factor=sef)
        link = LinkModel.make(m, latency_s=prof.link.latency_s,
                              trace=trace)
        return NetworkProfile(name=name, compute=prof.compute, link=link)
    if name == "zero":
        return NetworkProfile(
            name=name,
            compute=ComputeModel.make(m, eval_s=eval_s, seed=seed,
                                      second_eval_factor=sef),
            link=LinkModel.make(m, latency_s=0.0, bandwidth=math.inf),
        )
    if name == "lan":
        return NetworkProfile(
            name=name,
            compute=ComputeModel.make(m, eval_s=eval_s, seed=seed,
                                      second_eval_factor=sef),
            link=LinkModel.make(m, latency_s=1e-4, bandwidth=1e10),
        )
    if name == "wan":
        # federated-WAN numbers: 20 ms RTT-ish latency, 1 Mbit/s uplink
        # (the constrained direction), 10 Mbit/s downlink — uploads are
        # BANDWIDTH-dominated, so shrinking the wire (laq 8-bit, topk
        # sparse) buys wall-clock directly, on top of skipped rounds
        return NetworkProfile(
            name=name,
            compute=ComputeModel.make(m, eval_s=eval_s, seed=seed,
                                      second_eval_factor=sef),
            link=LinkModel.make(m, latency_s=2e-2, bandwidth=1.25e5,
                                down_bandwidth=1.25e6),
        )
    if name == "hetero":
        spread = np.linspace(1.0, 3.0, m)
        slowdown = np.ones(m)
        slowdown[-1] = 4.0
        bw = np.linspace(2e9, 5e8, m)
        return NetworkProfile(
            name=name,
            compute=ComputeModel.make(m, eval_s=spread * eval_s,
                                      kind="lognormal", sigma=0.3,
                                      slowdown=slowdown, seed=seed,
                                      second_eval_factor=sef),
            link=LinkModel.make(m, latency_s=1e-3, bandwidth=bw),
        )
    raise ValueError(f"unknown network profile {name!r}; "
                     f"known: {PROFILES}")
