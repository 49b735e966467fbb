"""Training launcher: ``python -m repro_torch.launch.train``.

    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
        --device cpu --workers 2 --steps 8 --global-batch 4 --seq 32
    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
        --device cpu --workers 2 --steps 8 --global-batch 8 --seq 32 \\
        --rule local_momentum --local-steps 2
    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
        --device cpu --runtime sim --network wan --workers 2 --steps 8 \\
        --global-batch 4 --seq 32

``--runtime mesh`` (the default) runs the LM trainer
(``distributed/trainer.py``). In a single process it simulates M workers
on one device, the card unless ``--device cpu``. Started as several
processes (``torchrun``, or the reference's ``REPRO_COORDINATOR``,
``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID`` in each process's
environment; ``launch/multihost.py``) it runs the mesh runtime
(``trainer.jit_train_step``): a (data=world, model=1) mesh whose ranks are
the M workers, the flat state ZeRO-sharded over ``--state-fsdp-axes``, the
parameters cut by FSDP where ``sharding.wants_fsdp`` turns it on (the
reference's resolution of ``fsdp=None``; rank 0 saves them gathered);
``--backend`` picks the process group's (default: nccl on the card, gloo
on the CPU; gloo where ranks share one card). Rank 0 alone prints the
log and writes ``history.json``, the trace, the metrics and the
checkpoints. The flags are the JAX package's ``launch/train.py``'s, with
its ``loss= uploads= skip=`` lines:

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch stablelm-1.6b --smoke --device cpu --runtime mesh \\
        --state-fsdp-axes data --steps 8 --global-batch 4 --seq 32

A delta-payload rule runs ``--local-steps`` H local steps per round,
each on its own B / (H · M) slice of the global batch, and the AMSGrad
server step at ``--lr`` consumes the mean delta. ``--ckpt-dir`` saves ``state.params``
every ``--ckpt-every`` steps and at the end (``repro_torch.checkpoint``,
the reference's format) with the logged rows as ``history.json``;
``--trace`` records a ``train_step`` span per step on the wall clock, and
``--metrics-out``/``--metrics-prom`` write the run's row with the
``CommLedger`` totals, fed every ``--metrics-every`` steps.

``--runtime sim`` trains under the discrete-event runtime
(``repro_torch.sim``): simulated wall-clock under ``--network``, the
synchronous barrier or, with ``--async-tau``, bounded-staleness async; it
prints and returns the run's summary row.

Weights are drawn from seed 0 on the device; the token stream is the
reference's (``make_token_batches``), the same tokens in both packages.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.checkpoint import io as ckpt
from repro_torch.core.comm import STRATEGIES, strategy_for, strategy_kinds
from repro_torch.core.rules import CommRule
from repro_torch.data.synthetic import lm_tokens
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import uncut_tree
from repro_torch.distributed.trainer import (TrainHParams, flat_sharding,
                                             init_train_state,
                                             jit_train_step,
                                             make_train_step,
                                             shard_train_state, worker_split)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.multihost import bootstrap, is_coordinator
from repro_torch.models.model import init_params, lm_loss
from repro_torch.obs import (CommLedger, MetricsRegistry, Tracer, as_tracer,
                             write_chrome_trace, write_jsonl)
from repro_torch.sim import simulate, summarize


def make_token_batches(cfg, *, global_batch, seq, steps, seed=0):
    """Zipfian LM stream -> (steps, B, S+1) token batches."""
    toks = lm_tokens(steps * global_batch * (seq + 1) + 1, cfg.vocab,
                     seed=seed)
    n = steps * global_batch * (seq + 1)
    return toks[:n].reshape(steps, global_batch, seq + 1)


def _flatten_row(row: dict, prefix: str = "") -> dict:
    """One-level flatten of nested dicts into metric-name keys."""
    out = {}
    for k, v in row.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_row(v, prefix=f"{key}_"))
        else:
            out[key] = v
    return out


def _write_obs(args, tracer, row: dict) -> None:
    """Write the requested telemetry sinks: Chrome-trace JSON
    (``--trace``), metrics JSONL (``--metrics-out``), Prometheus
    textfile (``--metrics-prom``)."""
    if args.trace and tracer:
        write_chrome_trace(tracer, args.trace,
                           meta={"arch": args.arch, "rule": args.rule,
                                 "runtime": args.runtime})
        print(f"[obs] chrome trace ({len(tracer.events)} events, "
              f"{len(tracer.tracks)} tracks) -> {args.trace}")
    if args.metrics_out:
        write_jsonl(args.metrics_out, row)
        print(f"[obs] metrics jsonl -> {args.metrics_out}")
    if args.metrics_prom:
        reg = MetricsRegistry()
        for k, v in _flatten_row(row).items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            reg.gauge(k).set(v)
        reg.write_prom(args.metrics_prom)
        print(f"[obs] prometheus textfile -> {args.metrics_prom}")


def run_sim(cfg, rule: CommRule, args, device) -> dict:
    """``--runtime sim``: train under the discrete-event runtime
    (``repro_torch.sim``), simulated wall-clock under the chosen network
    profile, barrier or bounded-staleness async (``--async-tau``). The
    workers are simulated; the numerics run on ``device``. ``--trace``
    exports every simulated compute/transfer/gate event as a span on the
    simulated clock. Returns the summary row.

    The loss is the models' training route (``lm_loss(train=True)``; the
    serving route's kernels have no gradient) with ``remat`` off: the
    engine vmaps the gradient over the workers with ``torch.func``, and
    ``torch.utils.checkpoint`` does not compose with it. Remat changes
    memory, not values."""
    m = args.workers or 4
    steps = args.steps
    toks = make_token_batches(cfg, global_batch=args.global_batch,
                              seq=args.seq, steps=steps)
    # delta-payload rules take (H, M, b, ...) a round; adaptive H runs on
    # batches padded to the adaptation cap (the realized schedule runs
    # each worker's first H_m steps)
    h = _round_local_steps(rule, args, m)
    tokens = torch.from_numpy(toks).to(device=device, dtype=torch.long)
    batches = (torch.stack([worker_split({"tokens": tokens[i]}, m,
                                         local_steps=h)["tokens"]
                            for i in range(steps)]),)
    mode = "async" if args.async_tau else "barrier"
    tracer = Tracer() if args.trace else None
    params = init_params(cfg, 0, device)
    sim_cfg = cfg.with_(remat=False)
    res = simulate(lambda p, wb: lm_loss(sim_cfg, p, {"tokens": wb[0]},
                                         train=True)[0],
                   rule, params, batches, n_workers=m, network=args.network,
                   mode=mode, async_tau=args.async_tau,
                   participation=args.participation,
                   cohort_size=args.cohort_size,
                   host_pool=bool(args.async_tau
                                  and (args.host_pool or args.pool_memmap)),
                   pipeline=not args.no_pipeline,
                   metrics_every=args.metrics_every,
                   pool_storage="memmap" if args.pool_memmap else "ram",
                   pool_path=args.pool_memmap or None, lr=args.lr,
                   eval_s=args.sim_eval_ms * 1e-3, device=device,
                   trace=tracer)
    row = summarize(res, args.target_loss or None)
    print(f"[sim] {args.network}/{mode} rule={rule.kind}: "
          f"{res.steps} server steps in {res.wall_s:.3f} simulated s, "
          f"loss {row['final_loss']:.4f}, uploads {res.uploads}, "
          f"up {row['mbytes_up']:.3f} MB, "
          f"utilization {row['utilization_mean']:.2f} on {device}")
    print(json.dumps(row, indent=1))
    _write_obs(args, tracer, row)
    return row


def _round_local_steps(rule: CommRule, args, m: int) -> int:
    """The local-step axis H of one round's batch: the adaptation cap for
    an adaptive-H run, the rule's fixed period otherwise for a
    delta-payload rule, 1 for a gradient rule. The global batch must
    divide into H · M per-local-step slices."""
    if not STRATEGIES[rule.kind].delta_payload:
        return 1
    h = (rule.resolved_local_steps_max if rule.adapt_local_steps
         else rule.local_steps)
    if args.global_batch % (h * m):
        raise SystemExit(
            f"--global-batch {args.global_batch} must divide into "
            f"local_steps*workers = {h}*{m} per-local-step slices")
    return h


def main(argv=None) -> list[dict]:
    """Run the launcher; returns the logged history rows (``--runtime
    mesh``) or the one summary row (``--runtime sim``)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True, choices=C.list_archs())
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-sized)")
    p.add_argument("--layers", type=int, default=0,
                   help="keep the first N layers of the config at its "
                        "width (0 = all): the depth cut a large config "
                        "needs on one card")
    p.add_argument("--runtime", default="mesh", choices=["mesh", "sim"],
                   help="mesh = the trainer on the one device; sim = the "
                        "discrete-event heterogeneous-cluster runtime "
                        "(repro_torch.sim), simulated wall-clock under "
                        "--network")
    p.add_argument("--network", default="lan",
                   help="sim runtime: network profile "
                        "(zero | lan | wan | hetero)")
    p.add_argument("--async-tau", type=int, default=0,
                   help="sim runtime: >0 runs the bounded-staleness ASYNC "
                        "mode with staleness cap tau (uploads applied as "
                        "they arrive); 0 = synchronous barrier mode")
    p.add_argument("--participation", type=float, default=1.0,
                   help="sim barrier mode: fraction of workers "
                        "participating per round")
    p.add_argument("--cohort-size", type=int, default=0,
                   help="sim barrier mode: >0 runs the FEDERATED cohort "
                        "plane: C sampled workers per round through the "
                        "host WorkerPool, O(C*n) device state")
    p.add_argument("--no-pipeline", action="store_true",
                   help="cohort rounds: the serial loop instead of the "
                        "pipelined one (the parity oracle)")
    p.add_argument("--metrics-every", type=int, default=8,
                   help="cohort rounds and the mesh runtime's ledger: "
                        "fetch the device's metrics every K rounds or "
                        "steps instead of each one")
    p.add_argument("--host-pool", action="store_true",
                   help="sim async mode: stream per-worker rows through "
                        "the host WorkerPool instead of holding the "
                        "(M, n) plane on the device (implied by "
                        "--pool-memmap)")
    p.add_argument("--pool-memmap", default="",
                   help="back the WorkerPool's O(M*n) planes with "
                        "np.memmap files under this directory; empty = "
                        "RAM")
    p.add_argument("--sim-eval-ms", type=float, default=1.0,
                   help="sim runtime: simulated milliseconds per worker "
                        "gradient evaluation")
    p.add_argument("--target-loss", type=float, default=0.0,
                   help="sim runtime: report the simulated "
                        "time-to-target-loss for this target (0 = off)")
    p.add_argument("--rule", default="cada2", choices=list(strategy_kinds()),
                   help="communication rule")
    p.add_argument("--c", type=float, default=1.0)
    p.add_argument("--quantize-bits", type=int, default=0,
                   help="b-bit innovation uploads (0 = rule default)")
    p.add_argument("--topk-frac", type=float, default=0.1,
                   help="topk rule: fraction of innovation entries "
                        "uploaded per (worker, leaf)")
    p.add_argument("--sparse-wire", action="store_true",
                   help="topk rule: ship (values, indices) pairs")
    p.add_argument("--no-error-feedback", action="store_true",
                   help="laq/topk: drop the compression error instead of "
                        "carrying the per-worker residual e_m")
    p.add_argument("--period-min", type=int, default=1,
                   help="avp rule: per-worker upload-period lower bound")
    p.add_argument("--period-max", type=int, default=0,
                   help="avp rule: upper bound (0 = max-delay)")
    p.add_argument("--avp-compose", action="store_true",
                   help="avp rule: upload only when due AND the "
                        "innovation energy clears the CADA RHS")
    p.add_argument("--local-steps", type=int, default=1,
                   help="delta-payload rules (local_momentum | fedadam): "
                        "local optimizer steps per communication round")
    p.add_argument("--adapt-local-steps", action="store_true",
                   help="sim runtime only: adapt each worker's local-step "
                        "count from its simulated comm vs compute time "
                        "(avp's period rule turned to local steps)")
    p.add_argument("--local-steps-min", type=int, default=1,
                   help="adaptive local steps: per-worker lower bound")
    p.add_argument("--local-steps-max", type=int, default=0,
                   help="adaptive local steps: upper bound (0 = max-delay)")
    p.add_argument("--local-lr", type=float, default=0.1,
                   help="delta-payload rules: local optimizer step size")
    p.add_argument("--state-fsdp-axes", default="",
                   help="comma list of mesh axes to ZeRO the flat "
                        "optimizer/comm state over (e.g. 'data'); the mesh "
                        "runtime on several processes")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend when several "
                        "processes run (default: nccl on the card, gloo on "
                        "the CPU; gloo where ranks share one card)")
    p.add_argument("--moments-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the flat {h, v̂} moment planes")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--workers", type=int, default=0,
                   help="M: simulated on the one device (0 = 1 there, the "
                        "reference's one-device mesh; 4 on the sim); on "
                        "several processes M is the world's data-axis "
                        "size, and this must be 0 or equal it")
    p.add_argument("--ckpt-dir", default=None,
                   help="mesh runtime: save state.params under "
                        "DIR/step_<k> and the logged rows as "
                        "DIR/history.json")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="mesh runtime: also save every K steps (0 = at "
                        "the end only)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--trace", default="",
                   help="write a Chrome-trace/Perfetto JSON timeline here: "
                        "sim runtime = every simulated compute/transfer/"
                        "gate event on the simulated clock; mesh runtime "
                        "= per-step train spans on the wall clock")
    p.add_argument("--metrics-out", default="",
                   help="append the run's summary row with the comm "
                        "ledger as one JSONL row to this path")
    p.add_argument("--metrics-prom", default="",
                   help="also write the row as a Prometheus "
                        "textfile-collector snapshot to this path")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    ranked = args.runtime == "mesh" and bootstrap(backend=args.backend,
                                                  device=device)
    if ranked and device.type == "cuda":   # the card bootstrap selected
        device = resolve_device(None)
    cfg = (C.get_smoke_config(args.arch) if args.smoke
           else C.get_config(args.arch))
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    if not cfg.embed_input:
        raise SystemExit(f"{args.arch} consumes modality embeddings; serve "
                         "it with python -m repro_torch.launch.serve, or "
                         "train it through repro_torch.distributed.trainer "
                         "with {'embeds', 'labels', 'positions'} batches")
    if args.adapt_local_steps and args.runtime != "sim":
        raise SystemExit(
            "--adapt-local-steps needs --runtime sim: the adaptation "
            "signal is comm vs compute time from the sim's link model — "
            "the mesh runtime has no clock to adapt from")
    rule = CommRule(kind=args.rule, c=args.c, d_max=10, max_delay=50,
                    quantize_bits=args.quantize_bits,
                    error_feedback=not args.no_error_feedback,
                    topk_frac=args.topk_frac, sparse_wire=args.sparse_wire,
                    period_min=args.period_min, period_max=args.period_max,
                    avp_compose=args.avp_compose,
                    local_steps=args.local_steps,
                    adapt_local_steps=args.adapt_local_steps,
                    local_steps_min=args.local_steps_min,
                    local_steps_max=args.local_steps_max,
                    local_lr=args.local_lr, server_lr=args.lr)
    if args.runtime == "sim":
        return [run_sim(cfg, rule, args, device)]
    hp = TrainHParams(rule=rule, lr=args.lr, microbatches=args.microbatches,
                      moments_dtype=args.moments_dtype,
                      state_fsdp_axes=tuple(
                          a for a in args.state_fsdp_axes.split(",") if a))
    if ranked:
        mesh = make_host_mesh()
        make, _, m = jit_train_step(cfg, mesh, hp)
        if args.workers not in (0, m):
            raise SystemExit(f"--workers {args.workers}: the mesh's data "
                             f"axis has {m} ranks")
    else:
        m = args.workers or 1
    if args.global_batch % m:
        raise SystemExit(f"--global-batch {args.global_batch} must divide "
                         f"into {m} workers")
    h = _round_local_steps(rule, args, m)
    batches = make_token_batches(cfg, global_batch=args.global_batch,
                                 seq=args.seq, steps=args.steps)
    if ranked:
        fs = flat_sharding(cfg, mesh, hp)
        state = shard_train_state(init_train_state(
            cfg, hp, m, 0, device, shards=fs.shards), fs, hp)
        step = make(worker_split({"tokens": torch.from_numpy(
            batches[0]).to(device=device, dtype=torch.long)}, m,
            local_steps=h))
    else:
        step = make_train_step(cfg, hp, m)
        state = init_train_state(cfg, hp, m, 0, device)
    lead = is_coordinator()

    def whole_params(state):
        """The whole parameters (every rank gathers the mesh's shards: a
        collective), which rank 0 saves."""
        if not ranked:
            return state.params
        return uncut_tree(state.params, fs.pspecs, mesh)

    # telemetry: a span per step on the wall clock (on one process the
    # step's own train.step with its phases inside it, across ranks the
    # launcher's train_step), and a comm ledger fed from the steps'
    # metrics, fetched every --metrics-every steps
    obs_on = lead and bool(args.trace or args.metrics_out
                           or args.metrics_prom)
    tracer = Tracer() if (args.trace and lead) else None
    ledger = (CommLedger.for_strategy(strategy_for(rule)) if obs_on
              else None)
    tr = as_tracer(tracer)
    obs_buf: list = []

    def drain_obs():
        for met in obs_buf:
            ledger.observe_round({k: v.cpu().numpy()
                                  for k, v in met.items()})
        obs_buf.clear()

    t0 = time.time()
    history = []
    for i in range(args.steps):
        tokens = torch.from_numpy(batches[i]).to(device=device,
                                                  dtype=torch.long)
        batch = worker_split({"tokens": tokens}, m, local_steps=h)
        if ranked:
            with tr.span("train_step", track="train", args={"step": i}):
                state, mets = step(state, batch)
        else:
            state, mets = step(state, batch, trace=tracer)
        if obs_on:
            obs_buf.append(mets)
            if len(obs_buf) >= max(1, args.metrics_every):
                drain_obs()
        if i % args.log_every == 0 or i == args.steps - 1:
            row = {k: float(v) for k, v in mets.items() if v.ndim == 0}
            row["step"] = i
            row["wall_s"] = round(time.time() - t0, 1)
            history.append(row)
            if lead:
                print(f"step {i:5d} loss={row['loss']:.4f} "
                      f"uploads={int(row['uploads'])}/{m} "
                      f"skip={row['skip_rate']:.2f} "
                      f"({row['wall_s']}s)", flush=True)
        if args.ckpt_every and args.ckpt_dir and i and \
                i % args.ckpt_every == 0:
            params = whole_params(state)
            if lead:
                ckpt.save(os.path.join(args.ckpt_dir, f"step_{i}"),
                          params, step=i)
    if args.ckpt_dir:
        params = whole_params(state)
    if lead and args.ckpt_dir:
        ckpt.save(os.path.join(args.ckpt_dir, f"step_{args.steps}"),
                  params, step=args.steps)
        with open(os.path.join(args.ckpt_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=1)
    final = np.mean([h["loss"] for h in history[-3:]])
    if lead:
        print(f"done: final loss {final:.4f} on {device}")
    if obs_on:
        drain_obs()
        _write_obs(args, tracer, {
            "runtime": "mesh", "arch": args.arch, "rule": args.rule,
            "steps": args.steps, "final_loss": float(final),
            **ledger.summary()})
    if ranked:
        torch.distributed.destroy_process_group()
    return history


if __name__ == "__main__":
    main()
