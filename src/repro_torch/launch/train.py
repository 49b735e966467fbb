"""Training launcher on one device: ``python -m repro_torch.launch.train``.

    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
        --device cpu --workers 2 --steps 8 --global-batch 4 --seq 32
    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
        --device cpu --workers 2 --steps 8 --global-batch 8 --seq 32 \\
        --rule local_momentum --local-steps 2

Runs the LM trainer (``distributed/trainer.py``) with M simulated workers
on one device, the card unless ``--device cpu``: the mesh-free flags of the
JAX package's ``launch/train.py`` and its ``loss= uploads= skip=`` lines.
A delta-payload rule runs ``--local-steps`` H local steps per round, each
on its own B / (H · M) slice of the global batch, and the AMSGrad server
step at ``--lr`` consumes the mean delta.
Weights are drawn from seed 0 on the device; the token stream is the
reference's (``make_token_batches``), the same tokens in both packages.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.core.comm import STRATEGIES, strategy_kinds
from repro_torch.core.rules import CommRule
from repro_torch.data.synthetic import lm_tokens
from repro_torch.device import resolve_device
from repro_torch.distributed.trainer import (TrainHParams, init_train_state,
                                             make_train_step, worker_split)


def make_token_batches(cfg, *, global_batch, seq, steps, seed=0):
    """Zipfian LM stream -> (steps, B, S+1) token batches."""
    toks = lm_tokens(steps * global_batch * (seq + 1) + 1, cfg.vocab,
                     seed=seed)
    n = steps * global_batch * (seq + 1)
    return toks[:n].reshape(steps, global_batch, seq + 1)


def _round_local_steps(rule: CommRule, args) -> int:
    """The local-step axis H of one round's batch: the rule's fixed period
    for a delta-payload rule, 1 for a gradient rule. The global batch must
    divide into H · M per-local-step slices."""
    if not STRATEGIES[rule.kind].delta_payload:
        return 1
    h = rule.local_steps
    if args.global_batch % (h * args.workers):
        raise SystemExit(
            f"--global-batch {args.global_batch} must divide into "
            f"local_steps*workers = {h}*{args.workers} per-local-step "
            "slices")
    return h


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True, choices=C.list_archs())
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (CPU-sized)")
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
    p.add_argument("--avp-compose", action="store_true",
                   help="avp rule: upload only when due AND the "
                        "innovation energy clears the CADA RHS")
    p.add_argument("--local-steps", type=int, default=1,
                   help="delta-payload rules (local_momentum | fedadam): "
                        "local optimizer steps per communication round")
    p.add_argument("--local-lr", type=float, default=0.1,
                   help="delta-payload rules: local optimizer step size")
    p.add_argument("--moments-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the flat {h, v̂} moment planes")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--workers", type=int, default=1,
                   help="M, simulated on the one device (1, as the "
                        "reference's one-device mesh)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (C.get_smoke_config(args.arch) if args.smoke
           else C.get_config(args.arch))
    m = args.workers
    if args.global_batch % m:
        raise SystemExit(f"--global-batch {args.global_batch} must divide "
                         f"into {m} workers")
    rule = CommRule(kind=args.rule, c=args.c, d_max=10, max_delay=50,
                    quantize_bits=args.quantize_bits,
                    error_feedback=not args.no_error_feedback,
                    topk_frac=args.topk_frac, sparse_wire=args.sparse_wire,
                    avp_compose=args.avp_compose,
                    local_steps=args.local_steps, local_lr=args.local_lr,
                    server_lr=args.lr)
    hp = TrainHParams(rule=rule, lr=args.lr, microbatches=args.microbatches,
                      moments_dtype=args.moments_dtype)
    h = _round_local_steps(rule, args)
    step = make_train_step(cfg, hp, m)
    state = init_train_state(cfg, hp, m, 0, device)
    batches = make_token_batches(cfg, global_batch=args.global_batch,
                                 seq=args.seq, steps=args.steps)

    t0 = time.time()
    history = []
    for i in range(args.steps):
        tokens = torch.from_numpy(batches[i]).to(device=device,
                                                  dtype=torch.long)
        state, mets = step(state, worker_split({"tokens": tokens}, m,
                                               local_steps=h))
        if i % args.log_every == 0 or i == args.steps - 1:
            row = {k: float(v) for k, v in mets.items() if v.ndim == 0}
            row["step"] = i
            row["wall_s"] = round(time.time() - t0, 1)
            history.append(row)
            print(f"step {i:5d} loss={row['loss']:.4f} "
                  f"uploads={int(row['uploads'])}/{m} "
                  f"skip={row['skip_rate']:.2f} "
                  f"({row['wall_s']}s)", flush=True)
    final = np.mean([h["loss"] for h in history[-3:]])
    print(f"done: final loss {final:.4f} on {device}")
    return history


if __name__ == "__main__":
    main()
