"""End-to-end run of the PyTorch port: train a ~100M-parameter decoder
LM with CADA for a few hundred steps (the port of
``examples/train_lm_cada.py``: the same configs, flags and loss-decrease
check, and ``--device``).

    PYTHONPATH=src python examples/train_lm_cada_torch.py           # card
    PYTHONPATH=src python examples/train_lm_cada_torch.py --tiny --device cpu

The model is a llama-family dense GQA decoder built from the same
ModelConfig the registered architectures use; the trainer is
``repro_torch.distributed.trainer``'s CADA2 step, with the AMSGrad and
rule-LHS kernels on the card. --tiny runs the identical path in seconds.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.rules import CommRule
from repro_torch.device import resolve_device
from repro_torch.distributed.trainer import (TrainHParams, init_train_state,
                                             make_train_step, worker_split)
from repro_torch.launch.train import make_token_batches
from repro_torch.models.config import ModelConfig, param_count

LM_100M = ModelConfig(
    name="repro-lm-100m", arch_type="dense", block="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
    vocab=32000, mlp_act="swiglu", dtype="float32", remat=False,
    source="quickstart 100M config (llama-family)")

LM_TINY = LM_100M.with_(name="repro-lm-tiny", n_layers=2, d_model=256,
                        n_heads=4, n_kv_heads=2, d_ff=512, vocab=2048)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seq", type=int, default=None)
    p.add_argument("--rule", default="cada2")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args()

    device = resolve_device(args.device)
    cfg = LM_TINY if args.tiny else LM_100M
    steps = args.steps or (30 if args.tiny else 200)
    batch = args.batch or 8
    seq = args.seq or (64 if args.tiny else 256)
    m = args.workers
    print(f"model {cfg.name}: {param_count(cfg):,} params; "
          f"{steps} steps of {batch}x{seq} tokens on {m} workers, {device}")

    hp = TrainHParams(rule=CommRule(kind=args.rule, c=1.0, d_max=10,
                                    max_delay=50), lr=3e-4)
    step = make_train_step(cfg, hp, m)
    state = init_train_state(cfg, hp, m, 0, device)
    tokens = make_token_batches(cfg, global_batch=batch, seq=seq,
                                steps=steps)

    t0, losses, uploads = time.time(), [], 0
    for i in range(steps):
        bt = worker_split({"tokens": torch.from_numpy(tokens[i]).to(
            device=device, dtype=torch.long)}, m)
        state, mets = step(state, bt)
        losses.append(float(mets["loss"]))
        uploads += int(mets["uploads"])
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:4d} loss={losses[-1]:.4f} "
                  f"skip={float(mets['skip_rate']):.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss {first:.3f} -> {last:.3f}; uploads {uploads}/{steps * m}"
          f" ({1 - uploads / (steps * m):.0%} skipped)")
    assert last < first, "training must reduce the loss"


if __name__ == "__main__":
    main()
