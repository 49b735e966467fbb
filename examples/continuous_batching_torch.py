"""Serve a stream of variable-length requests through the PyTorch port's
fixed-slot continuous-batching scheduler (``distributed/scheduler.py``).
Runs on the card by default:

    PYTHONPATH=src python examples/continuous_batching_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.device import resolve_device
from repro_torch.distributed.scheduler import DecodeScheduler, Request
from repro_torch.models.model import init_params


def main(device=None) -> None:
    device = resolve_device(device)
    cfg = C.get_smoke_config("stablelm-1.6b")
    params = init_params(cfg, 0, device)
    sched = DecodeScheduler(cfg, params, n_slots=4, max_seq=96)

    rng = np.random.default_rng(0)
    for uid in range(10):
        sched.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab, rng.integers(4, 24),
                                dtype=np.int32),
            max_new=int(rng.integers(4, 16))))

    t0 = time.time()
    done = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {tokens} tokens in {dt:.1f}s "
          f"({tokens / dt:.1f} tok/s, slot utilization "
          f"{sched.utilization():.0%}, {device})")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt {len(r.prompt)} -> {r.out[:8]}...")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    main(p.parse_args().device)
