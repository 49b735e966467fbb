"""Quickstart for the PyTorch port: communication-adaptive distributed Adam.

Ten workers with heterogeneous (label-skewed) data fit a logistic
regression. CADA2 skips the uninformative uploads; distributed Adam uploads
every worker every step; LAQ gates on the energy of an 8-bit quantized
innovation and sends 8 bits per entry. Runs on the card by default:

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.engine import CADAEngine, make_sampler
from repro_torch.core.rules import CommRule
from repro_torch.data import dirichlet_partition, ijcnn1_like, pad_to_matrix
from repro_torch.models.small import logreg_init, logreg_loss
from repro_torch.optim.fused import FusedAMSGrad

M, ITERS = 10, 500


def main(device=None) -> None:
    ds = ijcnn1_like(n=8000)
    shards = pad_to_matrix(dirichlet_partition(ds.y, m=M, alpha=0.3, seed=0))
    sample = make_sampler(ds.x, ds.y, shards, batch_size=32, device=device)
    params = logreg_init(None, dim=ds.x.shape[1], n_classes=ds.n_classes,
                         device=device)
    for name, rule in [
        ("distributed Adam", CommRule(kind="always")),
        ("CADA2           ", CommRule(kind="cada2", c=0.6, d_max=10,
                                      max_delay=100)),
        ("LAQ, 8-bit wire ", CommRule(kind="laq", c=0.6, d_max=10,
                                      max_delay=100)),
    ]:
        engine = CADAEngine(logreg_loss, FusedAMSGrad(lr=0.01), rule,
                            n_workers=M, device=device)
        state = engine.init(params)
        gen = torch.Generator(device=engine.device).manual_seed(1)
        draws = [sample(gen) for _ in range(ITERS)]
        batches = tuple(torch.stack(b) for b in zip(*draws))
        state, metrics = engine.run(state, batches)
        loss = float(metrics["loss"][-20:].mean())
        uploads = int(metrics["uploads"].sum())
        sent = float(metrics["bytes_up"].sum())
        print(f"{name}  final loss {loss:.4f}   worker uploads "
              f"{uploads:5d} / {ITERS * M}   {sent / 1e3:7.1f} kB up   "
              f"({engine.device})")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    main(p.parse_args().device)
