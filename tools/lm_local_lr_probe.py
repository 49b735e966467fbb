"""Losses of the LM trainer with the delta-payload rules over a grid of
local step sizes, on the card.

    python3 tools/lm_local_lr_probe.py [--steps 8] [--local-lr 0.1 0.01 0.001]

The run of ``chip_smoke.py`` phase 8e (``chip_smoke.delta_run``: its model
and cut, M, H, token batches and server step) for ``local_momentum`` and
``fedadam`` at each local lr: the mean loss of each step (over the
workers' local steps). Prints the card's name and power limit and one
line per (rule, local lr).
"""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--local-lr", type=float, nargs="+",
                   default=[0.1, 0.01, 0.001])
    args = p.parse_args()
    cs.phase_card()   # name and power limit; TF32 off
    cfg = cs.lm_configs.get_config(cs.TRAIN_ARCH).with_(
        n_layers=cs.TRAIN_LAYERS)
    tokens = cs.make_token_batches(cfg, global_batch=cs.TRAIN_BATCH,
                                   seq=cs.TRAIN_SEQ, steps=args.steps)
    for kind in cs.LOCAL_RULES:
        for llr in args.local_lr:
            losses = cs.delta_run(cfg, tokens, kind, llr, args.steps)[3]
            print(f"{kind} local_lr {llr}: losses "
                  + ", ".join(f"{v:.3f}" for v in losses), flush=True)
            gc.collect()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
