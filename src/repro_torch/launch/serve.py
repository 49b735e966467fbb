"""Serving launcher: prefill a batch of random prompts, then lock-step
decode (the port of the JAX package's ``launch/serve.py``).

    python -m repro_torch.launch.serve --arch zamba2-2.7b --batch 2 \\
        --prompt-len 2048 --tokens 32               # on the card
    python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke \\
        --device cpu

Weights and prompts are drawn from ``--seed`` with explicit
``torch.Generator``s. Prefill and decode are timed on the host clock around
work that ends in ``torch.cuda.synchronize()`` (on the card).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.models.model import decode_step, init_params, prefill


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts, n_tokens: int, *,
             temperature: float = 0.0, generator=None) -> dict:
    """Prefill ``prompts`` (B, S) at a cache width of S + n_tokens, then
    ``n_tokens`` lock-step decode steps. As in the reference, the token fed
    to each step is sampled at ``temperature`` from the last logits (the
    argmax when it is 0) and the recorded token is each step's argmax.

    Returns {"prefill_logits" (B, V), "cache", "logits" (last step's),
    "tokens" (B, n_tokens), "prefill_s", "decode_s"}.
    """
    device = prompts.device
    s = prompts.shape[1]
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, prompts, max_seq=s + n_tokens)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    out = []
    t0 = time.perf_counter()
    next_tok = torch.argmax(logits, dim=-1)
    for _ in range(n_tokens):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        logits, cache = decode_step(cfg, params, cache, next_tok)
        next_tok = torch.argmax(logits, dim=-1)
        out.append(next_tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    tokens = (torch.stack(out, dim=1) if out else
              torch.empty((prompts.shape[0], 0), dtype=torch.long,
                          device=device))
    return {"prefill_logits": prefill_logits, "cache": cache,
            "logits": logits, "tokens": tokens, "prefill_s": prefill_s,
            "decode_s": decode_s}


def random_prompts(cfg, batch: int, seq: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True, choices=C.list_archs())
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cfg = (C.get_smoke_config(args.arch) if args.smoke
           else C.get_config(args.arch))
    device = resolve_device(args.device)
    b, s = args.batch, args.prompt_len
    params = init_params(cfg, args.seed, device)
    prompts = random_prompts(cfg, b, s, args.seed + 1, device)
    sampler = torch.Generator(device=device).manual_seed(args.seed + 2)
    out = generate(cfg, params, prompts, args.tokens,
                   temperature=args.temperature, generator=sampler)
    print(f"prefill({b}x{s}) on {device}: {out['prefill_s']:.3f}s logits "
          f"{tuple(out['prefill_logits'].shape)}")
    dt = out["decode_s"]
    rate = args.tokens * b / dt if dt > 0 else float("inf")
    print(f"decoded {args.tokens} tokens x {b} seqs in {dt:.3f}s "
          f"({rate:.1f} tok/s)")
    print("sample token ids:", out["tokens"][0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
