"""Batched serving with the PyTorch port: prefill a prompt batch, decode
with the ring-buffer KV / SSM state caches, and compare an attention arch
with an attention-free SSM (falcon-mamba family: O(1) decode state). Runs
on the card by default:

    PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse
import time

import torch

import repro_torch.configs as C
from repro_torch.device import resolve_device
from repro_torch.models.model import decode_step, init_params, prefill


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, device, batch=4, prompt=48, new_tokens=24) -> None:
    cfg = C.get_smoke_config(arch)
    params = init_params(cfg, 0, device)
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                         device=device)
    max_seq = prompt + new_tokens

    t0 = time.time()
    logits, cache = prefill(cfg, params, tokens=toks, max_seq=max_seq)
    _sync(device)
    t_prefill = time.time() - t0

    cache_bytes = sum(x.numel() * x.element_size()
                      for x in (cache.k, cache.v, cache.conv, cache.ssm)
                      if x is not None)
    nxt = torch.argmax(logits, dim=-1)
    out = [nxt]
    t0 = time.time()
    for _ in range(new_tokens):
        logits, cache = decode_step(cfg, params, cache, tokens=nxt)
        nxt = torch.argmax(logits, dim=-1)
        out.append(nxt)
    _sync(device)
    t_decode = time.time() - t0
    print(f"{arch:22s} prefill {t_prefill:5.2f}s | "
          f"{new_tokens} tokens in {t_decode:5.2f}s "
          f"({batch * new_tokens / t_decode:6.1f} tok/s) | "
          f"cache {cache_bytes / 1e6:.2f} MB ({device})")


def main(device=None) -> None:
    device = resolve_device(device)
    print("batched serving: GQA-attention vs attention-free SSM vs hybrid")
    for arch in ("internlm2-1.8b", "falcon-mamba-7b", "zamba2-2.7b"):
        serve(arch, device)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    main(p.parse_args().device)
