"""Input shapes, spec builders, and the architecture registry (the port's
copy of the JAX package's ``configs/base.py``).

The four assigned input shapes:
    train_4k     seq=4,096    global_batch=256   (training)
    prefill_32k  seq=32,768   global_batch=32    (inference-prefill)
    decode_32k   seq=32,768   global_batch=128   (inference-decode: 1 token,
                                                  KV/SSM state of length seq)
    long_500k    seq=524,288  global_batch=1     (long-context decode —
                                                  requires sub-quadratic
                                                  attention or SSM state)

``input_specs`` returns tensors on the ``meta`` device for every model input
of a (config, shape) pair: they carry shape and dtype and allocate nothing,
as the reference's ``ShapeDtypeStruct`` stand-ins do.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_cache

TRAIN, PREFILL, DECODE = "train", "prefill", "decode"


@dataclass(frozen=True)
class InputShape:
    name: str
    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, TRAIN),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, PREFILL),
    "decode_32k": InputShape("decode_32k", 32768, 128, DECODE),
    "long_500k": InputShape("long_500k", 524288, 1, DECODE),
}

LONG_CONTEXT_WINDOW = 8192  # sliding window of the full-attention archs
#                             for long_500k decode


def adapt_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config tweaks: full-attention archs switch to a sliding
    window for 500k-context decode (the sub-quadratic requirement)."""
    if shape.kind == DECODE and shape.seq > 65536 and not cfg.subquadratic:
        return cfg.with_(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Meta-device stand-ins for the step function's *data* arguments.

    train  -> {"tokens"} or {"embeds","labels"} (+ "positions" for M-RoPE)
    prefill-> same minus labels
    decode -> {"tokens"/"embeds"} one token + {"cache"} primed at seq.
    """
    cfg = adapt_for_shape(cfg, shape)
    b, s = shape.batch, shape.seq
    emb_dtype = cfg.torch_dtype

    def positions(seq):
        return _spec((3, b, seq), torch.int32) if cfg.mrope else None

    if shape.kind == TRAIN:
        if cfg.embed_input:
            specs = {"tokens": _spec((b, s + 1), torch.int32)}
        else:
            specs = {"embeds": _spec((b, s, cfg.d_model), emb_dtype),
                     "labels": _spec((b, s), torch.int32)}
        if cfg.mrope:
            specs["positions"] = positions(s)
        return {"batch": specs}

    if shape.kind == PREFILL:
        if cfg.embed_input:
            specs = {"tokens": _spec((b, s), torch.int32)}
        else:
            specs = {"embeds": _spec((b, s, cfg.d_model), emb_dtype)}
        if cfg.mrope:
            specs["positions"] = positions(s)
        return specs

    # decode: one new token against a cache primed at `seq`
    cache = init_cache(cfg, b, s, device="meta")
    if cfg.embed_input:
        return {"tokens": _spec((b,), torch.int32), "cache": cache}
    return {"embeds": _spec((b, 1, cfg.d_model), emb_dtype), "cache": cache}


# ------------------------------------------------------------- registry

_REGISTRY: dict[str, dict] = {}
# configurations the port has and the JAX package has not: resolved by
# name like the others, listed apart (``list_archs`` is the reference's)
_PORT_ONLY: dict[str, dict] = {}


def register(name: str, config_fn, smoke_fn, port_only: bool = False):
    table = _PORT_ONLY if port_only else _REGISTRY
    table[name] = {"config": config_fn, "smoke": smoke_fn}


def _entry(name: str) -> dict:
    return _REGISTRY[name] if name in _REGISTRY else _PORT_ONLY[name]


def get_config(name: str) -> ModelConfig:
    return _entry(name)["config"]()


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    cfg = _entry(name)["smoke"]()
    if cfg.n_layers > 2 or cfg.d_model > 512 or cfg.n_experts > 4:
        raise ValueError(f"{cfg.name} is not a smoke-sized config")
    return cfg


def list_archs() -> list[str]:
    """The JAX package's architectures, which the port holds to it."""
    return sorted(_REGISTRY)


def list_port_archs() -> list[str]:
    """The port's own architectures beside them."""
    return sorted(_PORT_ONLY)
