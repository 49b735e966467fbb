"""Serving-side step builders: sharded prefill and lock-step batched decode
on a mesh of ranks (the JAX package's ``distributed/serving.py``).

The reference hands whole arrays and their shardings to ``jax.jit`` and
GSPMD inserts the collectives. Here each rank holds its own shards and
the model code performs those collectives itself through a
``TPContext`` (``distributed/sharding.py``):

  * the ``model`` axis is tensor parallelism (TP): attention heads, FFN
    hidden, MoE experts (expert-parallel where they divide the axis, else
    TP inside each expert), Mamba d_inner and SSM heads, the vocab of
    embed/lm_head; each falls back to replication where its dim does not
    divide, and a replicated tensor takes no collective;
  * the data axes (("pod", "data")) cut the batch, guarded by
    divisibility; the logits come back whole on every rank, as the
    reference's ``out_shardings=None``;
  * parameters never use FSDP (``_serving_param_pspecs``).

A step takes the rank's parameter shards (``shard_params``), the rank's
cache shards (what the prefill step returns, or ``shard_cache`` of a
whole cache) and the WHOLE inputs, which every rank passes alike and the
step cuts to its rows (``shard_batch``); it returns the whole logits and
the rank's cache shards. Every rank of the mesh calls the builders and
the steps in the same order (their collectives are the world's).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (  # noqa: F401
    TPContext, _serving_param_pspecs, batch_pspecs, shard_batch,
    spec_axes)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, init_cache, prefill


def _context(cfg: ModelConfig, mesh, batch_sds: dict) -> TPContext:
    """The step's ``TPContext``, with the data axes that ``batch_pspecs``
    cuts the batch dim of its inputs over."""
    specs = batch_pspecs(batch_sds, mesh)
    name = next(k for k in specs if k != "positions")
    return TPContext(cfg, mesh, spec_axes(specs[name][0]))


def jit_prefill_step(cfg: ModelConfig, mesh, batch_sds: dict, *,
                     max_seq: int | None = None):
    """prefill: (params shards, whole inputs) -> (last logits (B, V) whole,
    the rank's cache shards primed at S). ``batch_sds``: the inputs'
    shapes and dtypes (meta tensors, ``configs.base.input_specs``).
    ``max_seq`` (the port's addition) primes the cache at a decode width
    above S, as the reference's launcher does with a plain prefill; by
    default it is S, as in the reference's builder."""
    tp = _context(cfg, mesh, batch_sds)

    def step(params, inputs):
        local = shard_batch(inputs, mesh)
        logits, cache = prefill(cfg, params, tokens=local.get("tokens"),
                                embeds=local.get("embeds"),
                                positions=local.get("positions"),
                                max_seq=max_seq, tp=tp)
        return tp.gather_batch(logits), cache

    return step


def jit_decode_step(cfg: ModelConfig, mesh, batch: int, seq: int):
    """A single-token decode step against a cache primed at ``seq``.

    Returns (step, cache_sds, inputs_sds): the WHOLE cache's and inputs'
    shapes as meta tensors (the reference's ``eval_shape`` results), and
    the step (params shards, cache shards, whole inputs) -> (logits
    (B, V) whole, the rank's cache shards at index + 1)."""
    cache_sds = init_cache(cfg, batch, seq, device="meta")
    if cfg.embed_input:
        inputs_sds = {"tokens": torch.empty((batch,), dtype=torch.int32,
                                            device="meta")}
    else:
        inputs_sds = {"embeds": torch.empty((batch, 1, cfg.d_model),
                                            dtype=cfg.torch_dtype,
                                            device="meta")}
    tp = _context(cfg, mesh, inputs_sds)

    def step(params, cache, inputs):
        local = shard_batch(inputs, mesh)
        logits, cache = decode_step(cfg, params, cache,
                                    tokens=local.get("tokens"),
                                    embeds=local.get("embeds"), tp=tp)
        return tp.gather_batch(logits), cache

    return step, cache_sds, inputs_sds
