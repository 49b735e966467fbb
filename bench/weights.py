"""The cell's weights, drawn on the card from ``--seed`` by the benchmark
and handed alike to the program and to the plain reference.

The tree's paths, shapes and dtypes are the program's
(``repro_torch.models.model.abstract_params``: the names under which the
system takes its parameters). What is drawn into each leaf is the
configuration file's ``init``: a list of ``[pattern, rule]`` pairs, the
first pattern (``fnmatch`` over the leaf's ``/``-joined path) that
matches giving the rule:

  ``{"normal": std}``             N(0, std²)
  ``{"const": v}``                v everywhere
  ``{"uniform": [lo, hi]}``       U(lo, hi)
  ``{"log_uniform": [lo, hi]}``   log U(lo, hi) (Mamba2's A_log)
  ``{"dt_bias": [lo, hi, floor]}``  softplus⁻¹ of Δ = exp U(log lo, log hi),
                                  Δ ≥ floor (Mamba2's Δ bias)

Draws are made in a few large calls: one normal buffer per dtype and one
uniform buffer, cut into the leaves in path order.
"""
from __future__ import annotations

import fnmatch
import math

import torch

_ALIGN = 64   # elements: every leaf starts 128-byte aligned in bf16


def flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": tensor} of a nested dict, keys in sorted order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def rule_for(path: str, init: list) -> dict:
    for pattern, rule in init:
        if fnmatch.fnmatchcase(path, pattern):
            return rule
    raise ValueError(f"no init rule matches the leaf {path!r}")


def _padded(n: int) -> int:
    return n + (-n) % _ALIGN


def draw(shapes: dict, init: list, seed: int, device) -> dict:
    """{path: tensor} for ``shapes`` ({path: (shape, dtype)}), drawn on
    ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)
    rules = {p: rule_for(p, init) for p in shapes}
    out = {}
    normal = {}
    for p, (shape, dtype) in shapes.items():
        if "normal" in rules[p]:
            normal.setdefault(dtype, []).append(p)
    for dtype in sorted(normal, key=str):
        paths = normal[dtype]
        total = sum(_padded(math.prod(shapes[p][0])) for p in paths)
        buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for p in paths:
            shape = shapes[p][0]
            n = math.prod(shape)
            out[p] = buf[off:off + n].view(shape).mul_(rules[p]["normal"])
            off += _padded(n)
    uni = [p for p in shapes if any(k in rules[p] for k in
                                    ("uniform", "log_uniform", "dt_bias"))]
    total = sum(_padded(math.prod(shapes[p][0])) for p in uni)
    buf = torch.rand(max(total, 1), generator=gen, dtype=torch.float32,
                     device=device)
    off = 0
    for p in uni:
        shape, dtype = shapes[p]
        n = math.prod(shape)
        u = buf[off:off + n].view(shape)
        off += _padded(n)
        rule = rules[p]
        if "uniform" in rule:
            lo, hi = rule["uniform"]
            v = lo + (hi - lo) * u
        elif "log_uniform" in rule:
            lo, hi = rule["log_uniform"]
            v = torch.log(lo + (hi - lo) * u)
        else:
            lo, hi, floor = rule["dt_bias"]
            dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
            dt = dt.clamp_min(floor)
            v = dt + torch.log(-torch.expm1(-dt))
        out[p] = v.to(dtype)
    for p, (shape, dtype) in shapes.items():
        if "const" in rules[p]:
            out[p] = torch.full(shape, float(rules[p]["const"]), dtype=dtype,
                                device=device)
    missing = set(shapes) - set(out)
    if missing:
        raise ValueError(f"rules give no draw for {sorted(missing)}")
    return {p: out[p] for p in shapes}


def program_shapes(model_cfg) -> dict:
    """{path: (shape, dtype)} of the program's parameter tree."""
    from repro_torch.models.model import abstract_params
    return {p: (tuple(t.shape), t.dtype)
            for p, t in flatten(abstract_params(model_cfg)).items()}
