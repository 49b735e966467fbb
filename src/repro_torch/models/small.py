"""Small models of the paper's own experiments (§4): logistic regression and
an MLP, as pure functions on dicts of tensors.

``init(generator, ...) -> params`` draws on the CPU from a
``torch.Generator`` (None means the global one) and moves the result to
``device`` (None means ``cuda``), so one seed gives the same weights on every device;
``apply(params, x) -> logits``. Losses are cross-entropy plus the paper's ℓ2
regularizer λ=1e-5 over the leaves in sorted-key order, as in the
reference. The CNN is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

L2_COEFF = 1e-5  # paper §13.2.1


def _xent(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


def _l2(params, coeff):
    return coeff * sum(torch.sum(params[k] * params[k])
                       for k in sorted(params))


# ---------------------------------------------------------------- logistic

def logreg_init(generator, dim: int, n_classes: int, device=None):
    del generator
    device = resolve_device(device)
    return {
        "w": torch.zeros((dim, n_classes), dtype=torch.float32,
                         device=device),
        "b": torch.zeros((n_classes,), dtype=torch.float32, device=device),
    }


def logreg_apply(params, x):
    return x @ params["w"] + params["b"]


def logreg_loss(params, batch, l2: float = L2_COEFF):
    x, y = batch
    return _xent(logreg_apply(params, x), y) + _l2(params, l2)


# ---------------------------------------------------------------- MLP

def mlp_init(generator, dim: int, hidden: int, n_classes: int, device=None):
    device = resolve_device(device)
    w1 = torch.randn((dim, hidden), generator=generator) / math.sqrt(dim)
    w2 = torch.randn((hidden, n_classes), generator=generator) / math.sqrt(
        hidden)
    return {
        "w1": w1.to(device),
        "b1": torch.zeros((hidden,), device=device),
        "w2": w2.to(device),
        "b2": torch.zeros((n_classes,), device=device),
    }


def mlp_apply(params, x):
    x = x.reshape(x.shape[0], -1)
    h = F.elu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_loss(params, batch, l2: float = L2_COEFF):
    x, y = batch
    return _xent(mlp_apply(params, x), y) + _l2(params, l2)
