"""Small models of the paper's own experiments (§4): logistic regression, an
MLP and a CNN, as pure functions on dicts of tensors.

``init(generator, ...) -> params`` draws on the CPU from a
``torch.Generator`` (None means the global one) and moves the result to
``device`` (None means ``cuda``), so one seed gives the same weights on every device;
``apply(params, x) -> logits``. Losses are cross-entropy plus the paper's ℓ2
regularizer λ=1e-5 over the leaves in sorted-key order, as in the
reference.

The CNN keeps the reference's parameter names and layouts (HWIO kernels,
``w1`` rows in NHWC order) and takes NHWC input, so weights carry over
between the packages unchanged. It assumes fp32 convolutions: on the card
cuDNN runs fp32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, which a caller that wants the
reference's numbers sets (``chip_smoke.py`` does, for the whole run).
"""
from __future__ import annotations

import math

import numpy as np
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


# ---------------------------------------------------------------- CNN
# The paper's two convolution-ELU-maxpool layers and two FC layers, at the
# reference's widths (c1 8, c2 16, fc 64: 54,314 parameters at 28×28).

def cnn_init(generator, n_classes: int = 10, c1: int = 8, c2: int = 16,
             fc: int = 64, hw: int = 28, in_ch: int = 1, device=None):
    """``w1``'s rows are the pooled features, ⌈hw/4⌉²·c2: the reference's
    hw // 4 wherever hw is a multiple of 4 (the paper's 28 included);
    for another hw the reference's own features do not fit its w1."""
    device = resolve_device(device)
    hw4 = -(-hw // 4)
    flat = hw4 * hw4 * c2
    conv1 = torch.randn((5, 5, in_ch, c1), generator=generator) * 0.1
    conv2 = torch.randn((5, 5, c1, c2), generator=generator) * 0.1
    w1 = torch.randn((flat, fc), generator=generator) / math.sqrt(flat)
    w2 = torch.randn((fc, n_classes), generator=generator) / math.sqrt(fc)
    return {
        "conv1": conv1.to(device),
        "bc1": torch.zeros((c1,), device=device),
        "conv2": conv2.to(device),
        "bc2": torch.zeros((c2,), device=device),
        "w1": w1.to(device),
        "b1": torch.zeros((fc,), device=device),
        "w2": w2.to(device),
        "b2": torch.zeros((n_classes,), device=device),
    }


def _conv_same(h, kernel_hwio, bias):
    """"SAME" convolution at stride 1 of an NCHW input with an HWIO kernel
    (for the 5×5 kernels, 2 on every side)."""
    return (F.conv2d(h, kernel_hwio.permute(3, 2, 0, 1), padding="same")
            + bias[:, None, None])


def _maxpool2(h):
    """2×2 max pool at stride 2, "SAME": an odd side is padded at its end
    with −inf (what ``ceil_mode`` does), as the reference's
    ``reduce_window``."""
    return F.max_pool2d(h, 2, 2, ceil_mode=True)


def cnn_apply(params, x):
    """Logits of an NHWC batch (…, hw, hw, in_ch). Convolution and pooling
    run in NCHW; the features are permuted back to NHWC before the flatten
    that feeds ``w1``, so they line up with its rows."""
    h = x.permute(0, 3, 1, 2)
    h = _maxpool2(F.elu(_conv_same(h, params["conv1"], params["bc1"])))
    h = _maxpool2(F.elu(_conv_same(h, params["conv2"], params["bc2"])))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.elu(h @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def cnn_loss(params, batch, l2: float = L2_COEFF):
    x, y = batch
    return _xent(cnn_apply(params, x), y) + _l2(params, l2)


def make_problem(kind: str, generator, example_x, n_classes: int,
                 device=None):
    """``(params, loss_fn(params, batch))`` of the paper's problem
    ``kind`` ("logreg", "mlp" or "cnn") for inputs shaped like
    ``example_x`` (leading batch axis)."""
    shape = tuple(example_x.shape)
    if kind == "logreg":
        return (logreg_init(generator, shape[-1], n_classes, device),
                logreg_loss)
    if kind == "mlp":
        return (mlp_init(generator, int(np.prod(shape[1:])), 64, n_classes,
                         device), mlp_loss)
    if kind == "cnn":
        return (cnn_init(generator, n_classes, hw=shape[1], in_ch=shape[-1],
                         device=device), cnn_loss)
    raise ValueError(f"unknown problem kind: {kind}")
