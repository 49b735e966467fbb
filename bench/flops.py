"""The yardstick's arithmetic, frozen here so that a change to the program
cannot change what it is measured against: the card's peaks, the bytes and
operations each hand-written kernel's *function* needs at a launch's
operand shapes, and the FLOPs a model's forward and backward passes
require, counted from its widths.

A kernel's roofline share reads the same work whatever implements it:
each input is read once, each output written once, and the operations
are those of the function (a recurrence, a causal softmax product), never
those of one implementation's split into pieces. The bound of a launch is
the larger of its bytes over the card's bandwidth and its operations over
the card's bf16 tensor peak.

Each count is checked against a hand-worked case in
``bench/test_bench_flops.py``; ``PERF.md`` cites the bounds at the
trainer's and the served shapes.
"""
from __future__ import annotations

# NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at its 700 W
# limit: bf16 on the tensor cores and HBM3 bandwidth.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12,
                                   "bytes_per_s": 3.35e12}}

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}

# gradient evaluations a worker makes a step, by rule (paper §2.2): the
# two-iterate rules evaluate each sample twice; the others once
GRAD_EVALS = {"cada1": 2, "cada2": 2}


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least time a launch can take on the card."""
    return max(ops / peak["bf16_flops"], nbytes / peak["bytes_per_s"])


def live_pairs(s: int) -> int:
    """(query, key) pairs a causal attention of length ``s`` computes (a
    copy of the smoke script's ``_live_pairs`` without a window)."""
    return s * (s + 1) // 2


# ------------------------------------------------------------ CADA kernels

def amsgrad_work(n: int, plane: str = "float32",
                 moments: str = "float32") -> tuple[float, float]:
    """(ops, bytes) of the AMSGrad server step on n entries: θ, h, v̂ and ∇
    read, θ', h' and v̂' written (θ and ∇ fp32 planes); about a dozen
    operations an entry and one square root."""
    p, m = DTYPE_BYTES[plane], DTYPE_BYTES[moments]
    return 12.0 * n, float(n * (p + 2 * m + p) + n * (p + 2 * m))


def row_sq_work(rows: int, n: int, operands: int = 2,
                dtype: str = "float32") -> tuple[float, float]:
    """(ops, bytes) of the per-row squared norm of (rows, n) planes: one
    operand (Σa²) or two (Σ(a − b)²); the (rows,) fp32 result written."""
    return (float(operands + 1) * rows * n,
            float(operands * rows * n * DTYPE_BYTES[dtype] + 4 * rows))


def row_mean_work(rows: int, n: int,
                  dtype: str = "float32") -> tuple[float, float]:
    """(ops, bytes) of eq. (3)'s row mean: (rows, n) read, (n,) fp32
    written."""
    return float(rows * n), float(rows * n * DTYPE_BYTES[dtype] + 4 * n)


# ---------------------------------------------------------- serving kernels

def flash_work(b: int, s: int, hq: int, hkv: int, hd: int,
               dtype: str = "bfloat16") -> tuple[float, float]:
    """(ops, bytes) of causal self-attention: Q·Kᵀ and P·V over the live
    (query, key) pairs, 4·hd operations a pair and query head; Q, K, V
    read and O written once."""
    e = DTYPE_BYTES[dtype]
    ops = 4.0 * hd * live_pairs(s) * b * hq
    nbytes = e * b * s * hd * (2 * hq + 2 * hkv)
    return ops, float(nbytes)


# ------------------------------------------------------------ model FLOPs

def _attn_params(m: dict) -> int:
    d, hq = m["d_model"], m["n_heads"]
    hkv = m.get("n_kv_heads") or hq
    hd = m.get("head_dim") or d // hq
    return 2 * d * hq * hd + 2 * d * hkv * hd


def _mlp_params(m: dict) -> int:
    gated = m.get("mlp_act", "swiglu") in ("swiglu", "geglu")
    return (3 if gated else 2) * m["d_model"] * m["d_ff"]


def _attn_pair_flops(m: dict) -> int:
    """Forward operations of one attention layer a (query, key) pair."""
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    return 4 * hd * m["n_heads"]


def dense_forward_flops(m: dict, batch: int, seq: int) -> float:
    """Forward FLOPs of a dense decoder over ``batch`` sequences of ``seq``
    tokens, logits at every position: 2 a multiply-add of every projection
    (attention, MLP, the head), plus the causal attention products."""
    per_token = 2 * (m["n_layers"] * (_attn_params(m) + _mlp_params(m))
                     + m["d_model"] * m["vocab"])
    attn = m["n_layers"] * _attn_pair_flops(m) * live_pairs(seq)
    return float(batch * (seq * per_token + attn))


def train_step_flops(m: dict, global_batch: int, seq: int,
                     evals_per_worker: int) -> float:
    """FLOPs one trainer step requires: every gradient evaluation of every
    worker (cada2 evaluates each worker's sample twice) is a forward and
    a backward of twice its cost, over the global batch; the forward that
    rematerialisation recomputes is not counted."""
    return 3.0 * evals_per_worker * dense_forward_flops(m, global_batch, seq)


def dense_prefill_flops(m: dict, prompt: int) -> float:
    """Forward FLOPs of a dense decoder's prefill of one prompt of
    ``prompt`` tokens (no padding): every layer's projections and causal
    attention products, and the head at the last position only."""
    per_token = 2 * m["n_layers"] * (_attn_params(m) + _mlp_params(m))
    attn = m["n_layers"] * _attn_pair_flops(m) * live_pairs(prompt)
    return float(prompt * per_token + attn + 2 * m["d_model"] * m["vocab"])
