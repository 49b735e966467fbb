"""The yardstick's arithmetic of a decoder with a per-layer pattern of
Mamba2 and attention mixers (granite-4.0-h), beside ``bench/flops.py``'s
of the dense decoders: the FLOPs a prompt's prefill requires and the
bytes and operations of the per-head selective scan's function at a
launch's operand shapes. Frozen here, so that a change to the program
cannot change what it is measured against; each count is checked against
a hand-worked case in ``bench/test_bench_hybrid.py``.

The scan's function is the recurrence h_t = exp(Δ_t A) h_{t−1} + Δ_t x_t
⊗ B_t, y_t = h_t C_t per head, whose least work on the tensor cores is
its chunked form (Mamba2's state-space duality) at ``SCAN_CHUNK`` steps,
every product counted once, without a kernel's split of its operands into
pieces: C·Bᵀ over the causal pairs of each chunk (2N a pair, once a batch
row: the heads share B and C), M'·X over the same pairs (2P a pair and
head), and per step and head the state's read C·h_prevᵀ and its update
Wᵀ·X (2NP each). Its bytes: x, B, C and Δ read once, y and h_final
written once; y in the operands' dtype, as the mixer consumes it (a
kernel that stores y in fp32 pays for the wider store in its share), and
h_final in fp32, the decode cache's state.
"""
from __future__ import annotations

from bench.flops import DTYPE_BYTES, live_pairs

SCAN_CHUNK = 64


def kinds(m: dict) -> tuple[int, int]:
    """(attention layers, Mamba2 layers) of the pattern."""
    n_attn = list(m["layer_types"]).count("attention")
    return n_attn, len(m["layer_types"]) - n_attn


def scan_shape(m: dict) -> tuple[int, int, int]:
    """(heads H, head width P, state N) of the Mamba2 layers."""
    di = m["ssm_expand"] * m["d_model"]
    return di // m["mamba_headdim"], m["mamba_headdim"], m["ssm_state"]


def chunk_pairs(s: int, chunk: int = SCAN_CHUNK) -> int:
    """(t, s ≤ t) pairs inside the chunks of a scan of ``s`` steps."""
    full, rest = divmod(s, chunk)
    return full * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2


def scan_work(g: int, s: int, h: int, p: int, n: int,
              dtype: str = "bfloat16",
              chunk: int = SCAN_CHUNK) -> tuple[float, float]:
    """(ops, bytes) of the per-head scan over ``g`` rows of ``s`` steps,
    ``h`` heads of ``p`` channels and ``n`` states (module docstring):
    x, B, C in ``dtype``, Δ fp32 read; y in ``dtype`` and h_final fp32
    written."""
    pairs = chunk_pairs(s, chunk)
    ops = g * (2 * n * pairs + h * (2 * p * pairs + 4 * n * p * s))
    e = DTYPE_BYTES[dtype]
    nbytes = (e * g * s * (2 * h * p + 2 * n) + 4 * g * s * h
              + 4 * g * h * p * n)
    return float(ops), float(nbytes)


def projection_params(m: dict) -> int:
    """Weights of every layer's products a token passes through: each
    Mamba2 mixer's in-projection (z, x, B, C, Δ) and ``out_proj``, each
    attention mixer's q, k, v and o, every layer's SwiGLU MLP."""
    n_attn, n_ssm = kinds(m)
    d, hq, hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
    hd, di = m["head_dim"], m["ssm_expand"] * m["d_model"]
    nh, _, n = scan_shape(m)
    mixer = d * (2 * di + 2 * n + nh) + di * d
    attn = 2 * d * hq * hd + 2 * d * hkv * hd
    mlp = 3 * d * m["d_ff"]
    return n_ssm * mixer + n_attn * attn + (n_attn + n_ssm) * mlp


def hybrid_prefill_flops(m: dict, prompt: int) -> float:
    """Forward FLOPs of one prompt's prefill of ``prompt`` tokens (no
    padding): every projection (2 a multiply-add), the attention layers'
    causal products (4·hd a pair and query head), the scans' products
    (:func:`scan_work`) and the tied head at the last position."""
    n_attn, n_ssm = kinds(m)
    h, p, n = scan_shape(m)
    attn = n_attn * 4 * m["head_dim"] * m["n_heads"] * live_pairs(prompt)
    scan = n_ssm * scan_work(1, prompt, h, p, n)[0]
    return float(2 * prompt * projection_params(m) + attn + scan
                 + 2 * m["d_model"] * m["vocab"])
