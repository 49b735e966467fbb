"""The frozen arithmetic (``bench/flops.py``) against hand-worked small
cases, and against the bounds ``PERF.md`` §6 states at the trainer's and
the served shapes."""
from __future__ import annotations

import pytest

from bench import flops as F

H100 = F.PEAKS["NVIDIA H100 80GB HBM3"]
N_TRAIN = 616_581_120          # stablelm-1.6b at 4 of 24 layers


def test_live_pairs():
    assert [F.live_pairs(s) for s in (1, 2, 4)] == [1, 3, 10]


def test_cada_kernels_by_hand():
    # θ, h, v̂, ∇ read and θ', h', v̂' written, 4 bytes each
    assert F.amsgrad_work(10) == (120.0, 280.0)
    # two (2, 10) fp32 planes read, 2 fp32 norms written
    assert F.row_sq_work(2, 10) == (60.0, 168.0)
    assert F.row_sq_work(2, 10, operands=1) == (40.0, 88.0)
    # a (2, 10) plane read, a (10,) row written
    assert F.row_mean_work(2, 10) == (20.0, 120.0)


def test_flash_by_hand():
    # B=1, S=4 (10 live pairs), 2 query heads on 1 KV head of hd 8:
    # 4·8·10·2 operations; Q and O 2·(1·4·2·8), K and V 2·(1·4·1·8) bf16
    assert F.flash_work(1, 4, 2, 1, 8) == (640.0, 384.0)


def test_dense_forward_by_hand():
    m = {"n_layers": 1, "d_model": 4, "vocab": 10, "n_heads": 2,
         "n_kv_heads": 2, "d_ff": 8, "mlp_act": "swiglu"}
    # a token: 2·(attention 4·4·4 + MLP 3·4·8 + head 4·10) = 2·200;
    # attention products 4·hd(2)·heads(2) = 16 a pair, 3 pairs at S=2
    assert F.dense_forward_flops(m, batch=1, seq=2) == 2 * 400 + 16 * 3
    assert F.train_step_flops(m, 1, 2, 2) == 6 * (2 * 400 + 16 * 3)


def test_dense_prefill_by_hand():
    m = {"n_layers": 1, "d_model": 4, "vocab": 10, "n_heads": 2,
         "n_kv_heads": 1, "d_ff": 8, "mlp_act": "swiglu"}
    # a token: 2·(attention 2·4·4 + 2·4·2 + MLP 3·4·8) = 2·144; the
    # attention products 4·hd(2)·heads(2) = 16 a pair, 6 pairs at S=3;
    # the head 2·4·10 at the last position only
    assert F.dense_prefill_flops(m, 3) == 3 * 2 * 144 + 16 * 6 + 80


@pytest.mark.parametrize("work,ms", [
    (F.amsgrad_work(N_TRAIN), 5.154),            # PERF.md §6, trainer size
    (F.row_sq_work(2, N_TRAIN), 2.945),
    (F.row_mean_work(2, N_TRAIN), 2.209),
    (F.flash_work(2, 2048, 32, 32, 80), 0.0434),        # by its operations
])
def test_bounds_match_the_kernel_table(work, ms):
    assert F.bound_s(*work, H100) * 1e3 == pytest.approx(ms, rel=2e-3)


def test_step_flops_at_the_cells_sizes():
    stablelm = {"n_layers": 4, "d_model": 2048, "vocab": 100352,
                "n_heads": 32, "n_kv_heads": 32, "d_ff": 5632,
                "mlp_act": "swiglu"}
    assert F.train_step_flops(stablelm, 4, 2048, 2) == pytest.approx(
        42.06e12, rel=1e-3)
    assert F.train_step_flops(stablelm, 2, 512, 2) == pytest.approx(
        5.10e12, rel=2e-3)
