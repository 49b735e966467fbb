"""The hybrid serving cell's yardstick on the CPU: the benchmark's
reference (``bench/ref_granite_h.py``) against the port's plain route and
its controls and faults, the scan's and the prefill's counts
(``bench/flops_hybrid.py``) against hand-worked cases, the per-layer
readers on a built record, the loop (``bench/serve_hybrid.py``) at a
small size, and the new yardstick files importing nothing of the port."""
from __future__ import annotations

import dataclasses
import math
import time

import pytest
import torch

from bench import flops_hybrid as FH
from bench import ref_granite_h as RG
from bench import reference, serve_hybrid, weights
from bench.cell import ROOT, Record, load_cell, reader
from bench.devtrace import Trace
from bench.test_bench_imports import top_level_imports

CELL = "serve.granite-4.0-h-micro.prefill"
PEAK = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}
SMOKE = dict(n_layers=2, d_model=128, vocab=256,
             layer_types=["mamba2", "attention"], n_heads=4, n_kv_heads=2,
             head_dim=32, attn_scale=1 / 32, ssm_state=16, mamba_headdim=32,
             d_ff=256)


def small_cell(**model):
    cell = load_cell(CELL)
    cell.config["model"].update(SMOKE, **model)
    cell.traffic.update(clients=2, n_slots=2, min_len=16, max_len=64,
                        max_seq=65, cycle=8, check_requests=8)
    return cell


def _theta(cell, seed=3, dtype=None):
    from repro_torch.models.config import PatternConfig
    cfg = PatternConfig(**cell.config["model"])
    if dtype is not None:
        cfg = cfg.with_(dtype=dtype)
    return cfg, weights.draw(weights.program_shapes(cfg), cell.config["init"],
                             seed, torch.device("cpu"))


def _tokens(cfg, n=300, seed=4):
    return torch.randint(0, cfg.vocab, (2, n),
                         generator=torch.Generator().manual_seed(seed))


def test_the_reference_follows_the_ports_prefill():
    """The port's plain route in fp32 against the benchmark's reference,
    at a float32 copy of the cell (its init rules, smoke widths)."""
    from repro_torch.models.model import prefill
    cfg, theta = _theta(small_cell(), dtype="float32")
    toks = _tokens(cfg, n=70)
    port = prefill(cfg, weights.unflatten(theta), toks)[0]
    ref = RG.last_logits(theta, dataclasses.asdict(cfg), toks)
    assert torch.allclose(port, ref, rtol=0, atol=1e-5 * ref.abs().max())


def test_the_fp8_control_moves_the_logits():
    cfg, theta = _theta(small_cell(), dtype="float32")
    toks = _tokens(cfg)
    m = dataclasses.asdict(cfg)
    want = RG.last_logits(theta, m, toks)
    got = RG.last_logits(theta, m, toks,
                         RG.Variant(num=reference.Numerics(fp8=True)))
    assert float((got - want).abs().max()) > 1e-3 * float(want.abs().max())


def test_the_other_controls_and_faults_move_their_layers():
    """At the smoke widths these barely reach the logits (the card's
    readings at the cell's size are in PERF.md); each moves its own
    layer's output on unit-scale inputs: the scan's state rounded at its
    chunks' ends (600 steps: two), the attention's scores at 1/√hd for
    1/hd, B and C left unconvolved."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, 600, 3, 8, generator=g)
    dt = torch.rand(1, 600, 3, generator=g) * 0.05
    a = -torch.tensor([0.5, 1.0, 2.0])
    bm, cm = (torch.randn(1, 600, 16, generator=g) for _ in range(2))
    want = RG.ssd_scan(x, dt, a, bm, cm, RG.PLAIN)
    got = RG.ssd_scan(x, dt, a, bm, cm, RG.Variant(state_bf16=True))
    assert float((got - want).abs().max()) > 1e-4 * float(want.abs().max())
    m = dict(SMOKE)
    p = {k: torch.randn(128, 128 if k in ("wq", "wo") else 64, generator=g)
         * 0.1 for k in ("wq", "wk", "wv", "wo")}
    h = torch.randn(1, 50, 128, generator=g)
    want = RG.attention(h, p, m, RG.PLAIN)
    got = RG.attention(h, p, m, RG.Variant(scale=32 ** -0.5))
    assert float((got - want).abs().max()) > 1e-2 * float(want.abs().max())
    _, theta = _theta(small_cell(), dtype="float32")
    lp = {k: (v * 10 if k.startswith("in_") else v) for k, v in
          reference.layer(theta, "blocks/", 0).items()}
    want = RG.mamba2(h, lp, m | {"ssm_expand": 2, "norm_eps": 1e-5}, RG.PLAIN)
    got = RG.mamba2(h, lp, m | {"ssm_expand": 2, "norm_eps": 1e-5},
                    RG.Variant(conv_bc=False))
    assert float((got - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_chunk_pairs_and_scan_work_by_hand():
    # 3 steps in chunks of 2: pairs (0,0) (1,0) (1,1) | (2,2) = 4
    assert FH.chunk_pairs(3, 2) == 4
    assert FH.chunk_pairs(64) == 64 * 65 // 2
    assert FH.chunk_pairs(130) == 2 * 2080 + 3
    # g 1, s 3, h 1, p 2, n 2, chunks of 2: C·Bᵀ 2·2·4 = 16; M'·X 2·2·4
    # = 16; C·h and Wᵀ·X 4·2·2·3 = 48
    ops, nbytes = FH.scan_work(1, 3, 1, 2, 2, chunk=2)
    assert ops == 80
    # x 3·2, B, C 2·3·2 and y 3·2 bf16 (2 bytes); Δ 3 fp32 (4); h_final
    # 2·2 fp32
    assert nbytes == 2 * (6 + 12 + 6) + 4 * 3 + 4 * 4 == 76
    ops, nbytes = FH.scan_work(2, 3, 1, 2, 2, dtype="float32", chunk=2)
    assert (ops, nbytes) == (160, 4 * (6 + 12 + 6) * 2 + 4 * 6 + 4 * 8)


def test_the_prefill_count_by_hand():
    """A toy pattern: one Mamba2 layer and one attention layer, d 4, vocab
    10, d_ff 6, 2 query heads on 1 K/V head of 2; Mamba2 d_inner 8 as 2
    heads of 4, N 2. A prompt of 3 tokens."""
    m = {"layer_types": ["mamba2", "attention"], "d_model": 4, "vocab": 10,
         "d_ff": 6, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2,
         "ssm_expand": 2, "mamba_headdim": 4, "ssm_state": 2}
    mixer = 4 * (2 * 8 + 2 * 2 + 2) + 8 * 4          # 88 + 32 = 120
    attn = 2 * 4 * 2 * 2 + 2 * 4 * 1 * 2             # 32 + 16 = 48
    mlp = 3 * 4 * 6                                  # 72 each layer
    assert FH.projection_params(m) == mixer + attn + 2 * mlp == 312
    # scan at 64-step chunks: 6 pairs; C·Bᵀ 2·2·6 = 24; per head M'·X
    # 2·4·6 = 48 and C·h, Wᵀ·X 4·2·4·3 = 96: 24 + 2·144 = 312
    assert FH.scan_work(1, 3, 2, 4, 2)[0] == 312
    # attention 4·hd·heads a pair, 6 pairs: 4·2·2·6 = 96; head 2·4·10
    assert FH.hybrid_prefill_flops(m, 3) == 2 * 3 * 312 + 96 + 312 + 80


def test_the_cell_count_at_the_published_widths():
    """granite-4.0-h-micro: 2,984,771,584 weights a token passes through
    (36 mixers of 25,821,184, 4 attention layers of 10,485,760, 40 MLPs
    of 50,331,648), about 2.985 B."""
    m = load_cell(CELL).config["model"]
    assert FH.projection_params(m) == 2_984_771_584
    assert FH.kinds(m) == (4, 36)
    assert FH.scan_shape(m) == (64, 64, 128)


class FakeProgramTrace(Trace):
    """A device trace with the program's spans, as
    ``progtrace.ProgramTrace`` gives it: device seconds launched inside
    each span."""

    def __init__(self, ops, by_span):
        super().__init__(ops=ops, spans=[], start_us=0.0, end_us=1e6)
        self.by_span = by_span

    def launched_in(self, *patterns):
        return sum(s for k, s in self.by_span.items() if k in patterns)


def _record(trace=None):
    m = load_cell(CELL).config["model"]
    return Record(kind="serve", model=m, traffic={}, peak=PEAK,
                  window_s=2.0,
                  requests=[(0, 512, 7845, 1.0, 3), (1, 4096, 7845, 1.0, 5),
                            (2, 100, 7845, 1.0, None)],
                  trace=trace)


def test_the_readers_on_a_built_record():
    rec = _record()
    want = 100.0 * (FH.hybrid_prefill_flops(rec.model, 512)
                    + FH.hybrid_prefill_flops(rec.model, 4096)) / (2.0 * 989e12)
    assert reader("prefill_mfu.hybrid")(rec) == pytest.approx(want)
    assert reader("scan_roofline.serve")(rec) is None
    assert reader("ssm_device_ms_per_round.hybrid")(rec) is None
    ops = [("void ssm_scan_kernel_ssd<1, 1, 2>", 0.0, 5000.0)] * 72 + [
        ("flash_fwd_kernel_wgmma", 0.0, 100.0)] * 8
    trace = FakeProgramTrace(ops, {"prefill.ssm": 1.5, "prefill.mlp": 2.0})
    trace.units = {"rounds": [(32, 7845, [7845]), (32, 4000, [4000])]}
    rec = _record(trace)
    least = sum(36 * max(FH.scan_work(32, s, 64, 64, 128)[0] / 989e12,
                         FH.scan_work(32, s, 64, 64, 128)[1] / 3.35e12)
                for s in (7845, 4000))
    assert reader("scan_roofline.serve")(rec) == pytest.approx(
        100.0 * least / (72 * 5000e-6))
    assert reader("ssm_device_ms_per_round.hybrid")(rec) == pytest.approx(750)
    # a dense cell's record reads nothing
    dense = Record(kind="serve", model=load_cell(
        "serve.internlm2-1.8b.prefill").config["model"], traffic={},
        peak=PEAK, window_s=1.0, requests=rec.requests, trace=trace)
    for name in ("prefill_mfu.hybrid", "scan_roofline.serve"):
        assert reader(name)(dense) is None


@pytest.mark.parametrize("name", ["ref_granite_h.py", "flops_hybrid.py"])
def test_the_new_yardstick_imports_nothing_of_the_port(name):
    assert not top_level_imports(ROOT / "bench" / name) & {
        "repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_route_of_a_round():
    m = load_cell(CELL).config["model"]
    route = serve_hybrid.route(m)
    assert route["flash_attention"] == 4
    assert route["selective_scan_heads"] == 36
    assert sum(route.values()) == 40


def run_small(seed=11, **model):
    # a window long enough for the 8 checked requests on a loaded host
    return serve_hybrid.run(small_cell(**model), seed, 1.0, False,
                            torch.device("cpu"), time.perf_counter(), PEAK)


def test_logit_errors_and_the_tap():
    ref = [torch.tensor([3.0, 4.0]), torch.tensor([1.0, 0.0])]
    got = [torch.tensor([3.0, 4.5]).bfloat16(), torch.tensor([1.0, 0.0])]
    assert serve_hybrid.logit_errors(got, ref) == pytest.approx([0.1, 0.0])
    tap = serve_hybrid.LogitsTap()
    logits = torch.tensor([[0.1, 0.7, 0.2], [0.9, 0.0, 0.1]])
    assert tap(logits, None).tolist() == [1, 0]
    assert torch.equal(tap.last, logits)


def test_a_sound_serving_run_is_correct():
    rec = run_small()
    assert rec.correct, rec.checks
    assert set(rec.checks) == {"logit_gap_max", "logit_err_max"}
    assert rec.attempted == len(rec.requests) and rec.failed == 0
    assert rec.rounds and all(slots == 2 for slots, _, _ in rec.rounds)
    readings = rec.notes["readings"]
    assert len(readings["gaps"]) == len(readings["errs"]) == 8
    # bf16 against fp32 at the smoke widths: well inside the cell's limit
    assert 0 < max(readings["errs"]) < rec.checks["logit_err_max"][1] / 2


def test_a_token_altered_where_it_is_produced_fails(monkeypatch):
    from repro_torch.distributed import scheduler
    monkeypatch.setattr(scheduler, "greedy", lambda logits, gen: (
        torch.argmax(logits, dim=-1) + 1) % logits.shape[-1])
    rec = run_small()
    assert not rec.correct, rec.checks
    assert math.isfinite(rec.checks["logit_gap_max"][0])
