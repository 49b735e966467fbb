"""prefill_mfu: the prefills' share of the card's bf16 peak over the
window: the FLOPs every answered prompt requires without its padding
(``flops.dense_prefill_flops``), over the window's time (host clock)
times the peak."""
from bench.flops import dense_prefill_flops


def read(rec):
    if rec.kind != "serve" or not rec.requests:
        return None
    flops = sum(dense_prefill_flops(rec.model, r[1]) for r in rec.requests
                if r[4] is not None)
    return 100.0 * flops / (rec.window_s * rec.peak["bf16_flops"])
