"""prefill_mfu.hybrid: the prefills' share of the card's bf16 peak over the
window, for a decoder with a per-layer pattern of Mamba2 and attention
mixers: the FLOPs every answered prompt requires without its padding
(``flops_hybrid.hybrid_prefill_flops``: both layer kinds' projections, the
MLPs, the attention layers' causal products, the scans' products and the
head at the last position), over the window's time (host clock) times
the peak."""
from bench.flops_hybrid import hybrid_prefill_flops


def read(rec):
    if rec.kind != "serve" or "layer_types" not in rec.model \
            or not rec.requests:
        return None
    flops = sum(hybrid_prefill_flops(rec.model, r[1]) for r in rec.requests
                if r[4] is not None)
    return 100.0 * flops / (rec.window_s * rec.peak["bf16_flops"])
