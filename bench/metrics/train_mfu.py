"""train_mfu: the trainer steps' share of the card's bf16 peak over the
window: the FLOPs every step requires (``flops.train_step_flops``: each
gradient evaluation of each worker, forward and backward, without the
rematerialised forward), over the window's time (host clock) times the
peak."""
from bench.flops import GRAD_EVALS, train_step_flops


def read(rec):
    if rec.kind != "train" or not rec.steps:
        return None
    tr = rec.traffic
    flops = rec.steps * train_step_flops(
        rec.model, tr["global_batch"], tr["seq"],
        GRAD_EVALS.get(tr["rule"]["kind"], 1))
    return 100.0 * flops / (rec.window_s * rec.peak["bf16_flops"])
