"""flash_roofline.serve: flash attention's share of its bound in the
traced sub-window: the least time of each round's launches (one a layer,
at the round's padded shape, ``flops.flash_work``) over the device time
of ``flash_fwd_kernel_wgmma``."""
from bench.flops import bound_s, flash_work


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    m = rec.model
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    least = sum(m["n_layers"] * bound_s(*flash_work(
        slots, padded, m["n_heads"], m["n_kv_heads"], hd), rec.peak)
        for slots, padded, _ in rec.trace.units["rounds"])
    us = sum(d for _, _, d in rec.trace.kernels("flash_fwd_kernel_wgmma"))
    if not us:
        return None
    return 100.0 * least / (us / 1e6)
