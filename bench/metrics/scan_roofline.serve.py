"""scan_roofline.serve: the per-head selective scan's share of its bound in
the traced sub-window: the least time of each round's launches (one a
Mamba2 layer, at the round's padded shape: ``flops_hybrid.scan_work``'s
bytes over the bandwidth or its chunked products over the bf16 peak,
whichever is larger) over the device time of ``ssm_scan_kernel_ssd``."""
from bench.flops import bound_s
from bench.flops_hybrid import kinds, scan_shape, scan_work


def read(rec):
    if rec.kind != "serve" or rec.trace is None \
            or "layer_types" not in rec.model:
        return None
    _, n_ssm = kinds(rec.model)
    h, p, n = scan_shape(rec.model)
    least = sum(n_ssm * bound_s(*scan_work(slots, padded, h, p, n),
                                rec.peak)
                for slots, padded, _ in rec.trace.units["rounds"])
    us = sum(d for _, _, d in rec.trace.kernels("ssm_scan_kernel_ssd"))
    if not us:
        return None
    return 100.0 * least / (us / 1e6)
