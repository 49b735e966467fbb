"""cada_kernels_roofline.train: the CADA kernels' share of their bound in
the traced sub-window: the least time of each step's AMSGrad step on the
n-entry planes, cada2's two-operand row norm and eq. (3)'s row mean on
the (M, n) planes (``flops``), over the device time of
``amsgrad_kernel``, ``row_sq_kernel`` and ``row_mean_kernel``."""
from bench.flops import amsgrad_work, bound_s, row_mean_work, row_sq_work

KERNELS = ("amsgrad_kernel", "row_sq_kernel", "row_mean_kernel")


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    tr, n = rec.traffic, rec.n_params
    m, plane = tr["workers"], tr["cada_dtype"]
    per_step = (bound_s(*amsgrad_work(n, "float32", tr["moments_dtype"]),
                        rec.peak)
                + bound_s(*row_sq_work(m, n, 2, plane), rec.peak)
                + bound_s(*row_mean_work(m, n, plane), rec.peak))
    us = sum(d for _, _, d in rec.trace.kernels(*KERNELS))
    if not us:
        return None
    return 100.0 * rec.trace.units["steps"] * per_step / (us / 1e6)
