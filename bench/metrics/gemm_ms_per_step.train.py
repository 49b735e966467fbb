"""gemm_ms_per_step.train: device time of the matrix products (cuBLAS's
and CUTLASS's kernels, ``devtrace.is_gemm``) a trainer step, in the
traced sub-window: the worker gradients' projections."""
from bench.devtrace import is_gemm


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    us = sum(d for name, _, d in rec.trace.ops if is_gemm(name))
    return us / 1e3 / rec.trace.units["steps"]
