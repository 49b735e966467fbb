"""gemm_ms_per_round.serve: device time of the matrix products (cuBLAS's
and CUTLASS's kernels, ``devtrace.is_gemm``) a prefill round, in the
traced sub-window: the layers' projections and the head."""
from bench.devtrace import is_gemm


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    us = sum(d for name, _, d in rec.trace.ops if is_gemm(name))
    return us / 1e3 / len(rec.trace.units["rounds"])
