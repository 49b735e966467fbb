"""elementwise_ms_per_step.train: device time a trainer step of every
kernel that is neither a matrix product nor one of the port's own kernels
(``devtrace.is_eager``): the eager elementwise, reduction, copy and
indexing work of the model code and of the flat planes."""
from bench.devtrace import is_eager


def read(rec):
    if rec.kind != "train" or rec.trace is None:
        return None
    us = sum(d for name, _, d in rec.trace.ops if is_eager(name))
    return us / 1e3 / rec.trace.units["steps"]
