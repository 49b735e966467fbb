"""elementwise_ms_per_round.serve: device time a prefill round of every
kernel that is neither a matrix product nor one of the port's own kernels
(``devtrace.is_eager``): the eager norms, rotary embeddings, activations,
casts, copies and the cache's filling."""
from bench.devtrace import is_eager


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    us = sum(d for name, _, d in rec.trace.ops if is_eager(name))
    return us / 1e3 / len(rec.trace.units["rounds"])
