"""ssm_device_ms_per_round.hybrid: device time a prefill round of every
operation launched inside the program's ``prefill.ssm`` spans (each
Mamba2 mixer: its projections, the conv over [x, B, C], the scan, the
gated norm and ``out_proj``), from the traced sub-window with the
program's spans (``bench/progtrace.py``); none without them."""


def read(rec):
    launched_in = getattr(rec.trace, "launched_in", None)
    if rec.kind != "serve" or launched_in is None:
        return None
    ms = launched_in("prefill.ssm") * 1e3
    return ms / len(rec.trace.units["rounds"]) if ms else None
