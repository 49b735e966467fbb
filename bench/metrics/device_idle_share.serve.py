"""device_idle_share.serve: the share of the traced sub-window in which no
operation ran on the card (the union of the device intervals,
``devtrace.Trace.busy_s``)."""


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
