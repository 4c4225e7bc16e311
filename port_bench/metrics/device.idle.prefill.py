"""The card's idle share of the traced ``serve()`` calls (%): one minus the
union of device intervals (kernels, copies, sets) over the traced window."""


def read(rec):
    if rec.driver != "prefill" or rec.trace is None:
        return None
    return 100 * (1 - rec.trace.busy_s / rec.trace.window_s)
