"""AdamW's device milliseconds per step: the device time of the work
launched under the span ``bench.apply_updates`` (the benchmark's call of
``optim/adamw.py`` ``apply_updates``) in the traced steps, per step."""


def read(rec):
    if rec.driver != "train" or rec.trace is None:
        return None
    s = rec.trace.device_s("bench.apply_updates")
    return 1e3 * s / rec.traced_units if s > 0 else None
