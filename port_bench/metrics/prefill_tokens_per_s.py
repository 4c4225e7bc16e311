"""Prefilled prompt tokens per second: every prompt token of every
``serve()`` call completed in the window over the time from the window's
start to the return of the last call (which synchronises)."""


def read(rec):
    return rec.rate if rec.driver == "prefill" else None
