"""Trained tokens per second: every token of every step completed in the
window over the time from the window's start to a synchronisation after
the last step."""


def read(rec):
    return rec.rate if rec.driver == "train" else None
