"""Faults planted under the timed path, for the tests of the check and for
the readings that set the limits: each wraps the program's own call.

Training (the train step ``(params, opt, batch) -> (params, opt, metrics)``):

* ``unchanged``: the step returns the state it was given;
* ``half_batch``: the step sees only the first half of the batch's rows,
  so its loss and gradients are the mean over those.

Prefill (``model.prefill``, tokens -> (last logits, cache)):

* ``swapped_rows``: the answers of rows 0 and 1 are exchanged where they
  are produced, logits and cache alike (so row 0 is served row 1's token).

The cells run on one card, so no fault leaves out an exchange between
cards.
"""
from __future__ import annotations


def unchanged(step):
    def faulty(params, opt, batch):
        return params, opt, step(params, opt, batch)[2]
    return faulty


def half_batch(step):
    def faulty(params, opt, batch):
        return step(params, opt, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return faulty


def swapped_rows(prefill):
    def faulty(tokens):
        logits, cache = prefill(tokens)
        order = list(range(tokens.shape[0]))
        order[0], order[1] = 1, 0
        logits = logits[order]
        for key, val in cache.items():
            if key != "len":
                cache[key] = val[:, order]
        return logits, cache
    return faulty


TRAIN = {"unchanged": unchanged, "half_batch": half_batch}
PREFILL = {"swapped_rows": swapped_rows}
