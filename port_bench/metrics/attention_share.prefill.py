"""Attention's share of the card's busy time in the traced ``serve()`` calls
(%): the union of the device intervals launched under the program's span
``repro_torch.attention`` (``models/layers.py attention_apply``), over the
union of all device intervals."""
from port_bench import spans


def read(rec):
    if rec.driver != "prefill" or rec.trace is None or rec.trace.busy_s <= 0:
        return None
    s = spans.union_s(rec.trace, spans.nested(rec.trace, spans.ATTENTION))
    return 100 * s / rec.trace.busy_s if s > 0 else None
