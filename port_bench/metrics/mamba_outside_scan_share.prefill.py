"""The Mamba-2 block's share of the card's busy time outside the SSD scan,
in the traced ``serve()`` calls (%): the union of the device intervals
launched under the program's span ``repro_torch.mamba`` (``models/mamba2.py
mamba_apply``) but not under the operator ``repro_torch::ssd_scan``, over
the union of all device intervals.  Projections, conv, gate, norm and the
casts between them."""
from port_bench import spans


def read(rec):
    if rec.driver != "prefill" or rec.trace is None or rec.trace.busy_s <= 0:
        return None
    s = spans.union_s(rec.trace, spans.nested(rec.trace, spans.MAMBA, outside=spans.SCAN))
    return 100 * s / rec.trace.busy_s if s > 0 else None
