"""The MoE layers' share of the card's busy time in the traced ``serve()``
calls (%): the union of the device intervals launched under the program's
span ``repro_torch.moe`` (``models/layers.py moe_apply``: router, dispatch,
routed and shared experts, the sum back into the tokens), over the union of
all device intervals."""
from port_bench import spans

MOE = "repro_torch.moe"


def read(rec):
    if rec.driver != "prefill" or rec.trace is None or rec.trace.busy_s <= 0:
        return None
    s = spans.union_s(rec.trace, spans.nested(rec.trace, MOE))
    return 100 * s / rec.trace.busy_s if s > 0 else None
