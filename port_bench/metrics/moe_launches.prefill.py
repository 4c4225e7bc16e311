"""Device events per MoE layer in the traced ``serve()`` calls: the kernels,
copies and sets launched under the program's span ``repro_torch.moe``
(``models/layers.py moe_apply``), over the number of such spans."""
from port_bench import spans

MOE = "repro_torch.moe"


def read(rec):
    if rec.driver != "prefill" or rec.trace is None:
        return None
    layers = len(spans.opened(rec.trace, MOE))
    n = len(spans.nested(rec.trace, MOE))
    return n / layers if layers and n else None
