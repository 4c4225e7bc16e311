"""Device events per Mamba-2 block in the traced ``serve()`` calls: the
kernels, copies and sets launched under the program's span
``repro_torch.mamba`` (``models/mamba2.py mamba_apply``), over the number
of such spans."""
from port_bench import spans


def read(rec):
    if rec.driver != "prefill" or rec.trace is None:
        return None
    blocks = len(spans.opened(rec.trace, spans.MAMBA))
    n = len(spans.nested(rec.trace, spans.MAMBA))
    return n / blocks if blocks and n else None
