"""Remat's recompute in device milliseconds per train step: the device time
of the work launched under a ``repro_torch.mamba`` span (``models/mamba2.py
mamba_apply``) that began while ``repro_torch.backward`` was open, that is,
the Mamba-2 blocks that ``models/model.py _remat`` runs a second time."""
from port_bench import spans


def read(rec):
    if rec.driver != "train" or rec.trace is None:
        return None
    s = spans.device_s(spans.nested(rec.trace, spans.MAMBA, began_during=spans.BACKWARD))
    return 1e3 * s / rec.traced_units if s > 0 else None
