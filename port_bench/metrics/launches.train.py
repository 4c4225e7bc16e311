"""Device events per train step: the kernels, copies and sets launched while
the program's span ``repro_torch.forward``, ``repro_torch.backward`` or
``repro_torch.adamw`` was open, on any thread, per traced step."""
from port_bench import spans


def read(rec):
    if rec.driver != "train" or rec.trace is None:
        return None
    n = len(spans.during(rec.trace, spans.FORWARD, spans.BACKWARD, spans.ADAMW))
    return n / rec.traced_units if n else None
