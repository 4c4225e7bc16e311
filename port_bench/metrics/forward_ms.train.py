"""The forward's device milliseconds per train step: the device time of the
work launched while the program's span ``repro_torch.forward`` was open
(``train/steps.py value_and_grad``, around the model's loss), on any
thread, in the traced steps, per step."""
from port_bench import spans


def read(rec):
    if rec.driver != "train" or rec.trace is None:
        return None
    s = spans.device_s(spans.during(rec.trace, spans.FORWARD))
    return 1e3 * s / rec.traced_units if s > 0 else None
