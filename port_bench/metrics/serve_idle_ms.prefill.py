"""The card's idle milliseconds per traced ``serve()`` call that the serve
loop's own host work and synchronisations cost: the idle gaps that begin
while the serving thread is inside the program's span ``repro_torch.serve``
(one batch of ``launch/serve.py serve``) and outside ``repro_torch.prefill``
(the model's prefill)."""
from port_bench import spans


def read(rec):
    if rec.driver != "prefill" or rec.trace is None or not rec.trace.devices:
        return None
    s = spans.serve_idle_s(rec.trace)
    return None if s is None else 1e3 * s / rec.traced_units
