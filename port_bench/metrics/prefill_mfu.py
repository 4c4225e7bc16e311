"""The prefill's share of the card's bf16 peak (%): model FLOPs per prompt
token (``flops.prefill_flops_per_token``: 2 x the projections' weights,
the head on the last position only, the SSD forward, causal attention)
times the window's prefill tokens per second, over 989 TFLOP/s."""
from port_bench import flops


def read(rec):
    if rec.driver != "prefill":
        return None
    return 100 * rec.flops_per_token * rec.rate / flops.PEAK_BF16_FLOPS
