"""The train step's share of the card's bf16 peak (%): model FLOPs per
token (``flops.train_flops_per_token``: 6 x the projections' weights, the
SSD scan's forward and backward; no recompute) times the window's trained
tokens per second, over 989 TFLOP/s."""
from port_bench import flops


def read(rec):
    if rec.driver != "train":
        return None
    return 100 * rec.flops_per_token * rec.rate / flops.PEAK_BF16_FLOPS
