"""The routed experts' products' share of their roofline in prefill (%):
the least time of every traced MoE layer's expert products (the driver's
``notes["moe_experts_least_s"]``: the larger of 2 x 3 x d x ff FLOPs per
routed slot over 989 TFLOP/s and every expert's weights read once plus the
slots' rows in and out over 3.35 TB/s) over the device time of the work
launched under the program's span ``repro_torch.moe_experts``
(``models/layers.py moe_apply``)."""
MOE_EXPERTS = "repro_torch.moe_experts"


def read(rec):
    least = rec.notes.get("moe_experts_least_s")
    if rec.driver != "prefill" or rec.trace is None or not least:
        return None
    spent = rec.trace.device_s(MOE_EXPERTS)
    n = rec.trace.calls(MOE_EXPERTS)
    return 100 * n * least / spent if n and spent > 0 else None
