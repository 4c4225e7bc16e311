"""The SSD scan's share of its roofline in prefill (%): the least time of
every forward call traced over the device time of the work launched under
the operator ``repro_torch::ssd_scan``."""
from port_bench import common


def read(rec):
    return common.op_roofline(rec) if rec.driver == "prefill" else None
