"""The SSD scan's share of its roofline in training (%): the least time of
every forward and backward call traced (``flops.least_s`` of each call's
FLOPs and bytes, from shapes) over the device time of the work launched
under the operators ``repro_torch::ssd_scan`` and ``repro_torch::ssd_scan_bwd``."""
from port_bench import common


def read(rec):
    return common.op_roofline(rec) if rec.driver == "train" else None
