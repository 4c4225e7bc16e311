"""The port's CUDA kernels, their wrappers and plain versions: the stripe
codec's (``csrc/codec.cu``) and the Mamba-2 SSD scan (``csrc/ssd_scan.cu``)
with its gradient (``csrc/ssd_scan_bwd.cu``).

Every wrapper counts its kernel launches; :func:`launch_counts` reads them all
and :func:`reset_launch_counts` sets them to zero.  ``CODEC_KERNELS`` names
the counters of the storage datapath's kernels.
"""
from repro_torch.kernels import gf256_matmul, parity_xor, ssd_scan

_COUNTERS = (parity_xor.LAUNCHES, gf256_matmul.LAUNCHES, ssd_scan.LAUNCHES)
CODEC_KERNELS = (*parity_xor.LAUNCHES, *gf256_matmul.LAUNCHES)


def launch_counts() -> dict[str, int]:
    out: dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0
