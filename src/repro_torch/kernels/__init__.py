"""CUDA codec kernels (``csrc/codec.cu``), their wrappers and plain versions.

Every wrapper counts its kernel launches; :func:`launch_counts` reads them all
and :func:`reset_launch_counts` sets them to zero.
"""
from repro_torch.kernels import gf256_matmul, parity_xor

_COUNTERS = (parity_xor.LAUNCHES, gf256_matmul.LAUNCHES)


def launch_counts() -> dict[str, int]:
    out: dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for name in c:
            c[name] = 0
