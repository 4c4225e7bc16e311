"""XOR parity over k data chunks: the wrapper of the ``xor_reduce`` kernel.

RAID-4/5 parity, the single-erasure decode (degraded read, rebuild, GC) and
the parity-protected OOB metadata are one XOR-reduce over the k rows of a
stripe.  The device of the tensor picks the path: a CPU tensor runs the plain
version in ``ref.py``; a CUDA tensor launches ``xor_reduce`` from
``csrc/codec.cu`` (memory-bound, bound 4*S*(k+1)*n bytes) or raises.

``LAUNCHES`` counts kernel launches per entry point; the single-stripe form is
the batched kernel launched with S = 1 and keeps its own count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"parity_xor_batch": 0, "parity_xor": 0}


def _xor_reduce(data: torch.Tensor, entry: str) -> torch.Tensor:
    s, k, n = data.shape
    out = torch.empty((s, n), dtype=torch.int32, device=data.device)
    if out.numel():
        vec = int(n % 4 == 0 and _build.aligned16(data, out))
        _build.launch("codec_xor_reduce", data.data_ptr(), out.data_ptr(),
                      s, k, n, vec)
        LAUNCHES[entry] += 1
    return out


def parity_xor_batch(data: torch.Tensor) -> torch.Tensor:
    """XOR-reduce a whole stripe group: (S, k, n) int32 -> (S, n) int32."""
    if _build.check_operand(data, 3, "parity_xor_batch") == "cpu":
        return ref.parity_xor_batch_ref(data)
    return _xor_reduce(data, "parity_xor_batch")


def parity_xor(data: torch.Tensor) -> torch.Tensor:
    """XOR-reduce one stripe: (k, n) int32 -> (n,) int32."""
    if _build.check_operand(data, 2, "parity_xor") == "cpu":
        return ref.parity_xor_ref(data)
    return _xor_reduce(data[None], "parity_xor")[0]
