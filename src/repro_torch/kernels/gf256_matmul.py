"""GF(256) matrix multiply for Reed-Solomon: the wrapper of ``gf256_matmul``.

Computes P = M (*) D where M is an (m, k) GF(256) coefficient matrix and D is
(S, k, n) data with 4 GF bytes packed per int32 lane (polynomial 0x11d).  Used
for RAID-6 encode (M = the parity rows of the systematic generator, m = 2)
and decode (M = the inverse of the surviving rows, m = k).

The device of the data picks the path: a CPU tensor runs the plain version in
``ref.py``; a CUDA tensor launches ``gf256_matmul`` from ``csrc/codec.cu``
(the SWAR double-and-add of ``core/gf.py`` in uint32; memory-bound, bound
4*S*(k+m)*n bytes) or raises.

``LAUNCHES`` counts kernel launches per entry point; the single-stripe form is
the batched kernel launched with S = 1 and keeps its own count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"gf256_matmul_batch": 0, "gf256_matmul": 0}

# the (m, k) coefficients are staged in dynamic shared memory, which a launch
# may size up to 48 KiB without opting in
_MAX_COEFFS = 48 * 1024 // 4


def _matmul(coeff: torch.Tensor, data: torch.Tensor, entry: str) -> torch.Tensor:
    m, k = coeff.shape
    s, k2, n = data.shape
    if coeff.device != data.device:
        raise ValueError(f"{entry}: coeff on {coeff.device}, data on {data.device}")
    if m * k > _MAX_COEFFS:
        raise ValueError(f"{entry}: {m}x{k} coefficients exceed shared memory")
    out = torch.empty((s, m, n), dtype=torch.int32, device=data.device)
    if out.numel():
        vec = int(n % 4 == 0 and _build.aligned16(data, out))
        _build.launch("codec_gf256_matmul", coeff.data_ptr(), data.data_ptr(),
                      out.data_ptr(), m, k, s, n, vec)
        LAUNCHES[entry] += 1
    return out


def _check(coeff: torch.Tensor, data: torch.Tensor, ndim: int, entry: str) -> str:
    _build.check_operand(coeff, 2, entry + " coeff")
    path = _build.check_operand(data, ndim, entry)
    if coeff.shape[1] != data.shape[-2]:
        raise ValueError(f"{entry}: coeff {tuple(coeff.shape)} vs data "
                         f"{tuple(data.shape)}")
    return path


def gf256_matmul_batch(coeff: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(m, k) GF coeffs x (S, k, n) packed int32 -> (S, m, n) packed int32."""
    if _check(coeff, data, 3, "gf256_matmul_batch") == "cpu":
        return ref.gf256_matmul_batch_ref(coeff, data)
    return _matmul(coeff, data, "gf256_matmul_batch")


def gf256_matmul(coeff: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(m, k) GF coeffs x (k, n) packed int32 -> (m, n) packed int32."""
    if _check(coeff, data, 2, "gf256_matmul") == "cpu":
        return ref.gf256_matmul_ref(coeff, data)
    return _matmul(coeff, data[None], "gf256_matmul")[0]
