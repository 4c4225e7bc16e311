"""Plain torch versions of the codec kernels.

Each function computes, in int32 torch ops, exactly what its CUDA kernel in
``csrc/codec.cu`` computes.  The wrappers in ``parity_xor.py`` and
``gf256_matmul.py`` use them for tensors that lie on the CPU (the tests), and
the chip smoke test holds each kernel against them on the card.  Nothing on
the datapath calls them for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import gf


def parity_xor_ref(data: torch.Tensor) -> torch.Tensor:
    """XOR-reduce ``data`` of shape (k, n) int32 -> (n,) int32."""
    return parity_xor_batch_ref(data[None])[0]


def parity_xor_batch_ref(data: torch.Tensor) -> torch.Tensor:
    """XOR-reduce ``data`` of shape (S, k, n) int32 -> (S, n) int32."""
    out = torch.zeros((data.shape[0], data.shape[2]), dtype=torch.int32,
                      device=data.device)
    for i in range(data.shape[1]):
        out ^= data[:, i]
    return out


def gf256_matmul_ref(coeff: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(256) matmul on int32-packed bytes.

    coeff: (m, k) int32 with values in [0, 256) -- GF coefficients.
    data:  (k, n) int32, each int32 packing 4 independent GF(256) bytes.
    returns (m, n) int32 packed the same way.
    """
    return gf256_matmul_batch_ref(coeff, data[None])[0]


def gf256_matmul_batch_ref(coeff: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Batched GF(256) matmul: (m, k) coeffs x (S, k, n) -> (S, m, n)."""
    cm = [[int(c) for c in row] for row in coeff.tolist()]
    s, k, n = data.shape
    out = torch.zeros((s, len(cm), n), dtype=torch.int32, device=data.device)
    for j, row in enumerate(cm):
        for i in range(k):
            out[:, j] ^= gf.swar_gf_scale(data[:, i], row[i])
    return out
