"""Plain torch versions of the CUDA kernels.

The codec functions compute, in int32 torch ops, exactly what their kernels
in ``csrc/codec.cu`` compute.  ``ssd_scan_ref`` is the sequential f32
recurrence that ``csrc/ssd_scan.cu`` computes in chunked form, and
``ssd_chunk_gram_ref`` the per-chunk C B^T its first kernel writes.  The wrappers
(``parity_xor.py``, ``gf256_matmul.py``, ``ssd_scan.py``) use them for
tensors that lie on the CPU (the tests), and the chip smoke test holds each
kernel against them on the card.  Nothing on the datapath or the model path
calls them for a CUDA tensor.
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


def ssd_scan_ref(
    x: torch.Tensor,   # (bh, t, p)
    dt: torch.Tensor,  # (bh, t)      softplus'd step sizes (>0)
    a: torch.Tensor,   # (bh,)        per-row negative decay rate (A < 0)
    b: torch.Tensor,   # (bh, t, n)   input->state projection
    c: torch.Tensor,   # (bh, t, n)   state->output projection
    h0: torch.Tensor | None = None,  # (bh, n, p) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential reference for the Mamba-2 SSD recurrence.

    h_t = exp(dt_t * a) * h_{t-1} + dt_t * (b_t outer x_t)
    y_t = c_t @ h_t
    Returns (y (bh, t, p), h_final (bh, n, p)), all math in float32.
    """
    bh, t, p = x.shape
    n = b.shape[-1]
    x, dt, a, b, c = (v.float() for v in (x, dt, a, b, c))
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * a)[:, None, None]
        h = decay * h + dt[:, i, None, None] * (b[:, i, :, None] * x[:, i, None, :])
        ys.append(torch.einsum("bn,bnp->bp", c[:, i], h))
    return torch.stack(ys, 1), h


def ssd_chunk_gram_ref(b: torch.Tensor, c: torch.Tensor, q: int) -> torch.Tensor:
    """G = C B^T of each chunk of q steps of b, c (nb, t, n), in f32, laid
    out as the ``ssd_chunk_gram`` kernel writes it: the 16 x 16 tiles (i, j)
    with j <= i of G padded to a multiple of 16, in row-major order, and in
    each tile lane l = 4 g + k holding the 8 values at rows (g, g+8) x
    columns (2k, 2k+1, 8+2k, 9+2k) as [(g,2k), (g,2k+1), (g+8,2k),
    (g+8,2k+1), (g,8+2k), (g,9+2k), (g+8,8+2k), (g+8,9+2k)].
    Returns (nb, t // q, tiles, 32, 8)."""
    nb, t, n = b.shape
    nc, q16 = t // q, -(-q // 16) * 16
    bc, cc = (torch.nn.functional.pad(v.float().reshape(nb, nc, q, n), (0, 0, 0, q16 - q))
              for v in (b, c))
    qt = q16 // 16
    tiles = (cc @ bc.transpose(-1, -2)).reshape(nb, nc, qt, 16, qt, 16).transpose(3, 4)
    ii, jj = torch.tril_indices(qt, qt)
    low = tiles[:, :, ii, jj].reshape(nb, nc, len(ii), 2, 8, 2, 4, 2)  # (rh, g, ch, k, e)
    return low.permute(0, 1, 2, 4, 6, 5, 3, 7).reshape(nb, nc, len(ii), 32, 8).contiguous()
