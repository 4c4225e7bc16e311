"""Kernel entry points: the stripe codec's and the Mamba-2 SSD scan.

Each op takes torch tensors; the tensor's device picks the path (a CPU
tensor runs the plain version, a CUDA tensor launches the kernel).  The codec
ops take int32-packed lanes, and their outputs have exactly the input's ``n``
lanes: the kernels mask the ragged tail themselves, so there is no lane
padding.

Byte-level helpers convert between uint8 chunk buffers and the int32-packed
lanes on the host, as free numpy dtype views.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import gf
from repro_torch.kernels.gf256_matmul import gf256_matmul, gf256_matmul_batch
from repro_torch.kernels.parity_xor import parity_xor, parity_xor_batch
from repro_torch.kernels.ssd_scan import DEFAULT_CHUNK, ssd_scan_op


def rs_parity_coeff(k: int, m: int, device: str | torch.device) -> torch.Tensor:
    """(m, k) RS parity matrix as int32 on ``device``, cached per (k, m, device).

    The matrices are tiny, but building and copying one to the card on every
    encode would add a host->device transfer per call.  Callers must not
    write to the cached tensor."""
    return _parity_coeff(k, m, str(device))


def rs_decode_coeff(
    k: int, m: int, surviving: tuple[int, ...], device: str | torch.device
) -> torch.Tensor:
    """(k, k) RS decode matrix on ``device``, cached per survivor set."""
    return _decode_coeff(k, m, tuple(surviving), str(device))


@functools.lru_cache(maxsize=None)
def _parity_coeff(k: int, m: int, device: str) -> torch.Tensor:
    return torch.from_numpy(gf.rs_parity_matrix(k, m).astype(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _decode_coeff(k: int, m: int, surviving: tuple[int, ...], device: str) -> torch.Tensor:
    mat = gf.rs_decode_matrix(k, m, surviving).astype(np.int32)
    return torch.from_numpy(mat).to(device)


def xor_parity(chunks_i32: torch.Tensor) -> torch.Tensor:
    """XOR parity of (k, n) int32 -> (n,) int32."""
    return parity_xor(chunks_i32)


def rs_matmul(coeff_i32: torch.Tensor, chunks_i32: torch.Tensor) -> torch.Tensor:
    """GF(256) (m,k) x (k,n) -> (m,n) on int32-packed bytes."""
    return gf256_matmul(coeff_i32, chunks_i32)


def rs_encode(chunks_i32: torch.Tensor, m: int) -> torch.Tensor:
    """Encode (k, n) data chunks into (m, n) RS parity chunks.  The
    single-stripe kernel takes its coefficients by value, from the host."""
    return rs_matmul(rs_parity_coeff(chunks_i32.shape[0], m, "cpu"), chunks_i32)


def rs_decode(
    surviving_i32: torch.Tensor, surviving_rows: tuple[int, ...], k: int, m: int
) -> torch.Tensor:
    """Reconstruct the k data chunks from any k surviving codeword rows."""
    return rs_matmul(rs_decode_coeff(k, m, tuple(surviving_rows), "cpu"), surviving_i32)


# ------------------------------------------------------- batched (group) ops

def xor_parity_batch(chunks_i32: torch.Tensor) -> torch.Tensor:
    """XOR parity for a whole stripe group: (S, k, n) int32 -> (S, n) int32."""
    return parity_xor_batch(chunks_i32)


def rs_matmul_batch(coeff_i32: torch.Tensor, chunks_i32: torch.Tensor) -> torch.Tensor:
    """GF(256) (m,k) x (S,k,n) -> (S,m,n) on int32-packed bytes."""
    return gf256_matmul_batch(coeff_i32, chunks_i32)


def rs_encode_batch(chunks_i32: torch.Tensor, m: int) -> torch.Tensor:
    """Encode (S, k, n) stripes into (S, m, n) RS parity in one launch."""
    coeff = rs_parity_coeff(chunks_i32.shape[1], m, chunks_i32.device)
    return rs_matmul_batch(coeff, chunks_i32)


def rs_decode_batch(
    surviving_i32: torch.Tensor, surviving_rows: tuple[int, ...], k: int, m: int
) -> torch.Tensor:
    """Reconstruct (S, k, n) data from (S, k, n) survivors sharing one role set."""
    dec = rs_decode_coeff(k, m, tuple(surviving_rows), surviving_i32.device)
    return rs_matmul_batch(dec, surviving_i32)


# ------------------------------------------------------------ host packing

def pack_bytes_np(data_u8: np.ndarray) -> np.ndarray:
    """(..., 4*n) uint8 -> (..., n) int32 little-endian lanes: a free dtype
    view of a C-contiguous buffer (copied first only if not contiguous)."""
    assert data_u8.shape[-1] % 4 == 0
    data_u8 = np.ascontiguousarray(data_u8)
    return data_u8.view(np.int32)


def unpack_bytes_np(data_i32: np.ndarray) -> np.ndarray:
    """(..., n) int32 -> (..., 4*n) uint8, a free dtype view."""
    return np.ascontiguousarray(data_i32).view(np.uint8)


# ------------------------------------------------------------- Mamba-2 SSD

def ssd_chunk_scan(x, dt, a, b, c, h0=None, *, chunk: int = DEFAULT_CHUNK):
    """Mamba-2 SSD scan; see kernels/ssd_scan.py.  Returns (y, h_final).
    It runs as the operator ``repro_torch::ssd_scan``; when autograd records
    and an operand requires grad, the forward kernel also keeps its chunk
    states for the backward kernel."""
    keep = torch.is_grad_enabled() and any(
        v is not None and v.requires_grad for v in (x, dt, a, b, c, h0))
    y, h, _ = ssd_scan_op(x, dt, a, b, c, h0, chunk, keep)
    return y, h
