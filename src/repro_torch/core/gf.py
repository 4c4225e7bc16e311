"""GF(2^8) arithmetic for Reed-Solomon parity in ZapRAID.

The field is GF(256) with the AES/RS-standard reduction polynomial
x^8 + x^4 + x^3 + x^2 + 1 (0x11d).  Two implementations are provided:

* numpy table-based routines (host-side: building encode matrices, inverting
  decode matrices -- these touch only (k+m)^2 <= 32^2 entries and never run on
  the datapath);
* branchless SWAR routines on int32-packed bytes (the datapath of the plain
  torch versions in ``kernels/ref.py``; the CUDA kernel in
  ``kernels/csrc/codec.cu`` repeats them in uint32).  Four GF(256) lanes are
  packed per int32; ``xtime`` (multiply-by-x) is computed simultaneously on
  all four bytes without cross-byte carry leakage.
"""
from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D
GF_GEN = 2  # generator of the multiplicative group for 0x11d


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]  # wraparound so exp[a+b] never needs a mod
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(256) multiply (table based)."""
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + int(GF_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(256) inverse of 0")
    return int(GF_EXP[255 - int(GF_LOG[a])])


def gf_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise GF(256) multiply of uint8 arrays."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = GF_EXP[GF_LOG[a] + GF_LOG[b]].astype(np.uint8)
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def gf_matmul_np(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    """GF(256) matrix product: (r, k) x (k, n) -> (r, n), all uint8."""
    m = np.asarray(m, dtype=np.uint8)
    d = np.asarray(d, dtype=np.uint8)
    r, k = m.shape
    out = np.zeros((r, d.shape[1]), dtype=np.uint8)
    for i in range(k):
        out ^= gf_mul_np(m[:, i : i + 1], d[i : i + 1, :])
    return out


def gf_inv_matrix_np(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion of a square matrix over GF(256)."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r, col] != 0), None)
        if pivot is None:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = gf_mul_np(aug[col], np.uint8(inv_p))
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= gf_mul_np(np.full(2 * n, aug[r, col], np.uint8), aug[col])
    return aug[:, n:].copy()


@functools.lru_cache(maxsize=None)
def rs_encode_matrix(k: int, m: int) -> np.ndarray:
    """Systematic (k+m, k) RS generator matrix; top k rows are identity.

    Built from a Vandermonde matrix made systematic by column operations, so
    any k rows of the result are invertible (classic Plank construction).
    """
    if k + m > 256:
        raise ValueError("k + m must be <= 256 for GF(256) RS")
    vand = np.zeros((k + m, k), dtype=np.uint8)
    for r in range(k + m):
        v = 1
        for c in range(k):
            vand[r, c] = v
            v = gf_mul(v, r + 1) if r + 1 < 256 else v
    # Make top kxk block identity via column ops (multiply by its inverse).
    top_inv = gf_inv_matrix_np(vand[:k, :k])
    gen = gf_matmul_np(vand, top_inv)
    assert np.array_equal(gen[:k], np.eye(k, dtype=np.uint8))
    return gen


def rs_parity_matrix(k: int, m: int) -> np.ndarray:
    """The (m, k) parity rows of the systematic generator."""
    return rs_encode_matrix(k, m)[k:, :].copy()


def rs_decode_matrix(k: int, m: int, surviving: tuple[int, ...]) -> np.ndarray:
    """(k, k) matrix reconstructing the k data chunks from ``surviving``.

    ``surviving`` are row indices into the (k+m) codeword (data rows 0..k-1,
    parity rows k..k+m-1); exactly k of them must be given.
    """
    surviving = tuple(surviving)
    if len(surviving) != k:
        raise ValueError(f"need exactly k={k} surviving rows, got {len(surviving)}")
    gen = rs_encode_matrix(k, m)
    sub = gen[list(surviving), :]  # (k, k)
    return gf_inv_matrix_np(sub)


# --------------------------------------------------------------------------
# SWAR (int32-packed) GF(256) ops -- numpy arrays and torch int32 tensors.
# --------------------------------------------------------------------------

def swar_xtime(v):
    """Multiply each of the 4 packed GF(256) bytes in an int32 by x.

    Works for numpy arrays and torch int32 tensors alike (pure bitwise int32
    arithmetic; two's-complement wraparound keeps byte lanes independent:
    bit 7 of each byte is cleared before the shift, and the reduction term
    0x1d is injected per byte from the extracted high bits).  The ``>> 7`` is
    masked, so arithmetic and logical shifts agree.
    """
    hi = (v >> 7) & 0x01010101
    return ((v & 0x7F7F7F7F) << 1) ^ (hi * 0x1D)


def swar_gf_scale(v, coeff):
    """Scale packed bytes ``v`` (int32 array) by GF(256) scalar ``coeff``.

    ``coeff`` may be a python int or a traced int32 scalar; the loop over the
    8 bits of the coefficient is static, each step branchless.
    """
    acc = v - v  # zeros_like that works for np and jnp
    cur = v
    for bit in range(8):
        mask = -((coeff >> bit) & 1)  # 0 or -1 (all ones) in int32
        acc = acc ^ (cur & mask)
        cur = swar_xtime(cur)
    return acc


def bytes_to_i32(a: np.ndarray) -> np.ndarray:
    """View a uint8 array whose last dim is a multiple of 4 as int32 lanes."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    assert a.shape[-1] % 4 == 0
    return a.view(np.int32)


def i32_to_bytes(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32).view(np.uint8)
