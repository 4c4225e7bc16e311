"""Vectorized CRC32C (Castagnoli) over fixed-size blocks.

The write path stages payloads in int32-packed arenas
(``core.array._StripeArena``), so the checksum primitive must digest a
whole ``(N, block_bytes)`` uint8 view in one numpy pass -- no per-block
Python loops, no byte-at-a-time state machine on the hot path.

CRC is GF(2)-affine in the message, which makes a *per-position table*
formulation possible: for a fixed block length ``L`` there is a table
``postable[pos][byte]`` (the raw CRC contribution of ``byte`` at
position ``pos`` in an otherwise-zero message) and a constant folding
the ``0xFFFFFFFF`` init/xorout through ``L`` zero bytes, such that

    crc(M) = const(L)  XOR  XOR_{pos} postable[pos, M[pos]]

The whole batch then reduces to one fancy-indexed gather plus an XOR
reduction -- a shape (map + reduce over independent lanes) that ports
directly to a device kernel if the arenas ever move on-device.  Tables
are built once per distinct block length and cached (1 KiB per
position: 4 MiB for 4 KiB blocks).

The same primitive digests arbitrary-length byte strings through the
classic byte-loop (:func:`crc32c`) for header/footer metadata, and the
two agree: ``crc32c(block.tobytes()) == crc32c_many(block[None])[0]``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CRC_BYTES", "crc32c", "crc32c_many", "crc32c_pack", "verify_many"]

CRC_BYTES = 4  # stored checksum width (uint32, little-endian when packed)

_POLY = np.uint32(0x82F63B78)  # CRC-32C (Castagnoli), reflected


def _base_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ _POLY, t >> 1).astype(np.uint32)
    return t


_TABLE = _base_table()

# Per-length cache: block length -> (postable (L, 256) uint32, const uint32)
_POS_CACHE: dict[int, tuple[np.ndarray, int]] = {}

# Positions digested per gather chunk; bounds the (N, chunk) uint32
# scratch so huge batches never materialize an N*L temp.
_CHUNK = 1024


def _pos_tables(length: int) -> tuple[np.ndarray, int]:
    cached = _POS_CACHE.get(length)
    if cached is not None:
        return cached
    post = np.empty((length, 256), dtype=np.uint32)
    post[length - 1] = _TABLE
    for pos in range(length - 2, -1, -1):
        s = post[pos + 1]
        post[pos] = (s >> 8) ^ _TABLE[s & 0xFF]
    # Fold init=0xFFFFFFFF through `length` zero bytes, plus the xorout.
    c = 0xFFFFFFFF
    for _ in range(length):
        c = (c >> 8) ^ int(_TABLE[c & 0xFF])
    const = c ^ 0xFFFFFFFF
    _POS_CACHE[length] = (post, const)
    return post, const


def crc32c(data: bytes | bytearray | memoryview | np.ndarray) -> int:
    """Scalar CRC32C of an arbitrary-length byte string."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data.reshape(-1)
    crc = 0xFFFFFFFF
    for b in buf.tobytes():
        crc = (crc >> 8) ^ int(_TABLE[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def crc32c_many(blocks: np.ndarray) -> np.ndarray:
    """CRC32C of each row: ``(N, L) uint8 -> (N,) uint32``.

    Accepts any 2-D array whose rows are the messages; int32-packed
    arena rows digest zero-copy via a uint8 view.
    """
    if blocks.dtype != np.uint8:
        blocks = np.ascontiguousarray(blocks).view(np.uint8)
    if blocks.ndim != 2:
        blocks = blocks.reshape(blocks.shape[0], -1)
    n, length = blocks.shape
    if length == 0:
        return np.zeros(n, dtype=np.uint32)
    post, const = _pos_tables(length)
    acc = np.full(n, const, dtype=np.uint32)
    for start in range(0, length, _CHUNK):
        stop = min(start + _CHUNK, length)
        idx = np.arange(start, stop)
        # (N, chunk) gather of per-position contributions, XOR-reduced.
        acc ^= np.bitwise_xor.reduce(post[idx, blocks[:, start:stop]], axis=1)
    return acc


def crc32c_pack(crcs: np.ndarray) -> np.ndarray:
    """Pack ``(N,) uint32`` checksums as ``(N, 4)`` little-endian bytes."""
    return np.ascontiguousarray(crcs, dtype="<u4").view(np.uint8).reshape(-1, 4)


def verify_many(blocks: np.ndarray, crcs: np.ndarray) -> np.ndarray:
    """Boolean mask: ``True`` where row i's CRC32C matches ``crcs[i]``."""
    return crc32c_many(blocks) == np.asarray(crcs, dtype=np.uint32)
