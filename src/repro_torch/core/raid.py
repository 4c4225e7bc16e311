"""RAID schemes and the stripe codec (encode / decode / placement rotation).

Supports the paper's five schemes (Exp#4): RAID-0, RAID-01, RAID-4, RAID-5,
RAID-6 on an n-drive array.  The codec operates on int32-packed chunk
payloads and dispatches to the CUDA kernels (XOR for single parity, GF(256)
Reed-Solomon for double parity): stripe groups as torch tensors on the
card, single stripes in pinned host memory the card maps; on the CPU the
same ops run their plain torch versions.

Placement: role r of a stripe lives on drive ``(r + rot) % n`` where
``rot = stripe_seq % n`` for rotating schemes (RAID-5/6) and ``rot = 0`` for
fixed-parity schemes (RAID-0/01/4) -- the classic left-symmetric rotation the
paper sketches in Figure 3.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import gf
from repro_torch.kernels import _build, gf256_matmul, ops, parity_xor


@dataclasses.dataclass(frozen=True)
class RaidScheme:
    name: str
    k: int  # data chunks per stripe
    m: int  # parity chunks per stripe
    rotate: bool  # rotate parity placement across drives
    mirror: bool = False  # RAID-01: parity chunks are copies of data chunks

    @property
    def n(self) -> int:
        return self.k + self.m

    def rotation(self, stripe_seq: int) -> int:
        return stripe_seq % self.n if self.rotate else 0

    def role_to_drive(self, role: int, stripe_seq: int) -> int:
        return (role + self.rotation(stripe_seq)) % self.n

    def drive_to_role(self, drive: int, stripe_seq: int) -> int:
        return (drive - self.rotation(stripe_seq)) % self.n

    def rotation_many(self, stripe_seqs: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`rotation` (batched commit/harvest paths)."""
        seqs = np.asarray(stripe_seqs, dtype=np.int64)
        return seqs % self.n if self.rotate else np.zeros(seqs.shape, np.int64)

    def drive_to_role_many(self, drive: int, stripe_seqs: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`drive_to_role` for one drive across stripes."""
        return (drive - self.rotation_many(stripe_seqs)) % self.n


def make_scheme(name: str, n_drives: int) -> RaidScheme:
    name = name.lower()
    if name == "raid0":
        return RaidScheme("raid0", n_drives, 0, rotate=False)
    if name == "raid01":
        if n_drives % 2:
            raise ValueError("raid01 needs an even drive count")
        return RaidScheme("raid01", n_drives // 2, n_drives // 2, rotate=False, mirror=True)
    if name == "raid4":
        return RaidScheme("raid4", n_drives - 1, 1, rotate=False)
    if name == "raid5":
        return RaidScheme("raid5", n_drives - 1, 1, rotate=True)
    if name == "raid6":
        return RaidScheme("raid6", n_drives - 2, 2, rotate=True)
    raise ValueError(f"unknown RAID scheme {name!r}")


def check_device(device: str | torch.device) -> torch.device:
    """The torch device a codec runs on: ``cpu`` or ``cuda``.

    ``cuda`` with no GPU present raises: the port never falls back to the
    CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to run the plain versions on the host"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


class StripeCodec:
    """Encode/decode stripes for a scheme on ``device`` (``cuda`` or ``cpu``).

    Two byte-level surfaces exist side by side:

    * ``encode_np``/``decode_np`` -- blocking uint8-in/uint8-out calls for one
      stripe (the Zone-Write stripe build, degraded read, rebuild, OOB
      recovery).  A stripe that needs a kernel is staged into two buffers the
      codec owns, rows padded to 16-byte boundaries; on ``cuda`` they are
      pinned host memory the card maps, and one launch of the single-stripe
      kernel on the codec's own stream reads and writes them in place and
      waits for itself: no copy to or from device memory, one ctypes call,
      and the call never waits behind a group encode in flight on the
      current stream.  On ``cpu`` the plain version runs on the same staged
      buffers.  RAID-0, mirrors and survivor sets that hold every data row
      need no kernel;
    * ``encode_batch_async``/``decode_batch_async`` -- the group datapath:
      take an int32-packed host buffer (an arena gather), copy it to the
      device once, launch the kernel on the current CUDA stream and return
      the *un-materialized* device tensor, so the launch overlaps host-side
      commit work.  The caller syncs with :meth:`materialize`.  The
      ``_batch_np`` variants wrap them for uint8 buffers.

    ``copy_stats`` (optional) is an object with ``h2d_copies/h2d_bytes/
    d2h_copies/d2h_bytes`` counters (e.g. :class:`repro_torch.core.array.Stats`)
    that count the bytes crossing the host link as the reference counts
    them: per call, one transfer in of the packed operand and one transfer
    out of the result (a per-stripe kernel reads its operand across the link
    in place, and writes the rows it computes).

    A codec serves one thread at a time: each per-stripe call has finished
    with the staging buffers when it returns.
    """

    def __init__(self, scheme: RaidScheme, *, device: str | torch.device = "cuda"):
        self.scheme = scheme
        self.device = check_device(device)
        self.copy_stats = None
        # per-stripe staging: flat int32 views of the input and output
        # buffers, and per stripe shape the (k, n) and (rows_out, n) views
        # into them; on cuda also the pinned tensors behind them, their card
        # addresses, and the codec's stream
        self._cuda = self.device.type == "cuda"
        self._in = self._out = None
        self._views: dict[tuple[int, int, int], tuple[np.ndarray, ...]] = {}
        self._pinned: tuple[torch.Tensor, ...] = ()
        self._in_dev = self._out_dev = 0
        self._stream: torch.cuda.Stream | None = None
        self._stream_handle = 0

    # -- host<->device accounting -------------------------------------------

    def _count_h2d(self, nbytes: int) -> None:
        if self.copy_stats is not None:
            self.copy_stats.h2d_copies += 1
            self.copy_stats.h2d_bytes += nbytes

    def _count_d2h(self, nbytes: int) -> None:
        if self.copy_stats is not None:
            self.copy_stats.d2h_copies += 1
            self.copy_stats.d2h_bytes += nbytes

    def _to_device(self, packed_np: np.ndarray) -> torch.Tensor:
        self._count_h2d(packed_np.nbytes)
        # Always a copy, never torch.from_numpy's alias: the arena gather
        # doubles as the commit payload, and on the CPU device an alias would
        # let codec outputs share memory with buffers the caller still writes.
        host = np.ascontiguousarray(packed_np)
        if not host.flags.writeable:
            host = host.copy()
        return torch.from_numpy(host).to(self.device, copy=True)

    def materialize(self, out_dev: torch.Tensor) -> np.ndarray:
        """Sync point: wait for the device result and bring it to the host.

        Always a fresh host array (a copy even on the CPU device), so no
        caller can mutate a tensor the codec still holds."""
        out = out_dev.to("cpu", copy=True).numpy()
        self._count_d2h(out.nbytes)
        return out

    def _survivor_rows(self, roles: tuple[int, ...]) -> list[int | None]:
        """For each data role 0..k-1, the index of the surviving row that
        holds it (for mirrors, either copy), or None where it is lost; raises
        where the survivors cannot give the data back."""
        s = self.scheme
        if s.m == 0:
            raise ValueError("RAID-0 cannot decode lost chunks")
        if s.mirror:
            # role r and role r+k are copies; pick whichever survived.
            rows: dict[int, int] = {}
            for i, role in enumerate(roles):
                rows.setdefault(role % s.k, i)
            if len(rows) < s.k:
                raise ValueError("RAID-01: both copies of a chunk lost")
            return [rows[i] for i in range(s.k)]
        if len(roles) != s.k:
            raise ValueError(f"need exactly k={s.k} surviving rows, got {len(roles)}")
        return [roles.index(i) if i in roles else None for i in range(s.k)]

    # batched (stripe-group) datapath: data (S, k, n_i32) int32
    def encode_batch(self, data_i32: torch.Tensor) -> torch.Tensor:
        """Encode S stripes at once: (S, k, n) -> (S, m, n) parity.

        One kernel launch per group instead of one per stripe; the output is
        bit-identical to ``encode_np`` of each stripe.
        """
        s = self.scheme
        assert data_i32.ndim == 3 and data_i32.shape[1] == s.k, (data_i32.shape, s)
        if s.m == 0:
            return data_i32.new_zeros((data_i32.shape[0], 0, data_i32.shape[2]))
        if s.mirror:
            return data_i32
        if s.m == 1:
            return ops.xor_parity_batch(data_i32)[:, None, :]
        return ops.rs_encode_batch(data_i32, s.m)

    def decode_batch(
        self, surviving_i32: torch.Tensor, surviving_roles: tuple[int, ...]
    ) -> torch.Tensor:
        """Reconstruct S stripes' data chunks from survivors sharing one role
        set: (S, k, n) survivors -> (S, k, n) data, bit-identical to
        ``decode_np`` of each stripe."""
        s = self.scheme
        rows = self._survivor_rows(tuple(surviving_roles))
        if None not in rows:  # all data survives (possibly permuted): reorder
            return surviving_i32[:, rows]
        if s.m == 1:  # single parity: the lost chunk is the XOR of the survivors
            rec = ops.xor_parity_batch(surviving_i32)
            return torch.stack([rec if r is None else surviving_i32[:, r] for r in rows], dim=1)
        return ops.rs_decode_batch(surviving_i32, tuple(surviving_roles), s.k, s.m)

    # -- single stripes: staged host buffers, one kernel launch -------------

    def _stage_views(self, k: int, rows_out: int, n: int) -> tuple[np.ndarray, ...]:
        """The staging buffers' (k, ld) input and (rows_out, ld) output rows
        for one stripe shape, ``ld`` = n rounded up to 4 lanes so each row
        starts on a 16-byte boundary, and their first n lanes; the buffers
        grow (doubling) when a shape needs more.  Cached per shape."""
        ld = -(-n // 4) * 4
        need_in, need_out = k * ld, rows_out * ld
        if self._in is None or self._in.size < need_in or self._out.size < need_out:
            have_in, have_out = (0, 0) if self._in is None else (self._in.size, self._out.size)
            self._alloc(max(need_in, 2 * have_in), max(need_out, 2 * have_out))
        padded_in = self._in[:need_in].reshape(k, ld)
        padded_out = self._out[:need_out].reshape(rows_out, ld)
        views = (padded_in, padded_out, padded_in[:, :n], padded_out[:, :n])
        self._views[(k, rows_out, n)] = views
        return views

    def _alloc(self, words_in: int, words_out: int) -> None:
        self._views.clear()
        if not self._cuda:
            self._in, self._out = np.empty(words_in, np.int32), np.empty(words_out, np.int32)
            return
        _build.require_host_mapping()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._stream_handle = self._stream.cuda_stream
        self._pinned = tuple(torch.empty(w, dtype=torch.int32, pin_memory=True)
                             for w in (words_in, words_out))
        self._in_dev, self._out_dev = (_build.host_device_pointer(b) for b in self._pinned)
        # pinned allocations are page-aligned and rows start every 4 lanes,
        # so every staged row takes the kernels' 16-byte loads and stores
        assert self._in_dev % 16 == 0 and self._out_dev % 16 == 0, "unaligned staging"
        self._in, self._out = (b.numpy() for b in self._pinned)

    def _stripe(self, packed: np.ndarray, rows_out: int,
                coeff: torch.Tensor | None) -> np.ndarray:
        """One stripe through its kernel on the staging buffers: (k, n) int32
        -> (rows_out, n) int32, a fresh array.  XOR (rows_out = 1) when
        ``coeff`` is None, else the GF product with the (rows_out, k) CPU
        int32 coefficients."""
        k, n = packed.shape
        views = self._views.get((k, rows_out, n)) or self._stage_views(k, rows_out, n)
        padded_in, padded_out, src, dst = views
        np.copyto(src, packed)
        ld = padded_in.shape[1]
        if self._cuda:
            if coeff is None:
                parity_xor.stripe_launch(self._in_dev, self._out_dev, k, ld, True,
                                         self._stream_handle, True)
            else:
                gf256_matmul.stripe_launch(coeff.data_ptr(), rows_out, k, self._in_dev,
                                           self._out_dev, ld, True, self._stream_handle,
                                           True)
        else:  # the plain versions on the same staged rows, padding included
            data = torch.from_numpy(padded_in)
            res = ops.xor_parity(data)[None] if coeff is None else ops.rs_matmul(coeff, data)
            padded_out[:] = res.numpy()
        return dst.copy()

    def decode_np(self, surviving: np.ndarray, surviving_roles: tuple[int, ...]) -> np.ndarray:
        """Byte-level convenience wrapper (uint8 in/out) used by recovery paths."""
        s = self.scheme
        roles = tuple(surviving_roles)
        packed = ops.pack_bytes_np(surviving)
        self._count_h2d(packed.nbytes)
        rows = self._survivor_rows(roles)
        if None in rows and s.m > 1:
            out = self._stripe(packed, s.k, ops.rs_decode_coeff(s.k, s.m, roles, "cpu"))
        else:  # the surviving data rows in role order (a reorder if none is lost)
            out = packed[[0 if r is None else r for r in rows]]
            if None in rows:  # single parity: the lost row is the XOR of the survivors
                out[rows.index(None)] = self._stripe(packed, 1, None)[0]
        self._count_d2h(out.nbytes)
        return ops.unpack_bytes_np(out)

    def encode_np(self, data: np.ndarray) -> np.ndarray:
        s = self.scheme
        if not s.m:
            return np.zeros((0, data.shape[1]), np.uint8)
        packed = ops.pack_bytes_np(data)
        assert packed.shape[0] == s.k, (packed.shape, s)
        self._count_h2d(packed.nbytes)
        if s.mirror:  # the parity rows are copies
            out = packed.copy()
        else:
            coeff = None if s.m == 1 else ops.rs_parity_coeff(s.k, s.m, "cpu")
            out = self._stripe(packed, s.m, coeff)
        self._count_d2h(out.nbytes)
        return ops.unpack_bytes_np(out).reshape(s.m, -1)

    @staticmethod
    def _pad_batch(data: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad the stripe dim to the next power of two (zero stripes).

        Kept from the JAX package, where it bounds the number of compiled
        shapes: here it keeps the transfer sizes and ``copy_stats`` equal to
        the reference's.  Zero padding is exact: every scheme's codec is
        stripe-independent.
        """
        s_count = data.shape[0]
        target = 1 << max(0, (s_count - 1).bit_length())
        if target != s_count:
            data = np.concatenate(
                [data, np.zeros((target - s_count, *data.shape[1:]), data.dtype)]
            )
        return data, s_count

    def encode_batch_np(self, data: np.ndarray) -> np.ndarray:
        """(S, k, n_bytes) uint8 -> (S, m, n_bytes) parity, one pack/unpack
        round-trip and one kernel launch for the whole batch."""
        s_count, _, n_bytes = data.shape
        if self.scheme.m == 0:
            return np.zeros((s_count, 0, n_bytes), np.uint8)
        out_dev = self.encode_batch_async(
            ops.pack_bytes_np(self._pad_batch(np.ascontiguousarray(data))[0])
        )
        return ops.unpack_bytes_np(self.materialize(out_dev))[:s_count]

    def decode_batch_np(
        self, surviving: np.ndarray, surviving_roles: tuple[int, ...]
    ) -> np.ndarray:
        """(S, k, n_bytes) uint8 survivors -> (S, k, n_bytes) data."""
        s_count = surviving.shape[0]
        out_dev = self.decode_batch_async(
            ops.pack_bytes_np(self._pad_batch(np.ascontiguousarray(surviving))[0]),
            surviving_roles,
        )
        return ops.unpack_bytes_np(self.materialize(out_dev))[:s_count]

    # -- device-resident group entry points (async) --------------------------

    def encode_batch_async(self, packed_np: np.ndarray) -> torch.Tensor:
        """Launch a group encode and return the device tensor.

        ``packed_np`` is an int32-packed (S, k, n_i32) host buffer (typically
        a fresh arena gather, already power-of-two bucketed); it is copied to
        the device once and the kernel is launched on the current stream.
        The returned tensor is not synchronized -- the encode runs while the
        caller commits the previous group; sync via :meth:`materialize`."""
        s = self.scheme
        assert packed_np.ndim == 3 and packed_np.shape[1] == s.k, packed_np.shape
        packed = self._to_device(packed_np)
        return self.encode_batch(packed)

    def decode_batch_async(
        self, packed_np: np.ndarray, surviving_roles: tuple[int, ...]
    ) -> torch.Tensor:
        """Async variant of :meth:`decode_batch` on a host buffer (see above)."""
        if self.scheme.m == 0:
            raise ValueError("RAID-0 cannot decode lost chunks")
        return self.decode_batch(self._to_device(packed_np), surviving_roles)


def _meta_rows(lbas: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """(rows, c) u64 LBAs + (rows, c) u64 timestamps -> (rows, 16c) bytes."""
    rows = lbas.shape[0]
    return np.concatenate(
        [
            np.ascontiguousarray(lbas.astype(np.uint64)).view(np.uint8).reshape(rows, -1),
            np.ascontiguousarray(ts.astype(np.uint64)).view(np.uint8).reshape(rows, -1),
        ],
        axis=1,
    )


def _meta_unrows(raw: np.ndarray, c: int) -> tuple[np.ndarray, np.ndarray]:
    rows = raw.shape[0]
    lbas = np.ascontiguousarray(raw[:, : 8 * c]).view(np.uint64).reshape(rows, c)
    ts = np.ascontiguousarray(raw[:, 8 * c :]).view(np.uint64).reshape(rows, c)
    return lbas, ts


def parity_oob(
    codec: "StripeCodec", data_lbas: np.ndarray, data_ts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Paper §3.1: parity blocks carry parity-based redundancy of the data
    blocks' LBAs and timestamps (the stripe id is replicated separately).

    We encode the metadata with the *same* erasure code as the payload, so
    metadata survives exactly the failures the payload survives (XOR for
    m=1, RS for m=2, copies for mirrors)."""
    c = data_lbas.shape[1]
    rows = _meta_rows(data_lbas, data_ts)
    enc = codec.encode_np(rows)
    return _meta_unrows(enc, c)


def _meta_rows_batch(lbas: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """(S, rows, c) u64 LBAs + timestamps -> (S, rows, 16c) bytes."""
    s, rows, c = lbas.shape
    return np.concatenate(
        [
            np.ascontiguousarray(lbas.astype(np.uint64)).view(np.uint8).reshape(s, rows, -1),
            np.ascontiguousarray(ts.astype(np.uint64)).view(np.uint8).reshape(s, rows, -1),
        ],
        axis=2,
    )


def _meta_unrows_batch(raw: np.ndarray, c: int) -> tuple[np.ndarray, np.ndarray]:
    s, rows = raw.shape[0], raw.shape[1]
    lbas = np.ascontiguousarray(raw[:, :, : 8 * c]).view(np.uint64).reshape(s, rows, c)
    ts = np.ascontiguousarray(raw[:, :, 8 * c :]).view(np.uint64).reshape(s, rows, c)
    return lbas, ts


def parity_oob_batch(
    codec: "StripeCodec", data_lbas: np.ndarray, data_ts: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Batched ``parity_oob``: (S, k, c) metadata -> (S, m, c) parity metadata
    in one fused encode (bit-identical to the per-stripe path)."""
    c = data_lbas.shape[2]
    rows = _meta_rows_batch(data_lbas, data_ts)
    enc = codec.encode_batch_np(rows)
    return _meta_unrows_batch(enc, c)


def decode_meta_batch(
    codec: "StripeCodec",
    surviving_lbas: np.ndarray,
    surviving_ts: np.ndarray,
    surviving_roles: tuple[int, ...],
) -> tuple[np.ndarray, np.ndarray]:
    """Batched ``decode_meta``: (S, k, c) surviving metadata rows sharing one
    role set -> all S stripes' (k, c) data metadata in one fused decode."""
    c = surviving_lbas.shape[2]
    rows = _meta_rows_batch(surviving_lbas, surviving_ts)
    dec = codec.decode_batch_np(rows, surviving_roles)
    return _meta_unrows_batch(dec.reshape(rows.shape[0], codec.scheme.k, -1), c)


def decode_meta(
    codec: "StripeCodec",
    surviving_lbas: np.ndarray,
    surviving_ts: np.ndarray,
    surviving_roles: tuple[int, ...],
) -> tuple[np.ndarray, np.ndarray]:
    """Reconstruct all k data rows' (lba, ts) metadata from k survivors."""
    c = surviving_lbas.shape[1]
    rows = _meta_rows(surviving_lbas, surviving_ts)
    dec = codec.decode_np(rows, surviving_roles)
    return _meta_unrows(dec.reshape(codec.scheme.k, -1), c)


def gf_coeff_matrix(k: int, m: int) -> np.ndarray:
    return gf.rs_parity_matrix(k, m)
