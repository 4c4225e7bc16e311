"""Chunked Mamba-2 SSD scan: the wrapper of the ``ssd_scan`` kernels.

The SSD recurrence  h_t = exp(dt_t*a) h_{t-1} + dt_t (b_t (x) x_t),
y_t = c_t . h_t  is the compute hot spot of Mamba-2 prefill.  The device of
the tensors picks the path: CPU tensors run the plain sequential version
(``ref.ssd_scan_ref``); CUDA tensors launch the two kernels of
``csrc/ssd_scan.cu`` or raise: ``ssd_chunk_gram`` (G = C B^T once per batch
row and chunk of q steps) and ``ssd_scan`` (one block per (batch, head,
32-column slice of p) looping over the chunks on the tensor cores, the f32
state in registers).

Two layouts are taken, told apart by the rank of ``x``:

* rows, the Pallas kernel's: x (bh, t, p), dt (bh, t), a (bh,),
  b and c (bh, t, n), h0 (bh, n, p) -> y (bh, t, p), h (bh, n, p);
* heads, the model's: x (B, T, H, P), dt (B, T, H), a (H,), b and c
  (B, T, N) shared by the H heads of a batch row, h0 (B, H, N, P)
  -> y (B, T, H, P), h (B, H, N, P).

The kernels read every operand through its strides (the innermost dimension
of x, b and c must be contiguous), so the model's strided views pass as they
are and b, c are never expanded per head.  x, b and c are f32 or bf16 (one
type); dt, a and h0 are f32; y and h come back in f32.  As in the Pallas
kernel, q = min(chunk, t) and t must be a multiple of q: ``ssd_chunked``
pads a ragged t with dt = 0 steps before it calls here.

``LAUNCHES`` counts kernel launches: ``ssd_scan`` once per scan and
``ssd_chunk_gram`` once per scan or ``chunk_gram`` call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

DEFAULT_CHUNK = 128
# q, n and p limits of the kernels; at q = n = 128 the scan's block takes
# 184,320 bytes of shared memory, inside a Hopper block's 232,448.
MAX_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"ssd_scan": 0, "ssd_chunk_gram": 0}


def _geometry(x, dt, a, b, c, h0, chunk):
    """Validate the operands; return (batch, heads, t, q, n, p)."""
    if x.ndim == 3:
        nb, t, p = x.shape
        nh = 1
    elif x.ndim == 4:
        nb, t, nh, p = x.shape
    else:
        raise ValueError(f"ssd_scan: x must be (bh,t,p) or (B,T,H,P), got {tuple(x.shape)}")
    if b.ndim != 3:
        raise ValueError(f"ssd_scan: b must be 3-d, got {tuple(b.shape)}")
    n = b.shape[-1]
    rows = x.ndim == 3
    want = {
        "dt": (nb, t) if rows else (nb, t, nh),
        "a": (nb,) if rows else (nh,),
        "b": (nb, t, n),
        "c": (nb, t, n),
        "h0": (nb, n, p) if rows else (nb, nh, n, p),
    }
    ops = {"dt": dt, "a": a, "b": b, "c": c, "h0": h0}
    for name, v in ops.items():
        if v is not None and tuple(v.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} must be {want[name]}, got {tuple(v.shape)}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, b, c must share one type of {list(_DTYPES)}, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    for name in ("dt", "a", "h0"):
        if ops[name] is not None and ops[name].dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got {ops[name].dtype}")
    if t < 1 or chunk < 1:
        raise ValueError(f"ssd_scan: need t >= 1 and chunk >= 1, got t={t}, chunk={chunk}")
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"ssd_scan: t={t} is not a multiple of the chunk q={q}; "
                         "pad with dt=0 steps (ssd_chunked does)")
    devices = {v.device for v in (x, *ops.values()) if v is not None}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan: operands on several devices {sorted(map(str, devices))}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return nb, nh, t, q, n, p


def _check_kernel_operands(x, b, c, h0, q, n, p):
    if max(q, n, p) > MAX_DIM:
        raise ValueError(f"ssd_scan: the CUDA kernel takes q, n, p <= {MAX_DIM}, "
                         f"got q={q}, n={n}, p={p}")
    for name, v in (("x", x), ("b", b), ("c", c)):
        if v.stride(-1) != 1:
            raise ValueError(f"ssd_scan: the innermost dimension of {name} must be contiguous")
    if h0 is not None and not h0.is_contiguous():
        raise ValueError("ssd_scan: h0 must be contiguous")


def _launch(x, dt, a, b, c, h0, nb, nh, t, q, n, p):
    dev = x.device
    if x.ndim == 4:
        y = torch.empty((nb, t, nh, p), dtype=torch.float32, device=dev)
        hout = torch.empty((nb, nh, n, p), dtype=torch.float32, device=dev)
        # (batch, head, time) strides of each operand
        sx = (x.stride(0), x.stride(2), x.stride(1))
        sdt = (dt.stride(0), dt.stride(2), dt.stride(1))
        sa = (0, a.stride(0))
        sy = (y.stride(0), y.stride(2), y.stride(1))
    else:  # rows layout: batch = bh, one head
        y = torch.empty((nb, t, p), dtype=torch.float32, device=dev)
        hout = torch.empty((nb, n, p), dtype=torch.float32, device=dev)
        sx = (x.stride(0), 0, x.stride(1))
        sdt = (dt.stride(0), 0, dt.stride(1))
        sa = (a.stride(0), 0)
        sy = (y.stride(0), 0, y.stride(1))
    if y.numel() == 0 and hout.numel() == 0:
        return y, hout
    gram = _gram_scratch(nb, t, q, dev)
    strides = (ctypes.c_longlong * 15)(*sx, *sdt, *sa, b.stride(0), b.stride(1),
                                       c.stride(0), c.stride(1), *sy)
    _build.launch("ssd_scan", _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                  b.data_ptr(), c.data_ptr(), None if h0 is None else h0.data_ptr(),
                  gram.data_ptr(), y.data_ptr(), hout.data_ptr(), nb * nh, nh, t, q, n, p,
                  strides)
    LAUNCHES["ssd_chunk_gram"] += 1
    LAUNCHES["ssd_scan"] += 1
    return y, hout


def _gram_scratch(nb, t, q, device):
    """The G tiles of (nb, t) b, c in chunks of q, as ``ref.ssd_chunk_gram_ref``
    lays them out."""
    qt = -(-q // 16)
    return torch.empty((nb, t // q, qt * (qt + 1) // 2, 32, 8), dtype=torch.float32,
                       device=device)


def chunk_gram(b, c, *, chunk: int = DEFAULT_CHUNK):
    """G = C B^T of each chunk of q = min(chunk, t) steps of b, c (nb, t, n):
    its 16 x 16 tiles on and below the diagonal in the scan kernel's order,
    (nb, t // q, tiles, 32, 8) f32 (see ``ref.ssd_chunk_gram_ref``).  The scan
    runs this kernel itself; the entry point lets a test hold it alone."""
    if b.ndim != 3 or c.shape != b.shape or b.dtype not in _DTYPES or c.dtype != b.dtype \
            or b.device != c.device or b.shape[1] < 1 or chunk < 1 \
            or b.shape[1] % min(chunk, b.shape[1]):
        raise ValueError(f"chunk_gram: want b, c of one shape (nb, t, n), one type of "
                         f"{list(_DTYPES)} and t % q == 0, got {tuple(b.shape)} {b.dtype}, "
                         f"{tuple(c.shape)} {c.dtype}, chunk={chunk}")
    nb, t, n = b.shape
    q = min(chunk, t)
    if b.device.type == "cpu":
        return ref.ssd_chunk_gram_ref(b, c, q)
    if max(q, n) > MAX_DIM or b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError(f"chunk_gram: the CUDA kernel takes q, n <= {MAX_DIM} and "
                         f"contiguous n, got q={q}, n={n}")
    gram = _gram_scratch(nb, t, q, b.device)
    strides = (ctypes.c_longlong * 4)(b.stride(0), b.stride(1), c.stride(0), c.stride(1))
    _build.launch("ssd_chunk_gram", _DTYPES[b.dtype], b.data_ptr(), c.data_ptr(),
                  gram.data_ptr(), nb, t, q, n, strides)
    LAUNCHES["ssd_chunk_gram"] += 1
    return gram


def ssd_scan_plain(x, dt, a, b, c, h0=None):
    """The plain version in either layout: ``ref.ssd_scan_ref`` per row
    (the heads layout is reshaped to rows and b, c expanded per head)."""
    if x.ndim == 3:
        return ref.ssd_scan_ref(x, dt, a, b, c, h0)
    nb, t, nh, p = x.shape
    n = b.shape[-1]

    def per_head(v):  # (B, T, N) -> (B*H, T, N)
        return v[:, None].expand(nb, nh, t, n).reshape(nb * nh, t, n)

    y, h = ref.ssd_scan_ref(
        x.permute(0, 2, 1, 3).reshape(nb * nh, t, p),
        dt.permute(0, 2, 1).reshape(nb * nh, t),
        a.expand(nb, nh).reshape(nb * nh),
        per_head(b), per_head(c),
        None if h0 is None else h0.reshape(nb * nh, n, p),
    )
    return (y.reshape(nb, nh, t, p).permute(0, 2, 1, 3).contiguous(),
            h.reshape(nb, nh, n, p))


def ssd_scan(x, dt, a, b, c, h0=None, *, chunk: int = DEFAULT_CHUNK):
    """Blocked SSD scan in either layout; returns (y f32, h_final f32)."""
    nb, nh, t, q, n, p = _geometry(x, dt, a, b, c, h0, chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, h0)
    _check_kernel_operands(x, b, c, h0, q, n, p)
    return _launch(x, dt, a, b, c, h0, nb, nh, t, q, n, p)
