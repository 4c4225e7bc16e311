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

The gradient.  :class:`SSDScanFn` is the scan as a ``torch.autograd.Function``:
on the card its forward is the same kernel, also writing the state that
enters each chunk (``hprev``, (B, T/q, H, N, P) f32, the reference's
``h_prev``), and its backward launches ``csrc/ssd_scan_bwd.cu``
(:func:`ssd_scan_bwd`): dx, ddt, da, db, dc and dh0 from dy and the final
state's gradient on the tensor cores, b's and c's summed over the heads in
registers in a fixed order, so the same inputs give the same bits (its
per-chunk kernel stages (q, p) tiles: p <= 64, ``MAX_BWD_P``).  On the CPU
its forward is the plain version and its backward autograd through it
(:func:`ssd_scan_bwd_plain`), which is also what the tests and
``chip_smoke.py`` hold the kernel to.

``LAUNCHES`` counts kernel launches: ``ssd_scan`` once per scan and
``ssd_chunk_gram`` once per scan or ``chunk_gram`` call; ``ssd_scan_bwd``
once per backward call (its six kernels: the chunk scans, the state
gradients chunk by chunk, the per-chunk gradients of each group of heads, db
and dc, ds's reverse cumsum, da).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

DEFAULT_CHUNK = 128
# q, n and p limits of the kernels; at q = n = 128 the scan's block takes
# 184,320 bytes of shared memory, inside a Hopper block's 232,448.
MAX_DIM = 128
# p limit of the backward kernel, whose per-chunk blocks hold a head's x, dy
# and dH' tiles in shared memory beside G and dG.
MAX_BWD_P = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"ssd_scan": 0, "ssd_chunk_gram": 0, "ssd_scan_bwd": 0}


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


def _strides3(v, rows: bool):
    """(batch, head, time) element strides of a (B, T, H, ...) operand, or of
    a (bh, t, ...) one in the rows layout (batch = bh, one head)."""
    return (v.stride(0), 0, v.stride(1)) if rows else (v.stride(0), v.stride(2), v.stride(1))


def _a_strides(a, rows: bool):
    """(batch, head) strides of a: one value per row, or per head."""
    return (a.stride(0), 0) if rows else (0, a.stride(0))


def _launch(x, dt, a, b, c, h0, nb, nh, t, q, n, p, hprev=None):
    dev = x.device
    rows = x.ndim == 3
    y = torch.empty((nb, t, p) if rows else (nb, t, nh, p), dtype=torch.float32, device=dev)
    hout = torch.empty((nb, n, p) if rows else (nb, nh, n, p), dtype=torch.float32,
                       device=dev)
    sx, sdt, sa, sy = _strides3(x, rows), _strides3(dt, rows), _a_strides(a, rows), \
        _strides3(y, rows)
    if y.numel() == 0 and hout.numel() == 0:
        return y, hout
    gram = _gram_scratch(nb, t, q, dev)
    strides = (ctypes.c_longlong * 15)(*sx, *sdt, *sa, b.stride(0), b.stride(1),
                                       c.stride(0), c.stride(1), *sy)
    _build.launch("ssd_scan", _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                  b.data_ptr(), c.data_ptr(), None if h0 is None else h0.data_ptr(),
                  gram.data_ptr(), y.data_ptr(), hout.data_ptr(),
                  None if hprev is None else hprev.data_ptr(), nb * nh, nh, t, q, n, p,
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


# ------------------------------------------------------------------ gradient

def _state_shape(nb, nh, t, q, n, p, rows: bool):
    """Shape of the per-chunk states (``hprev``) of a scan."""
    return (nb, t // q, 1, n, p) if rows else (nb, t // q, nh, n, p)


def ssd_scan_states(x, dt, a, b, c, h0=None, *, chunk: int = DEFAULT_CHUNK):
    """The scan on the card that also returns the state entering each chunk:
    (y, h_final, hprev (B, T/q, H, N, P) f32; (bh, t/q, 1, n, p) in the rows
    layout).  CUDA tensors only."""
    nb, nh, t, q, n, p = _geometry(x, dt, a, b, c, h0, chunk)
    if x.device.type != "cuda":
        raise ValueError("ssd_scan_states: the chunk states come from the CUDA kernel")
    _check_kernel_operands(x, b, c, h0, q, n, p)
    hprev = torch.empty(_state_shape(nb, nh, t, q, n, p, x.ndim == 3), dtype=torch.float32,
                        device=x.device)
    y, h = _launch(x, dt, a, b, c, h0, nb, nh, t, q, n, p, hprev)
    return y, h, hprev


def ssd_scan_bwd_plain(x, dt, a, b, c, h0, dy, dh, *, chunk: int = DEFAULT_CHUNK):
    """The plain version of the gradient: autograd through
    :func:`ssd_scan_plain` (``chunk`` only checks the geometry).  Returns
    (dx, ddt, da, db, dc, dh0), dh0 None without h0."""
    _geometry(x, dt, a, b, c, h0, chunk)
    ins = [v.detach().requires_grad_() if v is not None else None
           for v in (x, dt, a, b, c, h0)]
    with torch.enable_grad():
        y, h = ssd_scan_plain(*ins)
        outs, grads = [y], [dy]
        if dh is not None:
            outs.append(h)
            grads.append(dh)
        live = [v for v in ins if v is not None]
        got = torch.autograd.grad(outs, live, grads, allow_unused=True)
    it = iter(got)
    return tuple(None if v is None else next(it) for v in ins)


def ssd_scan_bwd(x, dt, a, b, c, h0, dy, dh, *, chunk: int = DEFAULT_CHUNK, hprev=None):
    """The scan's gradient: (dx, ddt, da, db, dc, dh0) from ``dy`` (y's
    gradient, f32) and ``dh`` (h_final's, or None for zeros); dh0 is None
    without h0.  dx, db, dc come back in x's type, the rest in f32.  A CPU
    tensor takes :func:`ssd_scan_bwd_plain`; a CUDA tensor launches
    ``csrc/ssd_scan_bwd.cu``, reading the chunk states ``hprev`` of the
    forward (:func:`ssd_scan_states`; recomputed when not given)."""
    nb, nh, t, q, n, p = _geometry(x, dt, a, b, c, h0, chunk)
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    _check_kernel_operands(x, b, c, h0, q, n, p)
    if p > MAX_BWD_P:
        raise ValueError(f"ssd_scan_bwd: the CUDA kernel takes p <= {MAX_BWD_P}, got p={p}")
    rows = x.ndim == 3
    y_shape = (nb, t, p) if rows else (nb, t, nh, p)
    h_shape = (nb, n, p) if rows else (nb, nh, n, p)
    if tuple(dy.shape) != y_shape or (dh is not None and tuple(dh.shape) != h_shape):
        raise ValueError(f"ssd_scan_bwd: dy must be {y_shape} and dh {h_shape}")
    if hprev is None:
        _, _, hprev = ssd_scan_states(x, dt, a, b, c, h0, chunk=chunk)
    if tuple(hprev.shape) != _state_shape(nb, nh, t, q, n, p, rows) or \
            hprev.dtype != torch.float32 or not hprev.is_contiguous():
        raise ValueError(f"ssd_scan_bwd: hprev must be contiguous f32 "
                         f"{_state_shape(nb, nh, t, q, n, p, rows)}")
    dev, f32 = x.device, torch.float32
    dy = dy.to(f32).contiguous()
    dh = None if dh is None else dh.to(f32).contiguous()
    nrows, nc = nb * nh, t // q
    groups, hg = _head_groups(nb * nc, nh, dev)
    nslices, qt = -(-n // 32), -(-q // 16)
    dstate = torch.empty_like(hprev)
    dx = torch.empty(y_shape, dtype=x.dtype, device=dev)
    ddt = torch.empty(dt.shape, dtype=f32, device=dev)
    dh0 = torch.empty(h_shape, dtype=f32, device=dev) if h0 is not None else None
    sv = torch.empty((5, nrows, t), dtype=f32, device=dev)
    dsp = torch.empty((3, nrows, t), dtype=f32, device=dev)
    qvp = torch.empty((nrows, 2 * nslices, t), dtype=f32, device=dev)
    hsp = torch.empty((nrows, nc, nslices, 16), dtype=f32, device=dev)
    dgp = torch.empty((nb, nc, groups, qt * (qt + 1) // 2, 256), dtype=f32, device=dev)
    dap = torch.empty((nrows, nc), dtype=f32, device=dev)
    db = torch.empty((nb, t, n), dtype=x.dtype, device=dev)
    dc = torch.empty_like(db)
    da = torch.empty(a.shape, dtype=f32, device=dev)
    strides = (ctypes.c_longlong * 21)(
        *_strides3(x, rows), *_strides3(dt, rows), *_a_strides(a, rows),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        *_strides3(dy, rows), *_strides3(dx, rows), *_strides3(ddt, rows))
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    _build.launch("ssd_scan_bwd", _DTYPES[x.dtype],
                  *(ptr(v) for v in (x, dt, a, b, c, dy, dh, hprev, dstate, dx, ddt, dh0, sv,
                                     dsp, qvp, hsp, dgp, dap, db, dc, da)),
                  nrows, nh, t, q, n, p, int(rows), a.shape[0], groups, hg, strides)
    LAUNCHES["ssd_scan_bwd"] += 1
    return dx, ddt, da, db, dc, dh0


def _head_groups(chunks: int, nh: int, device) -> tuple[int, int]:
    """(groups, heads per group) of the backward's per-chunk kernel: about
    one block per SM over the (batch, chunk) pairs, each block looping over
    its group's heads (mamba2-1.3b's training shape on 132 SMs: 4 groups of
    16 heads, 128 blocks)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = max(1, min(nh, sms // max(1, chunks)))
    hg = -(-nh // groups)
    return -(-nh // hg), hg


class SSDScanFn(torch.autograd.Function):
    """The scan with its gradient: ``SSDScanFn.apply(x, dt, a, b, c, h0,
    chunk) -> (y, h_final)``, both f32.  On the card the forward keeps the
    chunk states for the backward kernel; on the CPU the plain version runs
    both ways.  A gradient given as None counts as zeros; dh0 is None when
    h0 is."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0, chunk):
        if x.device.type == "cuda":
            y, h, hprev = ssd_scan_states(x, dt, a, b, c, h0, chunk=chunk)
        else:
            y, h = ssd_scan(x, dt, a, b, c, h0, chunk=chunk)
            hprev = None
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b, c, h0, hprev)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, b, c, h0, hprev = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_scan_bwd(x, dt, a, b, c, h0, dy, dh, chunk=ctx.chunk, hprev=hprev)
        return (*grads, None)
