"""The port's SSD scan against the JAX package's, on the same inputs.

On the CPU the port's ``ssd_scan`` wrapper runs its plain sequential version
(``repro_torch.kernels.ref.ssd_scan_ref``).  These tests hold it, through
``ops.ssd_chunk_scan``, against the JAX sequential reference and the Pallas
kernel run in interpret mode, at the JAX suite's shapes and tolerances
(``tests/test_kernels.py``: 2e-5 in f32, 3e-2 in bf16, 1e-4 for state
continuation, 2e-4 for ``ssd_chunked``).  Inputs are made with numpy from a
seed.  The CUDA kernels themselves run only on the card
(``test_torch_cuda.py``, ``chip_smoke.py``); here ``emulate_ssd_kernel``
repeats their arithmetic in plain torch -- the chunking, the p-slices, the
hi/lo bf16 split of every operand computed in f32, exact bf16 products and
f32 sums -- and holds it against the references at the card tests' 1e-4,
and ``chunk_gram``'s tile layout is held against the JAX products.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.mamba2 import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.mamba2 import ssd_chunked as t_ssd_chunked

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(seed, bh, t, p, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, t, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (bh, t)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (bh,)).astype(np.float32),
            rng.standard_normal((bh, t, n)).astype(np.float32),
            rng.standard_normal((bh, t, n)).astype(np.float32))


def _j(arrs, dtype):
    x, dt, a, b, c = arrs
    return (jnp.asarray(x, dtype), jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(b, dtype), jnp.asarray(c, dtype))


def _t(arrs, dtype):
    x, dt, a, b, c = arrs
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(dt), torch.from_numpy(a),
            torch.from_numpy(b).to(dtype), torch.from_numpy(c).to(dtype))


def _close(got: torch.Tensor, want, tol):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("t,chunk", [(64, 16), (128, 128), (256, 64)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_chunk_scan_matches_reference_and_pallas(t, chunk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrs = _inputs(t + chunk, 3, t, 8, 16)
    y0, h0 = jref.ssd_scan_ref(*_j(arrs, jdt))
    y1, h1 = jops.ssd_chunk_scan(*_j(arrs, jdt), chunk=chunk, use_pallas=True, interpret=True)
    reset_launch_counts()
    y, h = tops.ssd_chunk_scan(*_t(arrs, tdt), chunk=chunk)
    assert launch_counts()["ssd_scan"] == 0  # the CPU runs the plain version
    for want_y, want_h in ((y0, h0), (y1, h1)):
        _close(y, want_y, tol)
        _close(h, want_h, tol)


def test_ssd_state_continuation_matches_reference():
    """Scanning [first half] then [second half from the carried state]
    matches one full scan and the JAX package's split scan."""
    x, dt, a, b, c = _inputs(5, 2, 128, 4, 8)
    half = 64
    split = lambda v: (v[:, :half], v[:, half:])  # noqa: E731
    (x1, x2), (dt1, dt2), (b1, b2), (c1, c2) = map(split, (x, dt, b, c))
    jy1, jh1 = jops.ssd_chunk_scan(*_j((x1, dt1, a, b1, c1), jnp.float32), chunk=32)
    jy2, jh2 = jops.ssd_chunk_scan(*_j((x2, dt2, a, b2, c2), jnp.float32), jh1, chunk=32)
    y_full, h_full = tops.ssd_chunk_scan(*_t((x, dt, a, b, c), torch.float32), chunk=32)
    y1, h1 = tops.ssd_chunk_scan(*_t((x1, dt1, a, b1, c1), torch.float32), chunk=32)
    y2, h2 = tops.ssd_chunk_scan(*_t((x2, dt2, a, b2, c2), torch.float32), h1, chunk=32)
    _close(y2, y_full[:, half:].numpy(), 1e-4)
    _close(h2, h_full.numpy(), 1e-4)
    _close(y2, jy2, 1e-4)
    _close(h2, jh2, 1e-4)


@pytest.mark.parametrize("t", [96, 100])
def test_ssd_chunked_matches_reference(t):
    """The port's ``ssd_chunked`` (heads layout, b/c shared across heads,
    a ragged t padded with dt=0 steps) against the JAX one."""
    rng = np.random.default_rng(11 + t)
    bsz, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((bsz, t, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (bsz, t, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    b = rng.standard_normal((bsz, t, n)).astype(np.float32)
    c = rng.standard_normal((bsz, t, n)).astype(np.float32)
    jy, jh = j_ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk=32)
    ty, th = t_ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), chunk=32)
    assert ty.shape == (bsz, t, h, p) and th.shape == (bsz, h, n, p)
    _close(ty, jy, 2e-4)
    _close(th, jh, 2e-4)


def test_heads_layout_equals_rows_layout():
    """The heads layout (b, c shared by the heads of a batch row, x as a
    strided view) gives what the rows layout gives with b, c repeated."""
    rng = np.random.default_rng(3)
    bsz, t, h, p, n = 2, 32, 3, 4, 8
    wide = torch.from_numpy(rng.standard_normal((bsz, t, h * p + 5)).astype(np.float32))
    x = wide[..., : h * p].reshape(bsz, t, h, p)  # strided, like the model's view
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (bsz, t, h)).astype(np.float32))
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, (h,)).astype(np.float32))
    b, c = (torch.from_numpy(rng.standard_normal((bsz, t, n)).astype(np.float32))
            for _ in range(2))
    h0 = torch.from_numpy(rng.standard_normal((bsz, h, n, p)).astype(np.float32))
    y, hf = tssd.ssd_scan(x, dt, a, b, c, h0, chunk=16)
    rows = lambda v: v.repeat_interleave(h, dim=0)  # noqa: E731
    yr, hr = tssd.ssd_scan(x.permute(0, 2, 1, 3).reshape(bsz * h, t, p),
                           dt.permute(0, 2, 1).reshape(bsz * h, t), a.repeat(bsz),
                           rows(b), rows(c), h0.reshape(bsz * h, n, p), chunk=16)
    torch.testing.assert_close(y, yr.reshape(bsz, h, t, p).permute(0, 2, 1, 3), rtol=0, atol=0)
    torch.testing.assert_close(hf, hr.reshape(bsz, h, n, p), rtol=0, atol=0)


@pytest.mark.parametrize("case,err", [
    ("ragged", ValueError), ("rank", ValueError), ("dt_shape", ValueError),
    ("int_x", TypeError), ("mixed", TypeError), ("dt_bf16", TypeError), ("empty_t", ValueError),
])
def test_bad_operands_raise(case, err):
    x, dt, a, b, c = _t(_inputs(0, 2, 32, 4, 8), torch.float32)
    args = {
        "ragged": (x[:, :30], dt[:, :30], a, b[:, :30], c[:, :30]),  # 30 % 16 != 0
        "rank": (x[0], dt, a, b, c),
        "dt_shape": (x, dt[:, :16], a, b, c),
        "int_x": (x.int(), dt, a, b.int(), c.int()),
        "mixed": (x, dt, a, b.bfloat16(), c),
        "dt_bf16": (x, dt.bfloat16(), a, b, c),
        "empty_t": (x[:, :0], dt[:, :0], a, b[:, :0], c[:, :0]),
    }[case]
    with pytest.raises(err):
        tssd.ssd_scan(*args, chunk=16)


# ------------------------------------------------ the CUDA kernel's arithmetic

def _split(v):
    """An f32 tensor as hi + lo bf16 halves (held in f32)."""
    hi = v.to(torch.bfloat16).float()
    return [hi, (v - hi).to(torch.bfloat16).float()]


def _parts(v):
    """A kernel input as the tensor cores take it: bf16 as it is, f32 as
    hi + lo bf16 halves."""
    return [v.float()] if v.dtype == torch.bfloat16 else _split(v.float())


def _mma(a_parts, b_parts):
    """sum_(i+j<=1) A_i B_j: bf16 x bf16 products are exact in f32 and the
    sums are f32, as in ``mma.sync ... .f32.bf16.bf16.f32``; lo x lo drops."""
    return sum(a @ b for i, a in enumerate(a_parts) for j, b in enumerate(b_parts) if i + j <= 1)


def emulate_ssd_kernel(x, dt, a, b, c, h0=None, *, chunk, p_slice=32):
    """Plain-torch emulation of ``csrc/ssd_scan.cu``'s arithmetic, heads
    layout: x (B,T,H,P) f32 or bf16, dt (B,T,H), a (H,), b and c (B,T,N),
    h0 (B,H,N,P) -> y (B,T,H,P), h (B,H,N,P), both f32.

    It walks what the kernel walks: G = C B^T once per (batch, chunk) (the
    prologue kernel), then per (batch, head, p-slice of ``p_slice`` columns)
    the chunks in order with the state carried in f32.  Every product runs
    on bf16 operands with f32 sums (``_mma``): inputs go in as they are
    (bf16) or as hi + lo halves (f32); the operands computed in f32 -- the
    masked decay matrix M = L o G * dt, the state h and B o w -- always go
    in as hi + lo halves.  The scan s = cumsum(dt a), exp(s) and
    w = dt exp(s_last - s) are f32, as in the kernel."""
    nb, t, nh, p = x.shape
    q = min(chunk, t)
    y = torch.zeros((nb, t, nh, p))
    hout = torch.zeros((nb, nh, b.shape[-1], p))
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    for bi in range(nb):
        gram = [_mma(_parts(c[bi, t0:t0 + q]), [v.T for v in _parts(b[bi, t0:t0 + q])])
                for t0 in range(0, t, q)]
        for hi in range(nh):
            for p0 in range(0, p, p_slice):
                cols = slice(p0, min(p0 + p_slice, p))
                h = torch.zeros((b.shape[-1], cols.stop - p0)) if h0 is None \
                    else h0[bi, hi, :, cols].float()
                for ci, t0 in enumerate(range(0, t, q)):
                    steps = slice(t0, t0 + q)
                    d = dt[bi, steps, hi].float()
                    s = torch.cumsum(d * a[hi].float(), 0)
                    xs = _parts(x[bi, steps, hi, cols])
                    m = torch.where(tri, torch.exp(torch.where(tri, s[:, None] - s, 0.0)),
                                    0.0) * d * gram[ci]
                    y[bi, steps, hi, cols] = (torch.exp(s)[:, None]
                                              * _mma(_parts(c[bi, steps]), _split(h))
                                              + _mma(_split(m), xs))
                    bw = sum(_parts(b[bi, steps])) * (d * torch.exp(s[-1] - s))[:, None]
                    h = torch.exp(s[-1]) * h + _mma(_split(bw.T.contiguous()), xs)
                hout[bi, hi, :, cols] = h
    return y, hout


def _heads_inputs(seed, bsz, t, h, p, n, dtype):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x, b, c = f(bsz, t, h, p).to(dtype), f(bsz, t, n).to(dtype), f(bsz, t, n).to(dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (bsz, t, h)).astype(np.float32))
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, (h,)).astype(np.float32))
    return x, dt, a, b, c, f(bsz, h, n, p)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t,chunk", [(64, 16), (128, 128), (256, 64)])
def test_kernel_arithmetic_matches_reference_and_pallas(t, chunk, dtype, with_h0):
    """The kernel's split-bf16 arithmetic, emulated, against the port's
    sequential plain version and the Pallas kernel (interpret mode) at the
    JAX suite's shapes, within the card tests' 1e-4."""
    jdt, tdt, _ = DTYPES[dtype]
    arrs = _inputs(t + chunk, 3, t, 8, 16)
    h0 = np.random.default_rng(t).standard_normal((3, 16, 8)).astype(np.float32) \
        if with_h0 else None
    x, dt, a, b, c = _t(arrs, tdt)
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = _emulate_rows(x, dt, a, b, c, th0, chunk)
    want = tssd.ssd_scan_plain(x, dt, a, b, c, th0)
    jy, jh = jops.ssd_chunk_scan(*_j(arrs, jdt), None if h0 is None else jnp.asarray(h0),
                                 chunk=chunk, use_pallas=True, interpret=True)
    for wy, wh in ((want[0].numpy(), want[1].numpy()), (jy, jh)):
        _close(y, wy, 1e-4)
        _close(h, wh, 1e-4)


def _emulate_rows(x, dt, a, b, c, h0, chunk):
    """The rows layout (bh, t, p) is the heads layout at H = 1 per row."""
    ys, hs = zip(*(emulate_ssd_kernel(
        x[r:r + 1, :, None], dt[r:r + 1, :, None], a[r:r + 1], b[r:r + 1], c[r:r + 1],
        None if h0 is None else h0[r:r + 1, None], chunk=chunk) for r in range(x.shape[0])))
    return torch.cat(ys)[:, :, 0], torch.cat(hs)[:, 0]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_arithmetic_at_the_card_test_shape(dtype, with_h0):
    """At ``test_torch_cuda.py``'s heads-layout shape (b, c shared by the
    heads) the emulated kernel holds the plain version and the JAX
    ``ssd_chunked`` within 1e-4."""
    x, dt, a, b, c, h0 = _heads_inputs(5, 2, 96, 3, 16, 32, dtype)
    h0 = h0 if with_h0 else None
    y, h = emulate_ssd_kernel(x, dt, a, b, c, h0, chunk=32)
    want_y, want_h = tssd.ssd_scan_plain(x, dt, a, b, c, h0)
    torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, want_h, atol=1e-4, rtol=1e-4)
    jy, jh = j_ssd_chunked(*(jnp.asarray(v.float().numpy()) for v in (x, dt, a, b, c)),
                           None if h0 is None else jnp.asarray(h0.numpy()), chunk=32)
    _close(y, jy, 1e-4)
    _close(h, jh, 1e-4)


@pytest.mark.parametrize("t,chunk,n", [(256, 128, 128), (100, 128, 16), (64, 16, 8)])
def test_chunk_gram_layout_matches_jax_products(t, chunk, n):
    """``chunk_gram`` (on the CPU its plain version) gives C B^T of every
    chunk, as the JAX package computes it, at the places the scan kernel's
    lanes read: tile (i, j <= i), lane 4 g + k, value e at row
    16 i + g + 8 ((e >> 1) & 1), column 16 j + 8 (e >> 2) + 2 k + (e & 1)."""
    rng = np.random.default_rng(t + n)
    b, c = (rng.standard_normal((2, t, n)).astype(np.float32) for _ in range(2))
    q = min(chunk, t)
    want = np.asarray(jnp.einsum("bcqn,bcpn->bcqp", jnp.asarray(c).reshape(2, t // q, q, n),
                                 jnp.asarray(b).reshape(2, t // q, q, n)))
    reset_launch_counts()
    got = tssd.chunk_gram(torch.from_numpy(b), torch.from_numpy(c), chunk=chunk).numpy()
    assert launch_counts()["ssd_chunk_gram"] == 0
    qt = -(-q // 16)
    assert got.shape == (2, t // q, qt * (qt + 1) // 2, 32, 8)
    full = np.zeros((2, t // q, 16 * qt, 16 * qt), np.float32)
    full[:, :, :q, :q] = want
    tile = 0
    for i in range(qt):
        for j in range(i + 1):
            for lane in range(32):
                g, k = divmod(lane, 4)
                for e in range(8):
                    r = 16 * i + g + 8 * ((e >> 1) & 1)
                    col = 16 * j + 8 * (e >> 2) + 2 * k + (e & 1)
                    np.testing.assert_allclose(got[:, :, tile, lane, e], full[:, :, r, col],
                                               rtol=1e-5, atol=1e-5)
            tile += 1


@pytest.mark.parametrize("case", ["ragged", "rank", "mixed", "chunk0"])
def test_chunk_gram_bad_operands_raise(case):
    _, _, _, b, c = _t(_inputs(0, 2, 32, 4, 8), torch.float32)
    args, chunk = {
        "ragged": ((b[:, :30], c[:, :30]), 16),
        "rank": ((b[0], c[0]), 16),
        "mixed": ((b, c.bfloat16()), 16),
        "chunk0": ((b, c), 0),
    }[case]
    with pytest.raises(ValueError):
        tssd.chunk_gram(*args, chunk=chunk)
