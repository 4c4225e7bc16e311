"""The port's SSD scan against the JAX package's, on the same inputs.

On the CPU the port's ``ssd_scan`` wrapper runs its plain sequential version
(``repro_torch.kernels.ref.ssd_scan_ref``).  These tests hold it, through
``ops.ssd_chunk_scan``, against the JAX sequential reference and the Pallas
kernel run in interpret mode, at the JAX suite's shapes and tolerances
(``tests/test_kernels.py``: 2e-5 in f32, 3e-2 in bf16, 1e-4 for state
continuation, 2e-4 for ``ssd_chunked``).  Inputs are made with numpy from a
seed.  The CUDA kernel itself is checked by ``test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
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
