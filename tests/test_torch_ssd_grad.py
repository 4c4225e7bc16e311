"""The gradient of the port's SSD scan against the JAX package's.

The reference trains Mamba-2 by differentiating ``models/mamba2.py:
ssd_chunked`` with ``jax.grad``.  The port's ``ssd_chunked`` runs the scan as
``kernels.ssd_scan.SSDScanFn``: on the card its backward is the CUDA kernel
``csrc/ssd_scan_bwd.cu``; on the CPU, autograd through the plain sequential
scan.  Here, on the CPU:

* the port's gradients of a scalar of (y, h_final) with respect to x, dt,
  a, b, c and h0 equal ``jax.grad`` of the reference's, f32, at 2e-4 of
  each gradient's largest value (``ssd_chunked``'s forward tolerance in
  ``tests/test_kernels.py``: chunked against sequential sums), with a
  ragged T (dt = 0 padding and the slice back), t < chunk and h0;
* ``emulate_ssd_bwd`` repeats the backward kernel's algebra (the state
  gradient pass, the per-chunk gradients, the fixed-order sums over heads)
  in f64 torch and holds it to autograd at 1e-5 of each gradient's largest
  value, so the kernel's formulas are tested where it cannot run;
* the Function's plumbing: None gradients count as zeros, no h0 gives no
  dh0, a scan without grad launches nothing new.

``tests/test_torch_cuda.py`` holds the kernel itself to its plain version
on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models.mamba2 import ssd_chunked as t_ssd_chunked

JAX_TOL = 2e-4
EMU_TOL = 1e-5
NAMES = ("dx", "ddt", "da", "db", "dc", "dh0")


def _heads(seed, bsz, t, h, p, n, h0=True):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((bsz, t, h, p)).astype(np.float32),
        dt=rng.uniform(0.01, 0.3, (bsz, t, h)).astype(np.float32),
        a=-rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
        b=rng.standard_normal((bsz, t, n)).astype(np.float32),
        c=rng.standard_normal((bsz, t, n)).astype(np.float32),
        h0=rng.standard_normal((bsz, h, n, p)).astype(np.float32) if h0 else None,
        wy=rng.standard_normal((bsz, t, h, p)).astype(np.float32),
        wh=rng.standard_normal((bsz, h, n, p)).astype(np.float32),
    )


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("t,chunk,with_h0", [
    (32, 8, True), (27, 8, True), (5, 8, False), (40, 16, False), (19, 4, True)])
def test_grad_matches_jax_grad_of_reference(t, chunk, with_h0):
    d = _heads(t, 2, t, 3, 4, 5, h0=with_h0)
    names = ["x", "dt", "a", "b", "c"] + (["h0"] if with_h0 else [])

    def jloss(*args):
        kw = dict(zip(names, args))
        y, h = j_ssd_chunked(kw["x"], kw["dt"], kw["a"], kw["b"], kw["c"], kw.get("h0"),
                             chunk=chunk)
        return jnp.sum(y * d["wy"]) + jnp.sum(h * d["wh"])

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(d[k]) for k in names))
    ins = {k: torch.from_numpy(d[k]).requires_grad_() for k in names}
    y, h = t_ssd_chunked(ins["x"], ins["dt"], ins["a"], ins["b"], ins["c"], ins.get("h0"),
                         chunk=chunk)
    assert y.shape == (2, t, 3, 4)
    (torch.sum(y * torch.from_numpy(d["wy"])) + torch.sum(h * torch.from_numpy(d["wh"]))
     ).backward()
    for k, w in zip(names, want):
        err = _rel_err(ins[k].grad, torch.from_numpy(np.array(w)))
        assert err <= JAX_TOL, (k, err)


def emulate_ssd_bwd(x, dt, a, b, c, h0, dy, dh, q):
    """The backward kernel's algebra in f64 torch, heads layout: the states
    entering each chunk (the forward kernel's ``hprev``), the state
    gradients chunk by chunk from the last (``ssd_bwd_dstate_kernel``), the
    per-(row, chunk) gradients (``ssd_bwd_chunk_kernel``) and the sums over
    heads and batch rows (``ssd_bwd_reduce_kernel``)."""
    bsz, t, nh, p = x.shape
    n, nc = b.shape[-1], t // q
    x, dt, a, b, c, dy = (v.double() for v in (x, dt, a, b, c, dy))
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float64)
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    chunks = [slice(ci * q, (ci + 1) * q) for ci in range(nc)]

    def cums(sl):
        return torch.cumsum(dt[:, sl] * a, 1)  # (B, q, H)

    hprev, st = [], torch.zeros(bsz, nh, n, p, dtype=torch.float64) \
        if h0 is None else h0.double()
    for sl in chunks:
        hprev.append(st)
        s = cums(sl)
        w = dt[:, sl] * torch.exp(s[:, -1:] - s)
        st = torch.exp(s[:, -1])[..., None, None] * st + \
            torch.einsum("bjn,bjh,bjhp->bhnp", b[:, sl], w, x[:, sl])
    dstate, dH = [None] * nc, torch.zeros(bsz, nh, n, p, dtype=torch.float64) \
        if dh is None else dh.double()
    for ci in reversed(range(nc)):
        dstate[ci] = dH
        s = cums(chunks[ci])
        dH = torch.exp(s[:, -1])[..., None, None] * dH + \
            torch.einsum("btn,bth,bthp->bhnp", c[:, chunks[ci]], torch.exp(s), dy[:, chunks[ci]])
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dbp = torch.zeros(bsz, nh, t, n, dtype=torch.float64)
    dcp, dap = torch.zeros_like(dbp), torch.zeros(bsz, nh, nc, dtype=torch.float64)
    for bi in range(bsz):
        for hi in range(nh):
            for ci, sl in enumerate(chunks):
                d = dt[bi, sl, hi]
                s = torch.cumsum(d * a[hi], 0)
                wl = torch.exp(s[-1] - s)
                w = d * wl
                lmat = torch.exp(torch.where(tri, s[:, None] - s[None, :], neg_inf))
                lg = lmat * (c[bi, sl] @ b[bi, sl].T)
                yx = torch.where(tri, dy[bi, sl, hi] @ x[bi, sl, hi].T, 0.0)
                hm, dhn = hprev[ci][bi, hi], dstate[ci][bi, hi]
                dx[bi, sl, hi] = d[:, None] * (lg.T @ dy[bi, sl, hi]) + \
                    w[:, None] * (b[bi, sl] @ dhn)
                dyh = torch.exp(s)[:, None] * (dy[bi, sl, hi] @ hm.T)
                dg = lmat * d[None, :] * yx
                dcp[bi, hi, sl] = dyh + dg @ b[bi, sl]
                xdh = x[bi, sl, hi] @ dhn.T
                t2 = (xdh * b[bi, sl]).sum(1)
                dbp[bi, hi, sl] = w[:, None] * xdh + dg.T @ c[bi, sl]
                ds = (lg * d[None, :] * yx).sum(1) - d * (lg * yx).sum(0) + \
                    (dyh * c[bi, sl]).sum(1) - w * t2
                ds[-1] += torch.exp(s[-1]) * (hm * dhn).sum() + (w * t2).sum()
                dla = torch.flip(torch.cumsum(torch.flip(ds, [0]), 0), [0])
                ddt[bi, sl, hi] = (lg * yx).sum(0) + wl * t2 + a[hi] * dla
                dap[bi, hi, ci] = (dla * d).sum()
    return dx, ddt, dap.sum((0, 2)), dbp.sum(1), dcp.sum(1), dH


@pytest.mark.parametrize("shape,q,with_h0,with_dh", [
    ((2, 24, 3, 4, 5), 8, True, True), ((1, 16, 2, 3, 4), 16, False, False),
    ((2, 32, 2, 4, 4), 8, True, False), ((1, 12, 1, 8, 6), 4, False, True)])
def test_kernel_algebra_matches_autograd(shape, q, with_h0, with_dh):
    bsz, t, nh, p, n = shape
    d = _heads(sum(shape), bsz, t, nh, p, n, h0=with_h0)
    x, dt, a, b, c = (torch.from_numpy(d[k]) for k in ("x", "dt", "a", "b", "c"))
    h0 = torch.from_numpy(d["h0"]) if with_h0 else None
    dy = torch.from_numpy(d["wy"])
    dh = torch.from_numpy(d["wh"]) if with_dh else None
    want = tssd.ssd_scan_bwd(x, dt, a, b, c, h0, dy, dh, chunk=q)  # CPU: autograd
    got = emulate_ssd_bwd(x, dt, a, b, c, h0, dy, dh, q)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert name == "dh0" and not with_h0
            continue
        assert _rel_err(g.float(), w) <= EMU_TOL, name


def test_function_plumbing_on_cpu():
    d = _heads(5, 2, 16, 2, 4, 3)
    x, dt, a, b, c = (torch.from_numpy(d[k]).requires_grad_() for k in ("x", "dt", "a", "b", "c"))
    # y alone: the final state's gradient is None and counts as zeros
    y, _ = tops.ssd_chunk_scan(x, dt, a, b, c, chunk=8)
    y.sum().backward()
    want = tssd.ssd_scan_bwd(x.detach(), dt.detach(), a.detach(), b.detach(), c.detach(), None,
                             torch.ones_like(y), None, chunk=8)
    for v, w in zip((x, dt, a, b, c), want):
        torch.testing.assert_close(v.grad, w, rtol=0, atol=0)
    assert want[5] is None
    # h alone: y's gradient is None
    for v in (x, dt, a, b, c):
        v.grad = None
    _, h = tops.ssd_chunk_scan(x, dt, a, b, c, chunk=8)
    h.sum().backward()
    assert all(torch.isfinite(v.grad).all() for v in (x, dt, a, b, c))
    # no grad recorded: the plain forward, no Function
    with torch.no_grad():
        y2, _ = tops.ssd_chunk_scan(x, dt, a, b, c, chunk=8)
    assert y2.grad_fn is None
