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
* ``emulate_ssd_bwd`` repeats the backward kernels' decomposition (the
  state pass with its qv and sum(H o dH') terms, G^T once per (batch,
  chunk), dG summed per group of heads, db and dc as head-ordered products
  plus the summed dG times B and C) in f64 torch and holds it to autograd
  at 1e-5 of each gradient's largest value, with head counts the group
  does and does not divide, so the kernels' formulas are tested where they
  cannot run;
* the same decomposition in the kernels' arithmetic (f32 operands of every
  tensor-core product as bf16 hi + lo halves) is held to ``jax.grad`` of
  the reference at the card's tolerance (1e-4 f32, 1e-2 bf16);
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


EMU_HEAD_GROUP = 2  # heads per group of the per-chunk kernel in the emulations


def _splits(v, split):
    """v as the kernels feed it to the tensor cores: bf16 hi + lo halves
    (``split``) or one bf16 value (an input already in bf16)."""
    hi = v.to(torch.bfloat16).float()
    return (hi, (v - hi).to(torch.bfloat16).float()) if split else (hi, None)


def _mm_split(a, b, split_a, split_b):
    """a @ b as m16n8k16 products of split operands: hi x hi, lo x hi and
    hi x lo, each bf16 x bf16 product exact in f32, f32 sums; lo x lo
    dropped."""
    ah, al = _splits(a, split_a)
    bh, bl = _splits(b, split_b)
    out = ah @ bh
    if al is not None:
        out = out + al @ bh
    if bl is not None:
        out = out + ah @ bl
    return out


def emulate_ssd_bwd(x, dt, a, b, c, h0, dy, dh, q, hg=EMU_HEAD_GROUP, split=None):
    """The backward kernels' decomposition, heads layout.  ``split=None``:
    f64 arithmetic (the algebra).  ``split="float32"`` or ``"bfloat16"``:
    f32 arithmetic with every product on split bf16 operands as the kernels
    run it (inputs x, b, c in that type: bf16 goes in as it is, f32 split),
    dx, db, dc rounded to it at the end.

    * the states entering each chunk (the forward kernel's ``hprev``);
    * ``ssd_bwd_dstate_kernel``: dH' chunk by chunk from the last;
    * ``ssd_bwd_chunk_kernel``: G^T = B C^T once per (batch, chunk); per
      group of ``hg`` heads in order, each head's dx, its parts of ds and
      ddt, and dG summed over the group;
    * ``ssd_bwd_dbc_kernel``: per head dY H^T and X dH'^T, scaled by e^s
      and w after the product and summed over heads in order, plus (sum
      dG) B and (sum dG)^T C; qv = e^s o rowsum(C o dY H^T) and sum(H o
      dH') on the way;
    * ``ssd_bwd_tail_kernel``: ds, its reverse cumsum, ddt and da."""
    bsz, t, nh, p = x.shape
    n, nc = b.shape[-1], t // q
    ft = torch.float64 if split is None else torch.float32
    in_split = split == "float32"

    def mm(u, v, su, sv):  # su, sv: whether the kernel splits that operand
        return u @ v if split is None else _mm_split(u, v, su, sv)

    x, dt, a, b, c, dy = (v.to(ft) for v in (x, dt, a, b, c, dy))
    tri = torch.tril(torch.ones(q, q, dtype=torch.bool))
    neg_inf = torch.tensor(-float("inf"), dtype=ft)
    chunks = [slice(ci * q, (ci + 1) * q) for ci in range(nc)]

    def scan(bi, hi, sl):
        d = dt[bi, sl, hi]
        s = torch.cumsum(d * a[hi], 0)
        wl = torch.exp(s[-1] - s)
        return d, s, torch.exp(s), wl, d * wl

    # the forward's chunk states, f64, as f32 in the split arithmetic
    hprev = torch.zeros(bsz, nc, nh, n, p, dtype=torch.float64)
    x64, dt64, a64, b64 = (v.double() for v in (x, dt, a, b))
    for bi in range(bsz):
        for hi in range(nh):
            st = torch.zeros(n, p, dtype=torch.float64) if h0 is None else h0[bi, hi].double()
            for ci, sl in enumerate(chunks):
                hprev[bi, ci, hi] = st
                s = torch.cumsum(dt64[bi, sl, hi] * a64[hi], 0)
                w = dt64[bi, sl, hi] * torch.exp(s[-1] - s)
                st = torch.exp(s[-1]) * st + (b64[bi, sl] * w[:, None]).T @ x64[bi, sl, hi]
    hprev = hprev.to(ft)

    # state pass
    dstate = torch.zeros_like(hprev)
    dh0 = torch.zeros(bsz, nh, n, p, dtype=ft)
    for bi in range(bsz):
        for hi in range(nh):
            dH = torch.zeros(n, p, dtype=ft) if dh is None else dh[bi, hi].to(ft)
            for ci in reversed(range(nc)):
                sl = chunks[ci]
                _, s, es, _, _ = scan(bi, hi, sl)
                dstate[bi, ci, hi] = dH
                dH = es[-1] * dH + mm((c[bi, sl] * es[:, None]).T, dy[bi, sl, hi], True, True)
            dh0[bi, hi] = dH

    # db / dc pass (qv and sum(H o dH') on the way, which ds needs)
    db, dc = torch.zeros_like(b), torch.zeros_like(c)
    qv = torch.zeros(bsz, t, nh, dtype=ft)
    hs = torch.zeros(bsz, nc, nh, dtype=ft)
    dcc = torch.zeros(bsz, nc, q, n, dtype=ft)
    dbb = torch.zeros_like(dcc)
    for bi in range(bsz):
        for ci, sl in enumerate(chunks):
            for hi in range(nh):
                _, _, es, _, w = scan(bi, hi, sl)
                hm, dhn = hprev[bi, ci, hi], dstate[bi, ci, hi]
                yh = mm(dy[bi, sl, hi], hm.T, True, True)
                qv[bi, sl, hi] = es * (c[bi, sl] * yh).sum(1)
                hs[bi, ci, hi] = (hm * dhn).sum()
                dcc[bi, ci] += es[:, None] * yh
                dbb[bi, ci] += w[:, None] * mm(x[bi, sl, hi], dhn.T, in_split, True)

    # per-chunk pass
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dap = torch.zeros(bsz, nh, nc, dtype=ft)
    groups = [range(g0, min(nh, g0 + hg)) for g0 in range(0, nh, hg)]
    dgp = torch.zeros(bsz, nc, len(groups), q, q, dtype=ft)  # dG^T (rows j, columns t)
    for bi in range(bsz):
        for ci, sl in enumerate(chunks):
            gt = mm(b[bi, sl], c[bi, sl].T, in_split, in_split)  # G^T[j, t]
            for gi, heads in enumerate(groups):
                for hi in heads:
                    d, s, es, wl, w = scan(bi, hi, sl)
                    lt = torch.exp(torch.where(tri, s[:, None] - s[None, :], neg_inf)).T
                    yxt = torch.where(tri.T, mm(x[bi, sl, hi], dy[bi, sl, hi].T, in_split, True),
                                      0.0)
                    lgt = lt * gt
                    dgt = lt * d[:, None] * yxt
                    dgp[bi, ci, gi] += dgt
                    dhn = dstate[bi, ci, hi]
                    dx1 = mm(lgt, dy[bi, sl, hi], True, True)
                    dx2 = mm(b[bi, sl], dhn, in_split, True)
                    dx[bi, sl, hi] = d[:, None] * dx1 + w[:, None] * dx2
                    t2 = (x[bi, sl, hi] * dx2).sum(1)
                    colg = (lgt * yxt).sum(1)
                    rowp = (gt * dgt).sum(0)
                    ds = rowp - d * colg + qv[bi, sl, hi] - w * t2
                    ds[-1] += es[-1] * hs[bi, ci, hi] + (w * t2).sum()
                    dla = torch.flip(torch.cumsum(torch.flip(ds, [0]), 0), [0])
                    ddt[bi, sl, hi] = colg + wl * t2 + a[hi] * dla
                    dap[bi, hi, ci] = (dla * d).sum()

    # the summed dG's products, after the heads
    for bi in range(bsz):
        for ci, sl in enumerate(chunks):
            dgs = dgp[bi, ci].sum(0)
            dc[bi, sl] = dcc[bi, ci] + mm(dgs.T, b[bi, sl], True, in_split)
            db[bi, sl] = dbb[bi, ci] + mm(dgs, c[bi, sl], True, in_split)
    da = dap.sum((0, 2))
    if split is not None:
        out_t = torch.float32 if in_split else torch.bfloat16
        dx, db, dc = (v.to(out_t) for v in (dx, db, dc))
    return dx, ddt, da, db, dc, (dh0 if h0 is not None else None)


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


@pytest.mark.parametrize("nh,hg", [(5, 2), (7, 3), (3, 4)])
def test_kernel_algebra_with_uneven_head_groups(nh, hg):
    """Head counts that the group does not divide (zamba2's 80 heads in
    groups of 20 divide; the card tests' 3 heads in groups of 2 do not):
    the last group is short, every head still counted once."""
    d = _heads(nh, 2, 24, nh, 4, 6)
    x, dt, a, b, c, h0 = (torch.from_numpy(d[k]) for k in ("x", "dt", "a", "b", "c", "h0"))
    dy, dh = torch.from_numpy(d["wy"]), torch.from_numpy(d["wh"])
    want = tssd.ssd_scan_bwd(x, dt, a, b, c, h0, dy, dh, chunk=8)
    got = emulate_ssd_bwd(x, dt, a, b, c, h0, dy, dh, 8, hg=hg)
    for name, g, w in zip(NAMES, got, want):
        assert _rel_err(g.float(), w) <= EMU_TOL, name


# max |kernel - reference| over the largest |reference| of each gradient, as
# the card tests and chip_smoke.py hold the kernel (SSD_GRAD_TOL there)
SSD_GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,q,with_h0,with_dh", [
    ((2, 64, 3, 16, 32), 32, True, True), ((1, 48, 2, 8, 16), 16, False, True)])
def test_split_operand_arithmetic_matches_jax_grad(dtype, shape, q, with_h0, with_dh):
    """The kernels' arithmetic -- every f32 operand of a tensor-core product
    as bf16 hi + lo, lo x lo dropped, f32 sums; bf16 inputs as they are and
    dx, db, dc rounded to bf16 -- emulated in torch, against ``jax.grad`` of
    the reference's ``ssd_chunked`` on the same input values."""
    bsz, t, nh, p, n = shape
    d = _heads(7 * sum(shape), bsz, t, nh, p, n, h0=with_h0)
    if dtype == "bfloat16":  # the inputs the card gets, in both packages
        for k in ("x", "b", "c"):
            d[k] = torch.from_numpy(d[k]).to(torch.bfloat16).float().numpy()
    names = ["x", "dt", "a", "b", "c"] + (["h0"] if with_h0 else [])

    def jloss(*args):
        kw = dict(zip(names, args))
        y, h = j_ssd_chunked(kw["x"], kw["dt"], kw["a"], kw["b"], kw["c"], kw.get("h0"),
                             chunk=q)
        out = jnp.sum(y * d["wy"])
        return out + jnp.sum(h * d["wh"]) if with_dh else out

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(d[k]) for k in names))
    x, dt, a, b, c = (torch.from_numpy(d[k]) for k in ("x", "dt", "a", "b", "c"))
    h0 = torch.from_numpy(d["h0"]) if with_h0 else None
    dh = torch.from_numpy(d["wh"]) if with_dh else None
    got = emulate_ssd_bwd(x, dt, a, b, c, h0, torch.from_numpy(d["wy"]), dh, q, split=dtype)
    for name, g, w in zip(names, got, want):
        err = _rel_err(g.float(), torch.from_numpy(np.array(w)))
        assert err <= SSD_GRAD_TOL[dtype], (name, err)


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
