"""The Mamba-2 block's fused prefill glue (``kernels/mamba_glue.py`` over
``csrc/mamba_glue.cu``) and its route in ``models/mamba2.py mamba_apply``.

The tests marked ``cuda`` need an NVIDIA GPU and skip without one: they hold
each kernel to its plain version, and the fused block to the plain chain at
the widths of mamba2-1.3b, zamba2-2.7b and granite-4.0-h-small, with a ragged
T, a T shorter than the conv's W - 1 and T = 1, and check where the route
engages.  The others run on the CPU: the refusals name what the kernels do
not take, and the fused route's wiring runs with the kernels' plain
versions in their place (``tests/test_torch_kernel_route.py`` holds the CPU
route).  The file imports neither JAX nor ``repro``.  Run the card's tests
with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mamba_fused.py
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, mamba_glue, reset_launch_counts
from repro_torch.models import mamba2 as M
from repro_torch.models.config import smoke
from repro_torch.models.layers import merge_heads, rmsnorm, split_heads

# The fused block against the plain chain, as relative Frobenius errors.
# Both take the same bf16 projections; the plain chain then rounds the conv
# before and after its SiLU, y, D x, the skip's sum, silu(z) and the gate to
# bf16 (each within 2^-9 relative), the kernels only once each, so the two
# differ by a few such roundings: 2^-6 leaves room for their sum.
BLOCK_RTOL = 2.0 ** -6
# A kernel against its plain version, which does the same f32 arithmetic:
# they differ only in how exp, the division, the reduction and (in the norm)
# y + D x, which the kernel may fuse into one FMA, round in f32 before the
# one rounding to bf16: by at most one bf16 ulp, 2^-7 of the value, plus
# where y + D x cancels, an f32 residue far below ATOL of the largest value.
ULP, ATOL = 2.0 ** -7, 2.0 ** -16

WIDTHS = {"mamba2": "mamba2-1.3b", "zamba2": "zamba2-2.7b", "granite": "granite-4.0-h-small"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain_apply(p, x, cfg, *, state=None):
    """``mamba_apply``'s plain chain as it stood before the fused route,
    written out: what every block outside the route must still give."""
    b_sz, t, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    pdim = cfg.ssm_head_dim
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    bb = x @ p["w_b"]
    cc = x @ p["w_c"]
    dt = F.softplus(x.float() @ p["w_dt"] + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    conv_in = torch.cat([xs, bb.to(xs.dtype), cc.to(xs.dtype)], -1)
    if state is None:
        conv_out = M.causal_conv(conv_in, p["conv_w"], p["conv_b"])
    else:
        conv_state, ssd_state = state
        window = torch.cat([conv_state, conv_in], dim=1)
        conv_out = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float())
        conv_out = (conv_out[:, None, :] + p["conv_b"].float()).to(conv_in.dtype)
        new_conv_state = window[:, 1:, :]
    conv_out = F.silu(conv_out)
    xs2 = split_heads(conv_out[..., :di], h, pdim)
    bb2 = conv_out[..., di : di + n]
    cc2 = conv_out[..., di + n :]
    if state is None:
        y, final_state = M.ssd_chunked(xs2, dt, a, bb2, cc2, chunk=cfg.ssm_chunk)
    else:
        decay = torch.exp(dt[:, 0, :] * a)
        upd = torch.einsum("bn,bh,bhv->bhnv", bb2[:, 0].float(), dt[:, 0, :], xs2[:, 0].float())
        final_state = decay[:, :, None, None] * ssd_state + upd
        y = torch.einsum("bn,bhnv->bhv", cc2[:, 0].float(), final_state)
        y = y[:, None].to(x.dtype).reshape(b_sz, 1, h, pdim)
    y = y + xs2 * p["d_skip"].to(y.dtype).reshape(1, 1, h, 1)
    y = merge_heads(y)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if state is None:
        w1 = cfg.ssm_conv - 1
        tail = conv_in[:, -w1:, :] if t >= w1 else F.pad(conv_in, (0, 0, w1 - t, 0))
        return out, (tail, final_state)
    return out, (new_conv_state, final_state)


def _block(cfg, device, batch: int, t: int, seed: int = 3):
    """A block's weights and input, drawn on ``device`` from ``seed``; the
    norm's scale drawn around 1, where init sets it to ones, so that a
    comparison sees it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = M.init_mamba_block(gen, cfg, device=device)
    x = torch.randn((batch, t, cfg.d_model), generator=gen, device=device).to(p["w_x"].dtype)
    p["norm"] = _scale(p["norm"].shape, gen, device).to(p["norm"].dtype)
    return p, x


def _scale(shape, gen, device) -> torch.Tensor:
    """A norm's scale in f32: 1 + N(0, 0.5^2)."""
    return 1.0 + 0.5 * torch.randn(shape, generator=gen, device=device)


def _full(arch: str, dtype: str = "bfloat16"):
    """A block at the architecture's published widths (chunk 128, the SSD
    kernel's)."""
    return dataclasses.replace(get_config(arch), dtype=dtype, ssm_chunk=128)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _within_ulp(got, want):
    err, mag = (got.float() - want.float()).abs(), want.float().abs()
    lim = ULP * mag + ATOL * mag.max()
    assert bool((err <= lim).all()), f"worst error {float((err - lim).max())} over the limit"


def _equal(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _own_storage(t: torch.Tensor) -> bool:
    return t._base is None and t.untyped_storage().nbytes() == t.numel() * t.element_size()


# ------------------------------------------------------------------ card

@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(WIDTHS))
@pytest.mark.parametrize("t", [200, 2, 1])
def test_each_kernel_matches_its_plain_version(cuda, arch, t):
    """At each cell's block widths: the conv within one bf16 ulp of its plain
    version and its tail bit-equal; the norm, with a unit scale, within one
    ulp of its plain version on the conv's own x, a ragged y (T' > T) and z,
    and with a drawn scale equal bit for bit to that result times the scale
    (rounded once, as the plain version scales its rounded value)."""
    cfg = _full(WIDTHS[arch])
    di, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_head_dim
    gen = torch.Generator(device=cuda).manual_seed(t + di)
    p = M.init_mamba_block(gen, cfg, device=cuda)
    p["conv_b"] = 0.1 * torch.randn(p["conv_b"].shape, generator=gen, device=cuda).bfloat16()
    p["d_skip"] = torch.rand(p["d_skip"].shape, generator=gen, device=cuda) + 0.5
    p["norm"] = _scale(p["norm"].shape, gen, cuda).bfloat16()

    def normal(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    xs, bb, cc, z = normal(2, t, di), normal(2, t, n), normal(2, t, n), normal(2, t, di)
    reset_launch_counts()
    out, tail = mamba_glue.mamba_conv(xs, bb, cc, p["conv_w"], p["conv_b"])
    want, want_tail = mamba_glue.mamba_conv_plain(xs, bb, cc, p["conv_w"], p["conv_b"])
    assert torch.equal(tail, want_tail) and _own_storage(tail)
    _within_ulp(out, want)
    x = split_heads(out[..., :di], h, pdim)
    y = normal(2, t + 7, h, pdim, dtype=torch.float32)
    ones = torch.ones_like(p["norm"])
    unit = mamba_glue.mamba_gate_norm(y, x, z, p["d_skip"], ones, cfg.norm_eps)
    want = mamba_glue.mamba_gate_norm_plain(y, x, z, p["d_skip"], ones, cfg.norm_eps)
    got = mamba_glue.mamba_gate_norm(y, x, z, p["d_skip"], p["norm"], cfg.norm_eps)
    torch.cuda.synchronize()
    assert launch_counts()["mamba_conv"] == 1 and launch_counts()["mamba_gate_norm"] == 2
    _within_ulp(unit, want)
    assert torch.equal(got, unit * p["norm"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch,t", [("mamba2", 200), ("zamba2", 200), ("granite", 200),
                                    ("mamba2", 2), ("mamba2", 1)])
def test_the_fused_block_matches_the_plain_chain(cuda, arch, t):
    """A bf16 prefill under no_grad at each cell's block widths, with T
    ragged against the chunk of 128, shorter than W - 1 and 1: one launch
    of each kernel; out and the SSD state within ``BLOCK_RTOL`` of the plain
    chain and no farther from the block in f32; the conv tail bit-equal to
    the plain chain's and a tensor of its own."""
    cfg = _full(WIDTHS[arch])
    p, x = _block(cfg, cuda, 2, t)
    reset_launch_counts()
    with torch.no_grad():
        out, (tail, state) = M.mamba_apply(p, x, cfg)
        torch.cuda.synchronize()
        assert launch_counts()["mamba_conv"] == 1 and launch_counts()["mamba_gate_norm"] == 1
        want, (want_tail, want_state) = _plain_apply(p, x, cfg)
        f32 = {k: v.float() for k, v in p.items()}
        ref, (_, ref_state) = _plain_apply(f32, x.float(), dataclasses.replace(cfg, dtype="float32"))
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert torch.equal(tail, want_tail) and _own_storage(tail)
    assert _rel(out, want) <= BLOCK_RTOL and _rel(state, want_state) <= BLOCK_RTOL
    assert _rel(out, ref) <= _rel(want, ref)
    assert _rel(state, ref_state) <= _rel(want_state, ref_state)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["recorded", "weight_grad", "scan_grad", "float32", "decode",
                                  "unsupported_n", "smoke", "packed"])
def test_the_route_on_the_card(cuda, mode):
    """A recorded graph (every weight, only the norm's scale, or only A's
    log, which the scan between the kernels reads, requiring grad), a
    float32 block and a decode step run the plain chain on the
    card, bit for bit, and launch neither kernel (the recorded ones
    back-propagate); the bf16 smoke block (d_inner 128, N 16, P 16) takes the
    kernels, also with every weight a view one element into its buffer (a
    packed leaf); a bf16 prefill at an N the kernels do not take raises with
    the refusal's reason, launching nothing, rather than run the plain chain
    unnoticed."""
    arch = get_config("mamba2-1.3b")
    cfg = smoke(arch, dtype="float32" if mode == "float32" else "bfloat16",
                **({"ssm_state": 12} if mode == "unsupported_n" else {}))
    p, x = _block(cfg, cuda, 2, 1 if mode == "decode" else 20)
    state = None
    if mode == "decode":
        ch = cfg.d_inner + 2 * cfg.ssm_state
        state = (torch.randn((2, cfg.ssm_conv - 1, ch), device=cuda).bfloat16(),
                 torch.randn((2, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_head_dim), device=cuda))
    recorded = mode in ("recorded", "weight_grad", "scan_grad")
    one = {"weight_grad": "norm", "scan_grad": "a_log"}.get(mode)
    for name, w in p.items():
        w.requires_grad_(mode == "recorded" or name == one)
    if mode == "packed":
        p = {k: torch.empty(v.numel() + 1, dtype=v.dtype, device=cuda)[1:].view_as(v).copy_(v)
             for k, v in p.items()}
    reset_launch_counts()
    if mode == "unsupported_n":
        with torch.no_grad(), pytest.raises(ValueError, match="multiples of 8"):
            M.mamba_apply(p, x, cfg)
        assert set(launch_counts().values()) == {0}
        return
    with torch.set_grad_enabled(recorded):
        out, new = M.mamba_apply(p, x, cfg, state=state)
        want, want_new = _plain_apply(p, x, cfg, state=state)
    torch.cuda.synchronize()
    fused = mode in ("smoke", "packed")
    assert launch_counts()["mamba_conv"] == launch_counts()["mamba_gate_norm"] == int(fused)
    if fused:
        assert _rel(out, want) <= BLOCK_RTOL and torch.equal(new[0], want_new[0])
    else:
        assert torch.equal(out, want) and _equal(new, want_new)
    if recorded:
        out.float().sum().backward()
        assert all(w.grad is not None and bool(torch.isfinite(w.grad).all())
                   for w in p.values() if w.requires_grad)


# ------------------------------------------------------------------- CPU

def _operands(di=128, n=16, pdim=16, width=4, dtype=torch.bfloat16, t=8):
    """A block's operands on the CPU: (xs, bb, cc, z, conv_w, conv_b,
    d_skip, norm, head dim)."""
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt)  # noqa: E731
    ch = di + 2 * n
    return (zeros(2, t, di), zeros(2, t, n), zeros(2, t, n), zeros(2, t, di),
            zeros(width, ch), zeros(ch), zeros(max(di // pdim, 1), dt=torch.float32),
            zeros(di), pdim)


@pytest.mark.parametrize("what,kw,match", [
    ("cpu", {}, "CUDA tensors"),
    ("width", {"width": 5}, "width"),
    ("n", {"n": 12}, "multiples of 8"),
    ("d_inner", {"di": 132, "pdim": 12}, "multiples of 8"),
    ("head_dim", {"di": 96, "pdim": 12}, "head dim in multiples of 8"),
    ("too_wide", {"di": 8192 + 128, "pdim": 64}, "d_inner <= 8192"),
    ("float32", {"dtype": torch.float32}, "bfloat16"),
    ("empty", {"t": 0}, "T"),
])
def test_the_refusals_name_what_the_kernels_do_not_take(what, kw, match):
    """The shapes are refused before the device is looked at, and a call of
    either wrapper -- so too a bf16 prefill on the card -- raises with the
    reason.  On the CPU ``mamba_glue.takes`` does not hold at all."""
    xs, bb, cc, z, w, b, d, norm, pdim = _operands(**kw)
    x4 = xs.unflatten(2, (d.shape[0], pdim)) if xs.shape[2] % pdim == 0 else xs[..., None]
    reasons = [mamba_glue.conv_refusal(xs, bb, cc, w, b), mamba_glue.norm_refusal(x4, z, d, norm)]
    assert any(r is not None and match in r for r in reasons), reasons
    dt = torch.ones(xs.shape[:2] + d.shape)
    assert not mamba_glue.takes(xs, bb, cc, z, dt, -d, w, b, d, norm)
    with pytest.raises(ValueError, match="mamba_glue"):
        if reasons[0] is not None:
            mamba_glue.mamba_conv(xs, bb, cc, w, b)
        else:
            mamba_glue.mamba_gate_norm(x4.float(), x4, z, d, norm, 1e-6)


@pytest.mark.parametrize("t", [13, 2, 1])
def test_the_fused_wiring_with_the_plain_kernels(monkeypatch, t):
    """The fused route on the CPU with the kernels' plain versions in their
    place (at a ragged T, T < W - 1 and T = 1): the scan reads the conv's
    output through views, the norm the scan's padded f32 output; out and the
    state within ``BLOCK_RTOL`` of the plain chain; the tail bit-equal and a
    tensor of its own."""
    cfg = smoke(get_config("mamba2-1.3b"), dtype="bfloat16")
    p, x = _block(cfg, "cpu", 2, t)
    monkeypatch.setattr(mamba_glue, "takes", lambda *a: True)
    monkeypatch.setattr(mamba_glue, "mamba_conv", mamba_glue.mamba_conv_plain)
    monkeypatch.setattr(mamba_glue, "mamba_gate_norm", mamba_glue.mamba_gate_norm_plain)
    with torch.no_grad():
        out, (tail, state) = M.mamba_apply(p, x, cfg)
        want, (want_tail, want_state) = _plain_apply(p, x, cfg)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert torch.equal(tail, want_tail) and _own_storage(tail)
    assert _rel(out, want) <= BLOCK_RTOL and _rel(state, want_state) <= BLOCK_RTOL


@pytest.mark.parametrize("how", ["aligned", "offset", "strided"])
def test_aligned_copies_only_a_parameter_the_kernels_cannot_read(how):
    """A contiguous 16-byte aligned parameter is passed as it is; one that
    starts off that alignment, or is strided, is copied to one that does
    not, with the same values."""
    buf = torch.arange(40, dtype=torch.float32)
    w = {"aligned": buf[:16], "offset": buf[1:17], "strided": buf[::2]}[how]
    got = mamba_glue.aligned(w)
    assert (got is w) == (how == "aligned")
    assert got.is_contiguous() and got.data_ptr() % 16 == 0 and torch.equal(got, w)


def test_the_plain_norm_keeps_rmsnorms_cast_order():
    """On bf16 inputs that are exact in each rounding of the plain chain
    (y, D and every product), the norm's plain version equals the chain:
    only the intermediate roundings differ, not the end's cast order."""
    gen = torch.Generator().manual_seed(0)
    nb, t, h, pdim = 2, 5, 4, 16
    x = torch.randint(-4, 5, (nb, t, h, pdim), generator=gen).bfloat16()
    y = torch.randint(-4, 5, (nb, t + 3, h, pdim), generator=gen).float()
    z = torch.zeros((nb, t, h * pdim), dtype=torch.bfloat16) + 30.0  # silu(30) rounds to 30
    d = torch.tensor([1.0, 2.0, 0.5, 0.0])
    norm = torch.randint(1, 4, (h * pdim,), generator=gen).bfloat16()
    got = mamba_glue.mamba_gate_norm_plain(y, x, z, d, norm, 1e-6)
    chain = y[:, :t].bfloat16() + x * d.bfloat16().reshape(1, 1, h, 1)
    want = rmsnorm(merge_heads(chain) * F.silu(z), norm, 1e-6)
    assert torch.equal(got, want)
