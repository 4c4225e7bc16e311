"""The CUDA kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one.  The file imports neither JAX nor ``repro`` (the card's
machine has no JAX); the JAX comparison goes through the CPU path, which
the other ``test_torch_*`` files hold against the reference.  Run it on the
card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import raid
from repro_torch.kernels import gf256_matmul as gfm
from repro_torch.kernels import CODEC_KERNELS, launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels import parity_xor as px
from repro_torch.kernels import ssd_scan as ssd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))


@pytest.mark.parametrize("n", [1, 4, 1023, 2048])
def test_kernels_match_plain_versions(cuda, n):
    x = _words(n, 4, 3, n).to(cuda)
    reset_launch_counts()
    assert torch.equal(px.parity_xor_batch(x), ref.parity_xor_batch_ref(x))
    assert torch.equal(px.parity_xor(x[0]), ref.parity_xor_ref(x[0]))
    for coeff in (ops.rs_parity_coeff(3, 2, cuda), ops.rs_decode_coeff(3, 2, (1, 3, 4), cuda)):
        assert torch.equal(gfm.gf256_matmul_batch(coeff, x),
                           ref.gf256_matmul_batch_ref(coeff, x))
        assert torch.equal(gfm.gf256_matmul(coeff, x[0]), ref.gf256_matmul_ref(coeff, x[0]))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert {k: counts[k] for k in CODEC_KERNELS} == {
        "parity_xor_batch": 1, "parity_xor": 1, "gf256_matmul_batch": 2, "gf256_matmul": 2}


def test_unaligned_views_take_the_scalar_path(cuda):
    """A view whose rows start off a 16-byte boundary still matches."""
    base = _words(3, 2 * 3 * 64 + 1).to(cuda)
    x = base[1:].view(2, 3, 64)
    assert x.data_ptr() % 16 != 0
    assert torch.equal(px.parity_xor_batch(x), ref.parity_xor_batch_ref(x))
    c = ops.rs_parity_coeff(3, 2, cuda)
    assert torch.equal(gfm.gf256_matmul_batch(c, x), ref.gf256_matmul_batch_ref(c, x))


def test_bad_operands_raise(cuda):
    x = _words(4, 2, 3, 8).to(cuda)
    with pytest.raises(ValueError):
        px.parity_xor_batch(x.transpose(1, 2))  # not contiguous
    with pytest.raises(ValueError):
        gfm.gf256_matmul_batch(ops.rs_parity_coeff(3, 2, "cpu"), x)  # coeff on the CPU


@pytest.mark.parametrize("scheme,n", [("raid4", 4), ("raid5", 5), ("raid6", 4), ("raid6", 6),
                                      ("raid01", 4)])
def test_codec_on_card_equals_cpu(cuda, scheme, n):
    sch = raid.make_scheme(scheme, n)
    dev, cpu = raid.StripeCodec(sch, device="cuda"), raid.StripeCodec(sch, device="cpu")
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (5, sch.k, 4 * 37), dtype=np.uint8)
    par = cpu.encode_batch_np(data)
    assert np.array_equal(dev.encode_batch_np(data), par)
    assert np.array_equal(dev.encode_np(data[0]), cpu.encode_np(data[0]))
    code = np.concatenate([data, par], axis=1)
    for roles in itertools.combinations(range(sch.n), sch.k):
        if sch.mirror and len({r % sch.k for r in roles}) < sch.k:
            continue
        surv = np.ascontiguousarray(code[:, list(roles)])
        assert np.array_equal(dev.decode_batch_np(surv, roles), data), roles
        assert np.array_equal(dev.decode_np(surv[0], roles), data[0]), roles


def _pinned(t, skew=0):
    """t's values in pinned host memory, ``skew`` int32 into the buffer."""
    buf = torch.empty(t.numel() + skew, dtype=torch.int32, pin_memory=True)
    view = buf[skew:].view(t.shape)
    view.copy_(t.cpu())
    return view


def _stripe_coeffs():
    """(m, k) GF coefficient matrices of the single-stripe instances:
    RAID-6 encode (2, k) and decode (k, k) for k = 2..9 (9: the runtime
    instance), every (2+2) survivor set, and m = 3 outputs of k = 2."""
    from repro_torch.core import gf

    mats = [gf.rs_decode_matrix(2, 2, s) for s in itertools.combinations(range(4), 2)]
    for k in range(2, 10):
        mats += [gf.rs_parity_matrix(k, 2), gf.rs_decode_matrix(k, 2, tuple(range(2, k + 2)))]
    mats.append(gf.rs_parity_matrix(2, 3))
    return [torch.from_numpy(m.astype(np.int32)) for m in mats]


@pytest.mark.parametrize("n", [1, 4, 1023, 4096])
def test_stripe_kernels_match_plain_versions_in_both_forms(cuda, n):
    """The single-stripe kernels on CUDA tensors and on pinned host memory
    the card maps (the datapath's form), bit-exact, at k = 1..9."""
    side = torch.cuda.Stream()
    reset_launch_counts()
    launches = 0
    for k in range(1, 10):
        x = _words(10 * n + k, k, n)
        assert torch.equal(px.parity_xor(x.to(cuda)).cpu(), ref.parity_xor_ref(x))
        out = torch.empty(n, dtype=torch.int32, pin_memory=True)
        px.parity_xor_host(_pinned(x), out, side.cuda_stream)
        assert torch.equal(out, ref.parity_xor_ref(x))
        launches += 2
    assert launch_counts()["parity_xor"] == launches
    reset_launch_counts()
    for i, c in enumerate(_stripe_coeffs()):
        x = _words(n + i, c.shape[1], n)
        want = ref.gf256_matmul_ref(c, x)
        assert torch.equal(gfm.gf256_matmul(c, x.to(cuda)).cpu(), want)
        out = torch.empty(tuple(want.shape), dtype=torch.int32, pin_memory=True)
        gfm.gf256_matmul_host(c, _pinned(x), out, side.cuda_stream)
        assert torch.equal(out, want)
    assert launch_counts()["gf256_matmul"] == 2 * len(_stripe_coeffs())


def test_stripe_host_operands_off_a_16_byte_boundary(cuda):
    """Pinned views that start off a 16-byte boundary take the scalar path."""
    x = _words(21, 3, 64)
    hx = _pinned(x, skew=1)
    assert hx.data_ptr() % 16 != 0
    out = torch.empty(65, dtype=torch.int32, pin_memory=True)[1:]
    px.parity_xor_host(hx, out)
    assert torch.equal(out, ref.parity_xor_ref(x))
    c = ops.rs_parity_coeff(3, 2, "cpu")
    out2 = torch.empty(2 * 64 + 1, dtype=torch.int32, pin_memory=True)[1:].view(2, 64)
    gfm.gf256_matmul_host(c, hx, out2)
    assert torch.equal(out2, ref.gf256_matmul_ref(c, x))


def test_stripe_entries_refuse_what_they_cannot_take(cuda):
    x = _words(22, 3, 64)
    out = torch.empty(64, dtype=torch.int32, pin_memory=True)
    with pytest.raises(ValueError, match="pinned"):
        px.parity_xor_host(x, out)  # pageable host memory
    with pytest.raises(ValueError, match="pinned"):
        px.parity_xor_host(x.to(cuda), out)  # device memory
    with pytest.raises(ValueError, match="contiguous"):
        px.parity_xor_host(_pinned(_words(23, 64, 3)).t(), out)
    c = ops.rs_parity_coeff(3, 2, "cpu")
    with pytest.raises(ValueError, match="pinned"):
        gfm.gf256_matmul_host(c, _pinned(x), torch.empty(2, 64, dtype=torch.int32))
    big = torch.ones(33, 32, dtype=torch.int32)  # m * k = 1,056 > MAX_STRIPE_COEFFS
    assert big.numel() > gfm.MAX_STRIPE_COEFFS
    with pytest.raises(ValueError, match="by value"):
        gfm.gf256_matmul_host(big, _pinned(_words(24, 32, 64)),
                              torch.empty(33, 64, dtype=torch.int32, pin_memory=True))
    with pytest.raises(ValueError, match="by value"):
        gfm.gf256_matmul(big, _words(24, 32, 64).to(cuda))


@pytest.mark.parametrize("scheme", ["raid5", "raid6"])
def test_codec_per_stripe_path_is_one_launch_and_no_copy(cuda, scheme, monkeypatch):
    """encode_np / decode_np on the card: one kernel launch and one ctypes
    call per stripe, no torch host<->device copy, no device-wide sync."""
    codec = raid.StripeCodec(raid.make_scheme(scheme, 4), device="cuda")
    k = codec.scheme.k
    data = np.random.default_rng(3).integers(0, 256, (k, 16384), dtype=np.uint8)
    par = codec.encode_np(data)  # warm: staging, stream, ctypes entries
    roles = tuple(range(4 - k, 4))  # lose data role 0 (RAID-5) or both (RAID-6)
    surv = np.ascontiguousarray(np.concatenate([data, par])[list(roles)])
    codec.decode_np(surv, roles)
    mod = px if scheme == "raid5" else gfm
    calls = []
    fn = mod._stripe_fn
    monkeypatch.setattr(mod, "_stripe_fn", lambda *a: calls.append(a) or fn(*a))

    def refuse(*_a, **_k):
        raise AssertionError("the per-stripe path must not copy through torch or sync")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(raid.StripeCodec, "_to_device", refuse)
    monkeypatch.setattr(raid.StripeCodec, "materialize", refuse)
    reset_launch_counts()
    assert np.array_equal(codec.encode_np(data), par)
    assert np.array_equal(codec.decode_np(surv, roles), data)
    name = "parity_xor" if scheme == "raid5" else "gf256_matmul"
    assert launch_counts()[name] == 2 and len(calls) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["rows", "heads"])
def test_ssd_scan_matches_plain_version(cuda, dtype, layout):
    """The SSD kernel against the sequential plain version on the card, with
    and without h0, over three chunks of small shapes.  Both compute in
    f32 from the same input values and differ only in summation order
    (chunked vs step by step), hence 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(5)
    bsz, t, h, p, n, chunk = 2, 96, 3, 16, 32, 32

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    def uniform(lo, hi, *shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(cuda)

    if layout == "heads":  # b, c shared by the heads of a batch row
        x = normal(bsz, t, h, p).to(dtype)
        b, c = (normal(bsz, t, n).to(dtype) for _ in range(2))
        dt, a, h0 = uniform(0.01, 0.2, bsz, t, h), -uniform(0.5, 2.0, h), normal(bsz, h, n, p)
    else:
        x = normal(bsz * h, t, p).to(dtype)
        b, c = (normal(bsz * h, t, n).to(dtype) for _ in range(2))
        dt, a = uniform(0.01, 0.2, bsz * h, t), -uniform(0.5, 2.0, bsz * h)
        h0 = normal(bsz * h, n, p)
    reset_launch_counts()
    for init in (None, h0):
        y, hf = ssd.ssd_scan(x, dt, a, b, c, init, chunk=chunk)
        want_y, want_h = ssd.ssd_scan_plain(x, dt, a, b, c, init)
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(hf, want_h, atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan"] == 2
    assert launch_counts()["ssd_chunk_gram"] == 2


def _conv_views(rng, cuda, dtype, bsz, t, h, p, n, skew=0):
    """x, b, c as ``mamba_apply`` gives them: strided views of one
    (B, T, H*P + 2N) conv output, starting ``skew`` elements into its buffer."""
    wide = h * p + 2 * n
    flat = torch.from_numpy(rng.standard_normal(bsz * t * wide + skew).astype(np.float32))
    conv = flat.to(cuda, dtype)[skew:].view(bsz, t, wide)
    return (conv[..., : h * p].reshape(bsz, t, h, p), conv[..., h * p : h * p + n],
            conv[..., h * p + n :])


def _dt_a_h0(rng, cuda, bsz, t, h, p, n):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (bsz, t, h)).astype(np.float32)).to(cuda)
    a = -torch.from_numpy(rng.uniform(0.5, 2.0, (h,)).astype(np.float32)).to(cuda)
    return dt, a, f(bsz, h, n, p)


# Sums over n = 128 and q = 128 terms at the serving widths: the tolerance of
# chip_smoke.py's serving-shape check (the kernel's split-bf16 arithmetic
# lands near 1e-4 of the outputs' scale there, tests/test_torch_ssd.py).
WIDE_TOL = 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n,heads", [(64, 128, 4), (128, 128, 2)])
def test_ssd_scan_at_the_serving_widths(cuda, dtype, p, n, heads):
    """The heads layout at the serving model's widths (q = 128, n = 128,
    p = 64: two 32-column slices per head) with its strided conv-output
    views, and at q = n = p = 128, which the FMA kernel refused for shared
    memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(p + n)
    bsz, t = 2, 256
    x, b, c = _conv_views(rng, cuda, dtype, bsz, t, heads, p, n)
    dt, a, h0 = _dt_a_h0(rng, cuda, bsz, t, heads, p, n)
    for init in (None, h0):
        y, hf = ssd.ssd_scan(x, dt, a, b, c, init, chunk=128)
        want_y, want_h = ssd.ssd_scan_plain(x, dt, a, b, c, init)
        torch.testing.assert_close(y, want_y, atol=WIDE_TOL, rtol=WIDE_TOL)
        torch.testing.assert_close(hf, want_h, atol=WIDE_TOL, rtol=WIDE_TOL)


def test_ssd_scan_unaligned_views_take_the_scalar_path(cuda):
    """bf16 views that start off a 16-byte boundary (or have p, n not a
    multiple of 8) are loaded element by element, and still match."""
    rng = np.random.default_rng(9)
    bsz, t, h, p, n = 2, 96, 3, 16, 32
    x, b, c = _conv_views(rng, cuda, torch.bfloat16, bsz, t, h, p, n, skew=1)
    assert x.data_ptr() % 16 != 0
    dt, a, h0 = _dt_a_h0(rng, cuda, bsz, t, h, p, n)
    for args in ((x, dt, a, b, c, h0), (x[..., :10], dt, a, b[..., :20], c[..., :20], None)):
        y, hf = ssd.ssd_scan(*args, chunk=32)
        want_y, want_h = ssd.ssd_scan_plain(*args)
        torch.testing.assert_close(y, want_y, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(hf, want_h, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_gram_matches_plain_version(cuda, dtype):
    """G = C B^T per chunk, alone, in the scan kernel's tile order.  bf16
    products are exact and only the summation order differs (1e-5); f32
    inputs go in as hi + lo bf16 halves, ~16 bits each (1e-3)."""
    rng = np.random.default_rng(2)
    _, b, c = _conv_views(rng, cuda, dtype, 2, 200, 1, 8, 48)
    for chunk in (128, 100, 40):
        reset_launch_counts()
        got = ssd.chunk_gram(b[:, :200 // chunk * chunk], c[:, :200 // chunk * chunk],
                             chunk=chunk)
        want = ref.ssd_chunk_gram_ref(b[:, :200 // chunk * chunk],
                                      c[:, :200 // chunk * chunk], chunk)
        tol = 1e-3 if dtype == torch.float32 else 1e-5
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        assert launch_counts()["ssd_chunk_gram"] == 1


def test_ssd_scan_refuses_what_it_cannot_take(cuda):
    x = torch.zeros(2, 64, 8, device=cuda)
    dt = torch.full((2, 64), 0.1, device=cuda)
    a = -torch.ones(2, device=cuda)
    b = torch.zeros(2, 64, 16, device=cuda)
    with pytest.raises(ValueError):
        ssd.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, b, b)  # p strided
    with pytest.raises(ValueError):
        ssd.ssd_scan(x, dt, a, b.cpu(), b)  # mixed devices
    with pytest.raises(ValueError):  # n > 128
        ssd.ssd_scan(torch.zeros(2, 256, 8, device=cuda), dt.repeat(1, 4), a,
                     torch.zeros(2, 256, 256, device=cuda), torch.zeros(2, 256, 256, device=cuda))
    with pytest.raises(ValueError, match="p <= 128"):  # p past the limit
        ssd.ssd_scan(torch.zeros(2, 128, 136, device=cuda), dt.repeat(1, 2), a,
                     torch.zeros(2, 128, 16, device=cuda), torch.zeros(2, 128, 16, device=cuda))
    with pytest.raises(ValueError, match="p <= 128"):  # q = 256
        ssd.ssd_scan(torch.zeros(2, 256, 8, device=cuda), dt.repeat(1, 4), a,
                     torch.zeros(2, 256, 16, device=cuda), torch.zeros(2, 256, 16, device=cuda),
                     chunk=256)
