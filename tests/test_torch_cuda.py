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

from repro_torch.configs import get_config
from repro_torch.core import raid
from repro_torch.kernels import gf256_matmul as gfm
from repro_torch.kernels import CODEC_KERNELS, launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels import parity_xor as px
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serve import grow_cache
from repro_torch.models.config import smoke
from repro_torch.models.model import build_model

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
@pytest.mark.parametrize("p,n,heads", [(64, 128, 4), (128, 128, 2), (64, 64, 8)])
def test_ssd_scan_at_the_serving_widths(cuda, dtype, p, n, heads):
    """The heads layout at the serving models' widths (q = 128, p = 64: two
    32-column slices per head; n = 128 for mamba2-1.3b, n = 64 for
    zamba2-2.7b) with its strided conv-output views, and at q = n = p =
    128, which the FMA kernel refused for shared memory."""
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
    """G = C B^T per chunk, alone, in the scan kernel's tile order, at n = 48
    and zamba2's n = 64, and at t < chunk.  bf16 products are exact and only
    the summation order differs (1e-5); f32 inputs go in as hi + lo bf16
    halves, ~16 bits each (1e-3); every call equals its repeat."""
    rng = np.random.default_rng(2)
    for t, n, chunk in ((200, 48, 128), (200, 48, 100), (200, 48, 40), (256, 64, 128),
                        (64, 64, 128)):
        _, b, c = _conv_views(rng, cuda, dtype, 2, t, 1, 8, n)
        q = min(chunk, t)
        b, c = b[:, :t // q * q], c[:, :t // q * q]
        reset_launch_counts()
        got = ssd.chunk_gram(b, c, chunk=chunk)
        again = ssd.chunk_gram(b, c, chunk=chunk)
        want = ref.ssd_chunk_gram_ref(b, c, q)
        tol = 1e-3 if dtype == torch.float32 else 1e-5
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        assert torch.equal(got, again), (t, n, chunk)
        assert launch_counts()["ssd_chunk_gram"] == 2


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


def _smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["exp10", "raid6_degraded"])
def test_timed_replay_on_the_card_equals_the_cpu(cuda, name):
    """A small timed replay (the reference's Exp#10 trace; a degraded RAID-6
    replay) through the card's codec kernels and through the plain versions:
    latency samples, percentiles, notes but the host-clock encode sum,
    counters, the virtual clock, events fired, bookings, drive images, L2P
    and Stats are all equal."""
    smoke = _smoke()
    scenario = smoke.TIMED_SCENARIOS[name]
    reset_launch_counts()
    on_card = smoke.timed_outputs(scenario("cuda"))
    launched = launch_counts()
    on_cpu = smoke.timed_outputs(scenario("cpu"))
    assert smoke.output_differences(on_card, on_cpu) == []
    assert launch_counts() == launched  # the CPU run launched nothing
    want = ("parity_xor_batch", "parity_xor") if name == "exp10" else \
        ("gf256_matmul_batch", "gf256_matmul")
    assert all(launched[k] > 0 for k in want), launched


# ------------------------------------------------- service and checkpoint

def _parity_shards(device, k=4):
    rng = np.random.default_rng(k)
    return [{"m": torch.from_numpy(rng.standard_normal((64, 33)).astype(np.float32)).to(device),
             "b": torch.from_numpy(rng.standard_normal(1027).astype(np.float32))
             .to(torch.bfloat16).to(device),
             "q": torch.from_numpy(rng.integers(0, 256, 4099, dtype=np.uint8)).to(device)}
            for _ in range(k)]


@pytest.mark.parametrize("m", [1, 2])
def test_state_parity_on_the_card_equals_the_cpu(cuda, m):
    """``encode_shards`` / ``reconstruct_shard`` on CUDA tensors launch the
    single-stripe kernels on device memory and equal the CPU's plain path;
    outputs stay on the card."""
    from repro_torch.checkpoint import state_parity as sp

    k, lost = 4, 2
    card, host = _parity_shards(cuda, k), _parity_shards("cpu", k)
    reset_launch_counts()
    pc, ph = sp.encode_shards(card, m=m), sp.encode_shards(host, m=m)
    rec = sp.reconstruct_shard(lost, {r: card[r] for r in range(k) if r != lost}, pc, k)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["gf256_matmul" if m == 2 else "parity_xor"] == 2 * 3  # 3 leaves, encode + rebuild
    for a, b in zip(pc, ph):
        for name in a:
            assert a[name].is_cuda and a[name].dtype == torch.uint8
            assert torch.equal(a[name].cpu(), b[name])
    for name, leaf in card[lost].items():
        assert rec[name].is_cuda and rec[name].dtype == leaf.dtype
        assert torch.equal(rec[name], leaf)


def test_checkpoint_under_serving_on_the_card_equals_the_cpu(cuda):
    """The ``service/ckpt_vs_serve_p99_qos`` scenario with the array's codec
    on the card and on the CPU: every output equal, the restore bit-exact,
    the group kernel launched."""
    from repro_torch.service.scenario import checkpoint_under_serving

    reset_launch_counts()
    on_card = checkpoint_under_serving(policy="qos", device="cuda")
    launched = launch_counts()
    on_cpu = checkpoint_under_serving(policy="qos", device="cpu")
    assert _smoke()._same(on_card, on_cpu) and on_card["restore_ok"] is True
    assert launched["parity_xor_batch"] > 0, launched


def test_checkpoint_engine_restores_card_tensors(cuda):
    """A RAID-6 engine on the card saves CUDA tensors (f32, bf16, an int32
    scalar) and restores them, through two failed lanes and a crash
    remount, as CUDA tensors of equal bits; the media equal a CPU engine's."""
    from repro_torch.checkpoint.zapraid_ckpt import CheckpointConfig, CheckpointEngine
    from repro_torch.core.zns import drive_images

    def engine(device):
        cfg = CheckpointConfig(n_lanes=5, scheme="raid6", group_size=8, block_bytes=512,
                               zone_cap_blocks=256, n_zones=32, chunk_blocks=2, device=device)
        return CheckpointEngine(cfg, logical_blocks=1 << 12)

    rng = np.random.default_rng(5)
    state = {"w": torch.from_numpy(rng.standard_normal((33, 17)).astype(np.float32)),
             "m": torch.from_numpy(rng.standard_normal(300).astype(np.float32)).to(torch.bfloat16),
             "step": torch.tensor(9, dtype=torch.int32)}
    card = {k: v.to(cuda) for k, v in state.items()}
    a, b = engine("cuda"), engine("cpu")
    a.save(1, card)
    b.save(1, state)
    for x, y in zip(drive_images(a.array.drives), drive_images(b.array.drives)):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    a.fail_lane(0)
    a.fail_lane(3)
    a = a.crash_and_remount()
    out = a.restore(1, card)
    for k, v in card.items():
        assert out[k].is_cuda and out[k].dtype == v.dtype and torch.equal(out[k], v)


@pytest.fixture
def card_mesh(cuda):
    """The card's (1, 1) mesh (an NCCL group of one), torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    yield make_host_mesh(device_type="cuda")
    dist.destroy_process_group()


def _card_dtensor_state(mesh):
    """f32, bf16 and int32 leaves on the card, as DTensors placed
    [Shard(0), Replicate()], [Shard(0), Shard(0)] and [Replicate(),
    Replicate()]; and the same values as plain CPU tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rng = np.random.default_rng(8)
    host = {"w": torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32)),
            "m": torch.from_numpy(rng.standard_normal(333).astype(np.float32)).to(torch.bfloat16),
            "step": torch.tensor(4, dtype=torch.int32)}
    places = {"w": [Shard(0), Replicate()], "m": [Shard(0), Shard(0)],
              "step": [Replicate(), Replicate()]}
    card = {k: distribute_tensor(v.to("cuda"), mesh, places[k], src_data_rank=None)
            for k, v in host.items()}
    return card, host


def test_checkpoint_engine_restores_dtensors_on_the_card(card_mesh):
    """A RAID-5 engine on the card saves DTensors on the card's mesh: the
    media equal a CPU engine's save of the same plain values; restored with
    lane 1 failed, each leaf is a DTensor placed as saved, on the card, its
    global value bit-equal; the group kernel launched."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.zapraid_ckpt import CheckpointConfig, CheckpointEngine
    from repro_torch.core.zns import drive_images

    def engine(device):
        cfg = CheckpointConfig(n_lanes=4, scheme="raid5", group_size=8, block_bytes=512,
                               zone_cap_blocks=256, n_zones=32, chunk_blocks=2, device=device)
        return CheckpointEngine(cfg, logical_blocks=1 << 12)

    card, host = _card_dtensor_state(card_mesh)
    a, b = engine("cuda"), engine("cpu")
    reset_launch_counts()
    a.save(1, card)
    b.save(1, host)
    assert launch_counts()["parity_xor_batch"] > 0
    for x, y in zip(drive_images(a.array.drives), drive_images(b.array.drives), strict=True):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    assert np.array_equal(a._manifest_blocks(), b._manifest_blocks())
    a.fail_lane(1)
    out = a.restore(1, card)
    assert a.array.stats.degraded_reads > 0
    for k, v in card.items():
        assert isinstance(out[k], DTensor) and out[k].placements == v.placements
        assert out[k].to_local().is_cuda
        assert torch.equal(out[k].full_tensor().cpu(), host[k])


@pytest.mark.parametrize("m", [1, 2])
def test_state_parity_over_dtensors_on_the_card_equals_the_cpu(card_mesh, m):
    """``encode_shards`` / ``reconstruct_shard`` over DTensor shards on the
    card: parity rows plain uint8 tensors on the card, equal to the CPU's
    plain path on the same values; the rebuilt leaves DTensors placed as the
    template's, bit-exact; the single-stripe kernel launched."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint import state_parity as sp

    k, lost = 4, 2
    host = _parity_shards("cpu", k)
    card = [{n: distribute_tensor(t.to("cuda"), card_mesh,
                                  [Shard(0), Shard(1) if t.ndim == 2 else Replicate()],
                                  src_data_rank=None) for n, t in s.items()} for s in host]
    reset_launch_counts()
    pc, ph = sp.encode_shards(card, m=m), sp.encode_shards(host, m=m)
    rec = sp.reconstruct_shard(lost, {r: card[r] for r in range(k) if r != lost}, pc, k)
    torch.cuda.synchronize()
    assert launch_counts()["gf256_matmul" if m == 2 else "parity_xor"] > 0
    for a, b in zip(pc, ph):
        for name in a:
            assert type(a[name]) is torch.Tensor and a[name].is_cuda
            assert torch.equal(a[name].cpu(), b[name])
    for name, leaf in card[lost].items():
        assert isinstance(rec[name], DTensor) and rec[name].placements == leaf.placements
        assert torch.equal(rec[name].full_tensor().cpu(), host[lost][name])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama4-scout-17b-a16e", "paligemma-3b",
                                  "zamba2-2.7b", "whisper-small"])
def test_smoke_model_on_the_card_equals_the_cpu(cuda, arch):
    """One model per family (dense, moe, vlm, hybrid, encdec) at smoke size
    in f32: prefill and three decode steps on the card against the same
    weights on the CPU, logits and caches within 2e-4 (the parity tests'
    model tolerance); the hybrid's prefill launches each SSD kernel once per
    Mamba-2 layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke(get_config(arch))
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 15)))
    extra = {}
    if cfg.family == "vlm":
        extra["vis_embeds"] = rng.standard_normal((2, cfg.vis_prefix_len, cfg.vis_embed_dim))
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal((2, cfg.enc_len, cfg.d_model))
    runs = []
    for model in (cpu, card):
        dev = model.device
        reset_launch_counts()
        kw = {k: torch.from_numpy(0.1 * v).float().to(dev) for k, v in extra.items()}
        logits, cache = model.prefill(toks[:, :12].to(dev), **kw)
        launches = launch_counts()["ssd_scan"], launch_counts()["ssd_chunk_gram"]
        grow_cache(cache, 3)
        seen = [logits]
        for i in range(3):
            logits, cache = model.decode_step(cache, toks[:, 12 + i : 13 + i].to(dev))
            seen.append(logits)
        runs.append((seen, cache, launches))
    (want, want_cache, none), (got, got_cache, launched) = runs
    assert none == (0, 0)
    assert launched == ((cfg.n_layers,) * 2 if cfg.family == "hybrid" else (0, 0))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, atol=2e-4, rtol=2e-4)
    assert got_cache.keys() == want_cache.keys() and got_cache["len"] == want_cache["len"]
    for key in set(want_cache) - {"len"}:
        torch.testing.assert_close(got_cache[key].cpu(), want_cache[key], atol=2e-4, rtol=2e-4)


# ------------------------------------------------------- the SSD scan's gradient

def _ssd_heads(seed, bsz, t, nh, p, n, dtype, h0, dh, device):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return (f(bsz, t, nh, p).to(device, dtype),
            torch.from_numpy(rng.uniform(0.01, 0.3, (bsz, t, nh)).astype(np.float32)).to(device),
            torch.from_numpy(-rng.uniform(0.5, 2.0, (nh,)).astype(np.float32)).to(device),
            f(bsz, t, n).to(device, dtype), f(bsz, t, n).to(device, dtype),
            f(bsz, nh, n, p).to(device) if h0 else None, f(bsz, t, nh, p).to(device),
            f(bsz, nh, n, p).to(device) if dh else None)


# max |kernel - plain| over the largest |plain| of each gradient: f32 sums in
# another order; in bf16 dx, db, dc are rounded to bf16 on both sides
SSD_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _ssd_rows(seed, bh, t, p, n, dtype, h0, dh, device):
    """(x, dt, a, b, c, h0, dy, dh) in the rows layout: a, b and c per row."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return (f(bh, t, p).to(device, dtype),
            torch.from_numpy(rng.uniform(0.01, 0.3, (bh, t)).astype(np.float32)).to(device),
            torch.from_numpy(-rng.uniform(0.5, 2.0, (bh,)).astype(np.float32)).to(device),
            f(bh, t, n).to(device, dtype), f(bh, t, n).to(device, dtype),
            f(bh, n, p).to(device) if h0 else None, f(bh, t, p).to(device),
            f(bh, n, p).to(device) if dh else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,q,h0,dh", [
    ((2, 64, 4, 64, 128), 32, True, True), ((2, 100, 3, 16, 16), 128, False, True),
    ((1, 256, 2, 64, 64), 128, True, False), ((3, 48, 2, 8, 16), 16, False, False),
    # mamba2-1.3b's 64 heads (4 groups of 16 on 132 SMs) at a short t
    ((2, 128, 64, 64, 128), 128, True, True),
    # zamba2-2.7b's 80 heads at n = 64
    ((1, 256, 80, 64, 64), 128, False, True),
    # the rows layout (bh, t, p, n): a, b and c per row, one head each
    ((3, 64, 8, 16), 16, True, True)])
def test_ssd_scan_bwd_matches_plain(cuda, dtype, shape, q, h0, dh):
    make = _ssd_rows if len(shape) == 4 else _ssd_heads
    args = make(sum(shape), *shape, dtype, h0, dh, cuda)
    reset_launch_counts()
    got = ssd.ssd_scan_bwd(*args, chunk=q)
    again = ssd.ssd_scan_bwd(*args, chunk=q)
    want = ssd.ssd_scan_bwd_plain(*args, chunk=q)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan_bwd"] == 2
    for name, g, g2, w in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, again, want):
        if w is None:
            assert g is None and name == "dh0"
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, g2), f"{name}: two calls differ"
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= SSD_GRAD_TOL[dtype], (name, err)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b", "smollm-135m", "whisper-small"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of the smoke model on the card against the CPU's, f32:
    loss and grad norm at 2e-4 (the serving tests' card-vs-CPU tolerance),
    the SSD kernels (forward with its states, and backward) launched."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps

    cfg = smoke(get_config(arch))
    out = {}
    for dev in ("cpu", cuda):
        model, step = steps.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2),
                                            device=dev,
                                            generator=torch.Generator(device="cpu").manual_seed(1)
                                            if dev == "cpu" else None)
        if dev != "cpu":
            for name, p in model.named_parameters():
                p.data.copy_(out["cpu_params"][name])
        else:
            out["cpu_params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
        params = steps.params_of(model)
        batch = batch_for_step(DataConfig(2, 19, cfg.vocab), cfg, 0, device=dev)
        reset_launch_counts()
        _, _, m = step(params, steps.init_opt_state(model, params, AdamWConfig()), batch)
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]), launch_counts())
    (l0, g0, _), (l1, g1, counts) = out["cpu"], out[str(cuda)]
    assert abs(l1 - l0) <= 2e-4 * abs(l0) and abs(g1 - g0) <= 2e-4 * abs(g0)
    ssm = cfg.family in ("ssm", "hybrid")
    assert (counts["ssd_scan_bwd"] == cfg.n_layers) == ssm


def test_mesh_train_step_on_card_matches_cpu(cuda):
    """One train step of smoke mamba2 with its params, AdamW state and batch
    as DTensors on the card's (1, 1) mesh (``make_host_mesh``: an NCCL group
    of one) against the same step on the CPU, f32: loss, grad norm and every
    new parameter at 2e-4 of its largest value; the SSD kernels launched
    once per layer each way, through the scan's ``local_map``."""
    import torch.distributed as dist

    from repro_torch.checkpoint import _tree
    from repro_torch.data.pipeline import DataConfig, batch_for_step, batch_specs
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig, state_specs
    from repro_torch.train import steps

    cfg = smoke(get_config("mamba2-1.3b"))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    dc = DataConfig(2, 19, cfg.vocab)
    model, step = steps.make_train_step(cfg, opt_cfg, device="cpu",
                                        generator=torch.Generator().manual_seed(1))
    params = steps.params_of(model)
    want_p, _, want = step(params, steps.init_opt_state(model, params, opt_cfg),
                           batch_for_step(dc, cfg, 0, device="cpu"))
    mesh = make_host_mesh(device_type="cuda")
    try:
        gmodel, gstep = steps.make_train_step(cfg, opt_cfg, device=cuda)
        gparams = adamw.tree_map(lambda v: v.to(cuda), params)
        pspecs = sh.param_specs(gparams, gmodel.axes(), mesh)
        opt = steps.init_opt_state(gmodel, gparams, opt_cfg)
        reset_launch_counts()
        with sh.use_mesh(mesh):
            got_p, _, got = gstep(sh.distribute(gparams, mesh, pspecs),
                                  sh.distribute(opt, mesh, state_specs(pspecs, gparams, mesh)),
                                  sh.distribute(batch_for_step(dc, cfg, 0, device=cuda), mesh,
                                                batch_specs(dc, cfg, mesh)))
        counts = launch_counts()
        for key in ("loss", "grad_norm"):
            g, w = float(got[key].full_tensor()), float(want[key])
            assert abs(g - w) <= 2e-4 * abs(w), key
        for (name, w), g in zip(_tree.flatten_with_path(want_p)[0], _tree.leaves(got_p)):
            g = g.full_tensor().cpu()
            assert float((g - w).abs().max()) <= 2e-4 * float(w.abs().max()) + 1e-30, name
        assert counts["ssd_scan_bwd"] == cfg.n_layers and counts["ssd_scan"] == cfg.n_layers
    finally:
        dist.destroy_process_group()


def test_ssd_custom_ops_fake_shapes_match_the_kernel(cuda):
    """The SSD operators' shape functions, on fake tensors, give the real
    kernels' output shapes and dtypes (forward with and without the chunk
    states, and the backward), in both layouts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rng = np.random.default_rng(3)
    for dtype, heads, h0 in ((torch.bfloat16, True, False), (torch.float32, False, True)):
        bsz, t, nh, p, n, q = 2, 256, 4, 32, 64, 128
        if heads:
            shapes = [(bsz, t, nh, p), (bsz, t, nh), (nh,), (bsz, t, n), (bsz, t, n)]
            h0_shape = (bsz, nh, n, p)
        else:
            shapes = [(bsz, t, p), (bsz, t), (bsz,), (bsz, t, n), (bsz, t, n)]
            h0_shape = (bsz, n, p)
        dts = [dtype, torch.float32, torch.float32, dtype, dtype]
        args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, d)
                for s, d in zip(shapes, dts)]
        args[1] = args[1].abs() * 0.1
        args[2] = -args[2].abs()
        init = torch.zeros(h0_shape, device=cuda) if h0 else None
        for keep in (False, True):
            real = ssd.ssd_scan_op(*args, init, q, keep)
            with FakeTensorMode(allow_non_fake_inputs=True) as mode:
                fake = ssd.ssd_scan_op(*(mode.from_tensor(a) for a in args),
                                       None if init is None else mode.from_tensor(init),
                                       q, keep)
            assert [(tuple(r.shape), r.dtype, r.device.type) for r in real] == \
                [(tuple(f.shape), f.dtype, f.device.type) for f in fake]
        dy = torch.ones_like(real[0])
        real_b = ssd.ssd_scan_bwd_op(*args, init, dy, None, real[2], q)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake_b = ssd.ssd_scan_bwd_op(*(mode.from_tensor(a) for a in args),
                                         None if init is None else mode.from_tensor(init),
                                         mode.from_tensor(dy), None, mode.from_tensor(real[2]), q)
        assert [(tuple(r.shape), r.dtype) for r in real_b] == \
            [(tuple(f.shape), f.dtype) for f in fake_b]
