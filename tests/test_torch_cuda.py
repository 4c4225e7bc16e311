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
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels import parity_xor as px

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
    assert launch_counts() == {"parity_xor_batch": 1, "parity_xor": 1,
                               "gf256_matmul_batch": 2, "gf256_matmul": 2}


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
