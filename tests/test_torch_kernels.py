"""The port's codec kernels against the JAX package's, on the same inputs.

On the CPU every wrapper of ``repro_torch.kernels`` runs its plain torch
version; these tests hold those (through the wrappers and the ``ops`` layer)
bit-exact against ``repro.kernels.ref`` and against the Pallas kernels run in
interpret mode (``repro.kernels.ops`` with ``use_pallas=True``).  Inputs are
full-range int32 words from numpy seeds, sign bit included.  Tolerance is 0:
every lane is packed bytes.  The CUDA kernels themselves are checked by
``test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gf as jgf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import gf as tgf
from repro_torch.kernels import _build, launch_counts, reset_launch_counts
from repro_torch.kernels import gf256_matmul as tgm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import parity_xor as tpx
from repro_torch.kernels import ref as tref

PALLAS = dict(use_pallas=True, interpret=True)


def _words(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _eq(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.dtype == torch.int32 and got.shape == want.shape and \
        np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,n", itertools.product([2, 3, 5, 8], [1, 4, 127, 1024]))
def test_xor_matches_reference_and_pallas(k, n):
    x = _words(k * 1000 + n, 3, k, n)
    assert _eq(tref.parity_xor_ref(_t(x[0])), jref.parity_xor_ref(jnp.asarray(x[0])))
    assert _eq(tref.parity_xor_batch_ref(_t(x)), jref.parity_xor_batch_ref(jnp.asarray(x)))
    assert _eq(tops.xor_parity(_t(x[0])), jops.xor_parity(jnp.asarray(x[0]), **PALLAS))
    assert _eq(tops.xor_parity_batch(_t(x)),
               jops.xor_parity_batch(jnp.asarray(x), **PALLAS))


@pytest.mark.parametrize("k,m", [(2, 2), (3, 2), (4, 2), (5, 3)])
def test_gf_encode_matches_reference_and_pallas(k, m):
    x = _words(10 * k + m, 3, k, 127)
    coeff = jgf.rs_parity_matrix(k, m).astype(np.int32)
    assert _eq(tref.gf256_matmul_ref(_t(coeff), _t(x[0])),
               jref.gf256_matmul_ref(jnp.asarray(coeff), jnp.asarray(x[0])))
    assert _eq(tref.gf256_matmul_batch_ref(_t(coeff), _t(x)),
               jref.gf256_matmul_batch_ref(jnp.asarray(coeff), jnp.asarray(x)))
    assert _eq(tops.rs_encode(_t(x[0]), m), jops.rs_encode(jnp.asarray(x[0]), m, **PALLAS))
    assert _eq(tops.rs_encode_batch(_t(x), m),
               jops.rs_encode_batch(jnp.asarray(x), m, **PALLAS))


def test_gf_decode_every_survivor_set_k4_m2():
    """Decode from every 4-of-6 survivor set (and one permuted order): equal
    to the Pallas decode and to the original data."""
    k, m, n = 4, 2, 130
    data = _words(42, 2, k, n)
    par = tops.rs_encode_batch(_t(data), m).numpy()
    code = np.concatenate([data, par], axis=1)  # (S, k+m, n)
    sets = list(itertools.combinations(range(k + m), k)) + [(5, 0, 3, 2)]
    for roles in sets:
        surv = np.ascontiguousarray(code[:, list(roles)])
        got = tops.rs_decode_batch(_t(surv), roles, k, m)
        assert _eq(got, data), roles
        assert _eq(got, jops.rs_decode_batch(jnp.asarray(surv), roles, k, m, **PALLAS))
        one = tops.rs_decode(_t(surv[0]), roles, k, m)
        assert _eq(one, jops.rs_decode(jnp.asarray(surv[0]), roles, k, m, **PALLAS))


def test_coeff_matrices_cached_per_device():
    a = tops.rs_parity_coeff(4, 2, "cpu")
    assert a is tops.rs_parity_coeff(4, 2, torch.device("cpu"))
    assert np.array_equal(a.numpy(), jgf.rs_parity_matrix(4, 2))
    d = tops.rs_decode_coeff(4, 2, (0, 2, 4, 5), "cpu")
    assert d is tops.rs_decode_coeff(4, 2, [0, 2, 4, 5], "cpu")
    assert np.array_equal(np.asarray(jops.rs_decode_coeff(4, 2, (0, 2, 4, 5))), d.numpy())


def test_swar_gf_scale_all_coefficients():
    """torch int32 tensors through the port's SWAR routine equal numpy through
    the reference's, for all 256 coefficients (sign-bit words included,
    where the reference leans on int32 wraparound in ``<< 1``)."""
    w = _words(5, 4096)
    assert (w < 0).any()
    t = _t(w)
    for c in range(256):
        want = jgf.swar_gf_scale(w, c)
        assert np.array_equal(tgf.swar_gf_scale(t, c).numpy(), want), c
        assert np.array_equal(tgf.swar_gf_scale(t, torch.tensor(c, dtype=torch.int32)).numpy(),
                              want), c
    # the SWAR product agrees with the table-based field multiply
    b = w.view(np.uint8).reshape(-1, 4)
    for c in (0, 1, 2, 0x1D, 0x80, 0xFF):
        got = tgf.swar_gf_scale(t, c).numpy().view(np.uint8).reshape(-1, 4)
        assert np.array_equal(got, jgf.gf_mul_np(b, np.uint8(c)))


def test_wrappers_dispatch_on_device_and_validate():
    reset_launch_counts()
    x = _t(_words(1, 2, 3, 8))
    c = tops.rs_parity_coeff(3, 2, "cpu")
    # CPU tensors take the plain versions and launch nothing
    assert torch.equal(tpx.parity_xor_batch(x), tref.parity_xor_batch_ref(x))
    assert torch.equal(tpx.parity_xor(x[0]), tref.parity_xor_ref(x[0]))
    assert torch.equal(tgm.gf256_matmul_batch(c, x), tref.gf256_matmul_batch_ref(c, x))
    assert torch.equal(tgm.gf256_matmul(c, x[0]), tref.gf256_matmul_ref(c, x[0]))
    assert set(launch_counts().values()) == {0}
    with pytest.raises(TypeError):
        tpx.parity_xor_batch(x.long())
    with pytest.raises(TypeError):
        tpx.parity_xor(x)  # wrong rank
    with pytest.raises(ValueError):
        tgm.gf256_matmul_batch(tops.rs_parity_coeff(2, 2, "cpu"), x)  # k mismatch
    with pytest.raises(ValueError):
        tpx.parity_xor_batch(torch.empty((2, 3, 8), dtype=torch.int32, device="meta"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    """No compiler means an error, never a silent fallback to the CPU."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path().parent == tmp_path
