"""The port's stripe codec against the JAX package's, surface by surface.

Every ``StripeCodec`` entry point, ``parity_oob(_batch)`` and
``decode_meta(_batch)`` of ``repro_torch.core.raid`` (on the CPU) must give
the bytes ``repro.core.raid`` gives, for RAID-0/01/4/5/6 at 4-6 drives, every
surviving-role set, lane counts that are not multiples of 128, and the same
host<->device transfer counts.  Inputs come from numpy seeds; tolerance 0.
"""
import itertools
import types

import numpy as np
import pytest
import torch

from repro.core import raid as jraid
from repro_torch.core import raid as traid

SCHEMES = [("raid0", 4), ("raid01", 4), ("raid01", 6), ("raid4", 4), ("raid4", 5),
           ("raid5", 4), ("raid5", 6), ("raid6", 4), ("raid6", 5), ("raid6", 6)]
N_BYTES = 4 * 37  # 37 int32 lanes: neither a multiple of 4 lanes nor of 128


def _stats():
    return types.SimpleNamespace(h2d_copies=0, h2d_bytes=0, d2h_copies=0, d2h_bytes=0)


def _codecs(scheme, n):
    j = jraid.StripeCodec(jraid.make_scheme(scheme, n))
    t = traid.StripeCodec(traid.make_scheme(scheme, n), device="cpu")
    j.copy_stats, t.copy_stats = _stats(), _stats()
    return j, t


def _role_sets(s):
    """Every set of k surviving roles the scheme can decode from, plus one
    in a permuted order."""
    out = []
    for roles in itertools.combinations(range(s.n), s.k):
        if s.mirror and len({r % s.k for r in roles}) < s.k:
            continue
        out.append(roles)
    return out + [tuple(reversed(out[-1]))]


@pytest.mark.parametrize("scheme,n", SCHEMES)
def test_scheme_and_placement_equal(scheme, n):
    js, ts = jraid.make_scheme(scheme, n), traid.make_scheme(scheme, n)
    assert (js.name, js.k, js.m, js.rotate, js.mirror) == \
        (ts.name, ts.k, ts.m, ts.rotate, ts.mirror)
    seqs = np.arange(13)
    assert np.array_equal(js.rotation_many(seqs), ts.rotation_many(seqs))
    for d in range(n):
        assert np.array_equal(js.drive_to_role_many(d, seqs), ts.drive_to_role_many(d, seqs))
    assert np.array_equal(jraid.gf_coeff_matrix(3, 2), traid.gf_coeff_matrix(3, 2))


@pytest.mark.parametrize("scheme,n", SCHEMES)
def test_codec_surfaces_equal(scheme, n):
    j, t = _codecs(scheme, n)
    s = t.scheme
    rng = np.random.default_rng(n * 31 + s.m)
    data = rng.integers(0, 256, (5, s.k, N_BYTES), dtype=np.uint8)
    # encode: single stripe and a batch of 5 (padded to 8 stripes)
    assert np.array_equal(t.encode_np(data[0]), j.encode_np(data[0]))
    par = j.encode_batch_np(data)
    assert np.array_equal(t.encode_batch_np(data), par)
    # the async group entry points on an int32 gather
    packed = data.view(np.int32)
    keep = packed.copy()
    got = t.materialize(t.encode_batch_async(packed))
    assert np.array_equal(got, j.materialize(j.encode_batch_async(packed)))
    assert np.array_equal(packed, keep)  # the host buffer is copied, not aliased
    got[...] = 0  # a materialized result belongs to the caller alone
    if s.m == 0:
        for c in (t, j):
            with pytest.raises(ValueError):
                c.decode_np(data[0], tuple(range(s.k)))
            with pytest.raises(ValueError):
                c.decode_batch_np(data, tuple(range(s.k)))
    else:
        code = np.concatenate([data, par], axis=1)  # (S, n, bytes) by role
        for roles in _role_sets(s):
            surv = np.ascontiguousarray(code[:, list(roles)])
            want = j.decode_batch_np(surv, roles)
            assert np.array_equal(want, data), roles
            assert np.array_equal(t.decode_batch_np(surv, roles), want), roles
            assert np.array_equal(t.decode_np(surv[0], roles), j.decode_np(surv[0], roles))
            dev = t.materialize(t.decode_batch_async(surv.view(np.int32), roles))
            assert np.array_equal(dev, j.materialize(
                j.decode_batch_async(surv.view(np.int32), roles)))
    assert vars(t.copy_stats) == vars(j.copy_stats)


@pytest.mark.parametrize("scheme,n", [s for s in SCHEMES if s[0] != "raid0"])
def test_oob_metadata_encode_decode_equal(scheme, n):
    j, t = _codecs(scheme, n)
    s = t.scheme
    rng = np.random.default_rng(7 * n + s.m)
    c = 1  # OOB rows are 4c int32 lanes: 4 of them
    lbas = rng.integers(0, 2**63, (6, s.k, c), dtype=np.int64).astype(np.uint64)
    ts = rng.integers(0, 2**63, (6, s.k, c), dtype=np.int64).astype(np.uint64)
    p1 = traid.parity_oob(t, lbas[0], ts[0])
    for a, b in zip(p1, jraid.parity_oob(j, lbas[0], ts[0])):
        assert np.array_equal(a, b)
    pb = traid.parity_oob_batch(t, lbas, ts)
    for a, b in zip(pb, jraid.parity_oob_batch(j, lbas, ts)):
        assert np.array_equal(a, b)
    code_l = np.concatenate([lbas, pb[0]], axis=1)
    code_t = np.concatenate([ts, pb[1]], axis=1)
    for roles in _role_sets(s)[:4]:
        sl = np.ascontiguousarray(code_l[:, list(roles)])
        st_ = np.ascontiguousarray(code_t[:, list(roles)])
        got = traid.decode_meta_batch(t, sl, st_, roles)
        want = jraid.decode_meta_batch(j, sl, st_, roles)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert np.array_equal(got[0], lbas) and np.array_equal(got[1], ts)
        one = traid.decode_meta(t, sl[0], st_[0], roles)
        ref = jraid.decode_meta(j, sl[0], st_[0], roles)
        assert np.array_equal(one[0], ref[0]) and np.array_equal(one[1], ref[1])
    assert vars(t.copy_stats) == vars(j.copy_stats)


def test_pad_batch_power_of_two():
    x = np.ones((5, 2, 8), np.uint8)
    got, n = traid.StripeCodec._pad_batch(x)
    want, n2 = jraid.StripeCodec._pad_batch(x)
    assert n == n2 == 5 and got.shape == (8, 2, 8) and np.array_equal(got, want)


def test_device_check():
    s = traid.make_scheme("raid5", 4)
    assert traid.StripeCodec(s, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        traid.StripeCodec(s, device="meta")
