"""The codec's per-stripe path against the JAX package's, on the CPU.

``StripeCodec.encode_np`` / ``decode_np`` stage a stripe into the codec's
own buffers (rows padded to 16-byte boundaries) and run one single-stripe
kernel on them; on the CPU the kernels' plain versions run on the same
staged buffers.  Every surface built on them (``parity_oob``,
``decode_meta``) must give the bytes ``repro.core.raid`` gives, for RAID-4,
RAID-5 and RAID-6 at 4-8 drives, chunk sizes that are not multiples of 16
bytes, every survivor set, and the same host<->device transfer counts.
Inputs come from numpy seeds; tolerance 0.
"""
import itertools
import types

import numpy as np
import pytest
import torch

from repro.core import raid as jraid
from repro_torch.core import raid as traid
from repro_torch.kernels import _build

SCHEMES = [(s, n) for s in ("raid4", "raid5", "raid6") for n in range(4, 9)]
# chunk bytes: 5 and 37 int32 lanes (neither a multiple of 4 lanes), and 4
CHUNK_BYTES = (20, 148, 16)


def _stats():
    return types.SimpleNamespace(h2d_copies=0, h2d_bytes=0, d2h_copies=0, d2h_bytes=0)


def _codecs(scheme, n):
    j = jraid.StripeCodec(jraid.make_scheme(scheme, n))
    t = traid.StripeCodec(traid.make_scheme(scheme, n), device="cpu")
    j.copy_stats, t.copy_stats = _stats(), _stats()
    return j, t


@pytest.mark.parametrize("nbytes", CHUNK_BYTES)
@pytest.mark.parametrize("scheme,n", SCHEMES)
def test_encode_decode_every_survivor_set(scheme, n, nbytes):
    j, t = _codecs(scheme, n)
    s = t.scheme
    rng = np.random.default_rng(100 * n + nbytes + s.m)
    data = rng.integers(0, 256, (s.k, nbytes), dtype=np.uint8)
    par = t.encode_np(data)
    assert np.array_equal(par, j.encode_np(data))
    code = np.concatenate([data, par])
    for roles in itertools.combinations(range(s.n), s.k):
        surv = np.ascontiguousarray(code[list(roles)])
        got = t.decode_np(surv, roles)
        assert np.array_equal(got, j.decode_np(surv, roles)), roles
        assert np.array_equal(got, data), roles
    # a permuted all-data survivor set is a reorder, no kernel
    roles = tuple(reversed(range(s.k)))
    surv = np.ascontiguousarray(code[list(roles)])
    assert np.array_equal(t.decode_np(surv, roles), j.decode_np(surv, roles))
    with pytest.raises(ValueError):
        t.decode_np(code[: s.k - 1], tuple(range(s.k - 1)))
    with pytest.raises(ValueError):
        j.decode_np(code[: s.k - 1], tuple(range(s.k - 1)))
    assert vars(t.copy_stats) == vars(j.copy_stats)


@pytest.mark.parametrize("n", [4, 6, 8])
def test_mirror_and_raid0_need_no_kernel(n):
    """RAID-01's parity rows are copies and a decode picks a surviving copy
    of each chunk, on the host; RAID-0 cannot decode.  Bytes, refusals and
    transfer counts as the reference's."""
    j, t = _codecs("raid01", n)
    s = t.scheme
    data = np.random.default_rng(n).integers(0, 256, (s.k, 20), dtype=np.uint8)
    par = t.encode_np(data)
    assert np.array_equal(par, j.encode_np(data)) and np.array_equal(par, data)
    code = np.concatenate([data, par])
    for roles in itertools.combinations(range(s.n), s.k):
        surv = np.ascontiguousarray(code[list(roles)])
        if len({r % s.k for r in roles}) < s.k:  # both copies of a chunk lost
            for codec in (t, j):
                with pytest.raises(ValueError):
                    codec.decode_np(surv, roles)
            continue
        got = t.decode_np(surv, roles)
        assert np.array_equal(got, j.decode_np(surv, roles)) and np.array_equal(got, data)
    assert vars(t.copy_stats) == vars(j.copy_stats)
    j0, t0 = _codecs("raid0", n)
    assert t0.encode_np(data).shape == j0.encode_np(data).shape == (0, 20)
    for codec in (t0, j0):
        with pytest.raises(ValueError):
            codec.decode_np(data, tuple(range(s.k)))
    assert vars(t0.copy_stats) == vars(j0.copy_stats)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("scheme,n", SCHEMES)
def test_oob_metadata_every_survivor_set(scheme, n, c):
    j, t = _codecs(scheme, n)
    s = t.scheme
    rng = np.random.default_rng(7 * n + c + s.m)
    lbas = rng.integers(0, 2**63, (s.k, c), dtype=np.int64).astype(np.uint64)
    ts = rng.integers(0, 2**63, (s.k, c), dtype=np.int64).astype(np.uint64)
    p_lba, p_ts = traid.parity_oob(t, lbas, ts)
    want = jraid.parity_oob(j, lbas, ts)
    assert np.array_equal(p_lba, want[0]) and np.array_equal(p_ts, want[1])
    code_l, code_t = np.concatenate([lbas, p_lba]), np.concatenate([ts, p_ts])
    for roles in itertools.combinations(range(s.n), s.k):
        sl = np.ascontiguousarray(code_l[list(roles)])
        st = np.ascontiguousarray(code_t[list(roles)])
        got = traid.decode_meta(t, sl, st, roles)
        ref = jraid.decode_meta(j, sl, st, roles)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
        assert np.array_equal(got[0], lbas) and np.array_equal(got[1], ts)
    assert vars(t.copy_stats) == vars(j.copy_stats)


@pytest.mark.parametrize("scheme", ["raid5", "raid6"])
def test_staging_grows_and_results_are_fresh(scheme):
    """Stripes of growing and shrinking width reuse and grow the staging
    buffers; no result aliases them or another result."""
    j, t = _codecs(scheme, 5)
    rng = np.random.default_rng(11)
    outs = []
    for nbytes in (20, 4096, 12, 16388, 20):
        data = rng.integers(0, 256, (t.scheme.k, nbytes), dtype=np.uint8)
        got = t.encode_np(data)
        assert np.array_equal(got, j.encode_np(data))
        assert not np.shares_memory(got, t._in) and not np.shares_memory(got, t._out)
        outs.append((got, got.copy()))
    assert t._in.size >= t.scheme.k * 4100  # grew to the widest stripe (16388 B)
    for got, keep in outs:  # later calls wrote nothing into earlier results
        assert np.array_equal(got, keep)
    assert vars(t.copy_stats) == vars(j.copy_stats)


def test_cuda_codec_raises_where_the_card_cannot_map_host_memory(monkeypatch):
    """The per-stripe path asks the device once whether it can map pinned
    host memory and raises where it cannot: there is no path that falls
    back to copies."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "can_map_host_memory", lambda: False)
    monkeypatch.setattr(_build, "_host_mapping_checked", False)
    codec = traid.StripeCodec(traid.make_scheme("raid6", 4), device="cuda")
    data = np.zeros((2, 64), np.uint8)
    with pytest.raises(RuntimeError, match="cannot map pinned host memory"):
        codec.encode_np(data)
    with pytest.raises(RuntimeError, match="cannot map pinned host memory"):
        codec.decode_np(data, (2, 3))
