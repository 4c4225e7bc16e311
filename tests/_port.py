"""Shared helpers for the port's parity tests: one configuration built in both
packages (the JAX reference and ``repro_torch`` on the CPU), seeded workloads
made with numpy, and a whole-state comparison."""
import dataclasses

import numpy as np

from repro.core import array as jarray
from repro.core import zns as jzns
from repro_torch.core import array as tarray
from repro_torch.core import zns as tzns
from repro_torch.core.zns import drive_images

BB = 256  # block bytes: small, a multiple of 4 (int32 lanes)
LOGICAL = 256


def configs(scheme="raid5", n_drives=4, *, hybrid=False, jax_kw=None, **kw):
    """(jax cfg, jax zns, port cfg, port zns) for one configuration: G=8,
    12 zones of 64 blocks per drive; ``jax_kw`` goes to the reference only."""
    if hybrid:
        kw = dict(hybrid=True, n_small=1, n_large=1, small_chunk_blocks=1,
                  large_chunk_blocks=4, **kw)
    common = dict(scheme=scheme, n_drives=n_drives, group_size=8,
                  chunk_blocks=1, logical_blocks=LOGICAL, gc_free_segments_low=1,
                  append_order="rng", **kw)
    jc = jarray.ZapRaidConfig(**common, **(jax_kw or {}))
    tc = tarray.ZapRaidConfig(**common, device="cpu")
    jz = jzns.ZnsConfig(n_zones=12, zone_cap_blocks=64, block_bytes=BB)
    tz = tzns.ZnsConfig(n_zones=12, zone_cap_blocks=64, block_bytes=BB)
    return jc, jz, tc, tz


def pair(*args, **kw):
    jc, jz, tc, tz = configs(*args, **kw)
    return jarray.ZapRAIDArray(jc, jz), tarray.ZapRAIDArray(tc, tz)


def workload(arr, seed=3, n_writes=150, large=False):
    """Seeded random writes of 1-3 blocks (and 4-8 with ``large``), then a
    flush.  Returns the logical image {lba: block}."""
    rng = np.random.default_rng(seed)
    ref = {}
    for _ in range(n_writes):
        n = int(rng.integers(4, 9)) if large and rng.random() < 0.3 \
            else int(rng.integers(1, 4))
        lba = int(rng.integers(0, LOGICAL - n))
        blk = rng.integers(0, 256, (n, BB), dtype=np.uint8)
        arr.write(lba, blk)
        for i in range(n):
            ref[lba + i] = blk[i].copy()
    arr.flush()
    return ref


def assert_same_state(a, b):
    """Drive media/OOB/CRC/UNC/write pointers/zone states and counters, L2P,
    per-segment validity and Stats are all equal."""
    for ia, ib in zip(drive_images(a.drives), drive_images(b.drives), strict=True):
        for key in ia:
            assert np.array_equal(ia[key], ib[key]), key
    lbas = np.arange(a.cfg.logical_blocks)
    assert np.array_equal(a.l2p.get_many(lbas), b.l2p.get_many(lbas))
    assert sorted(a.segments) == sorted(b.segments)
    for sid, ra in a.segments.items():
        rb = b.segments[sid]
        assert np.array_equal(ra.valid, rb.valid), sid
        assert ra.valid_count == rb.valid_count, sid
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


def read_all_equal(a, b):
    got = b.read(0, LOGICAL)
    assert np.array_equal(got, a.read(0, LOGICAL))
    return got


def lifecycle_identical(scheme, n, hybrid):
    """Write, read, degraded reads with each drive failed in turn, a real
    failure with survivor-width writes, rebuild and GC: state equal after
    every step."""
    a, b = pair(scheme, n, hybrid=hybrid)
    ref = workload(a, large=hybrid)
    workload(b, large=hybrid)
    assert_same_state(a, b)
    got = read_all_equal(a, b)
    for lba, blk in ref.items():
        assert np.array_equal(got[lba], blk)
    # degraded reads with each drive failed in turn (scalar and batched)
    some = sorted(ref)[::7]
    for d in range(n):
        a.drives[d].failed = b.drives[d].failed = True
        read_all_equal(a, b)
        for lba in some:
            assert np.array_equal(b.read(lba, 1), a.read(lba, 1))
        a.drives[d].failed = b.drives[d].failed = False
    assert_same_state(a, b)
    # a real failure: writes at survivor width, rebuild, re-widen, then GC
    for arr in (a, b):
        arr.fail_drive(1)
        workload(arr, seed=5, n_writes=40, large=hybrid)
    assert_same_state(a, b)
    read_all_equal(a, b)
    for arr in (a, b):
        arr.rebuild_drive(1)
    assert_same_state(a, b)
    assert a.gc_once() == b.gc_once()
    assert_same_state(a, b)
    read_all_equal(a, b)
