"""Crash recovery in the port against the JAX package's.

A crash is armed mid-group (``arm_crash``) and the workload runs on until the
device stops persisting.  Two ways across: the JAX array's crashed drives are
carried into the port (``drive_images`` -> ``drives_from_numpy``) and both
packages recover the same image; and the port crashes on its own.  Either
way the recovered drive images, L2P, validity, Stats and every read must be
equal to the reference's, and every acknowledged block must read back.
"""
import numpy as np
import pytest

from _port import BB, LOGICAL, assert_same_state, configs, read_all_equal
from repro.core import array as jarray
from repro.core import recovery as jrecovery
from repro.core import zns as jzns
from repro_torch.core import array as tarray
from repro_torch.core import recovery as trecovery
from repro_torch.core.zns import DeviceCrashed, drive_images, drives_from_numpy

CASES = [("raid5", 4, False), ("raid6", 5, False), ("raid5", 4, True)]


def crash_workload(arr, seed=11, arm_at=60, budget=13, large=False):
    """Acknowledged writes (write + flush) up to ``arm_at``, then a crash
    armed ``budget`` block commits ahead and unflushed writes until it
    bites.  Returns the acknowledged image {lba: block}."""
    rng = np.random.default_rng(seed)
    acked = {}
    for i in range(400):
        n = int(rng.integers(4, 9)) if large and rng.random() < 0.3 \
            else int(rng.integers(1, 4))
        lba = int(rng.integers(0, LOGICAL - n))
        blk = rng.integers(0, 256, (n, BB), dtype=np.uint8)
        if i == arm_at:
            arr.flush()
            arr.arm_crash(budget)
        for j in range(n):  # an unacknowledged overwrite may or may not land
            acked.pop(lba + j, None)
        try:
            arr.write(lba, blk)
        except (DeviceCrashed, jzns.DeviceCrashed):
            break
        if i < arm_at:
            for j in range(n):
                acked[lba + j] = blk[j].copy()
    else:
        raise AssertionError("the armed crash never happened")
    return acked


def _check_recovered(ra, rb, acked):
    assert_same_state(ra, rb)
    got = read_all_equal(ra, rb)
    for lba, blk in acked.items():
        assert np.array_equal(got[lba], blk), lba


@pytest.mark.parametrize("scheme,n,hybrid", CASES)
def test_recover_drives_written_by_reference(scheme, n, hybrid):
    jc, jz, tc, tz = configs(scheme, n, hybrid=hybrid)
    a = jarray.ZapRAIDArray(jc, jz)
    acked = crash_workload(a, large=hybrid)
    carried = drives_from_numpy(drive_images(a.drives), tz)
    ra = jrecovery.recover_array(a.drives, jc, jz)
    rb = trecovery.recover_array(carried, tc, tz)
    _check_recovered(ra, rb, acked)
    # both stay writable, identically
    blk = np.full((2, BB), 7, np.uint8)
    for arr in (ra, rb):
        arr.write(5, blk)
        arr.flush()
    assert_same_state(ra, rb)


@pytest.mark.parametrize("scheme,n,hybrid", CASES)
def test_port_crash_and_recovery_match_reference(scheme, n, hybrid):
    jc, jz, tc, tz = configs(scheme, n, hybrid=hybrid)
    a, b = jarray.ZapRAIDArray(jc, jz), tarray.ZapRAIDArray(tc, tz)
    acked = crash_workload(a, seed=17, budget=21, large=hybrid)
    assert crash_workload(b, seed=17, budget=21, large=hybrid).keys() == acked.keys()
    for ia, ib in zip(drive_images(a.drives), drive_images(b.drives)):
        for key in ia:
            assert np.array_equal(ia[key], ib[key]), key
    ra = jrecovery.recover_array(a.drives, jc, jz)
    rb = trecovery.recover_array(b.drives, tc, tz)
    _check_recovered(ra, rb, acked)


def test_drive_images_round_trip():
    _, _, tc, tz = configs("raid5", 4)
    arr = tarray.ZapRAIDArray(tc, tz)
    arr.write(0, np.arange(3 * BB, dtype=np.uint8).reshape(3, BB) % 251)
    arr.flush()
    arr.drives[2].fail()
    imgs = drive_images(arr.drives)
    back = drives_from_numpy(imgs, tz)
    for ia, ib in zip(imgs, drive_images(back)):
        for key in ia:
            assert np.array_equal(ia[key], ib[key]), key
    assert back[2].failed and all(d.budget is back[0].budget for d in back)
    imgs[0]["wp"] = imgs[0]["wp"][:-1]
    with pytest.raises(ValueError):
        drives_from_numpy(imgs, tz)
