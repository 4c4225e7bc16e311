"""The port's ZapRAID array against the JAX package's, on the same workload.

The same seeded workload runs through ``repro.core.array.ZapRAIDArray`` and
``repro_torch.core.array.ZapRAIDArray(device="cpu")``; after every step the
drive images (media, OOB, CRC, UNC, write pointers, zone states, counters),
L2P, per-segment validity and ``Stats`` must be equal, and so must every read.
Covered: single-class G=8 and hybrid, RAID-4/5/01 through each drive failed
in turn, survivor-width writes, rebuild and GC, and RAID-0 without failures.
RAID-6, verify-on-read and a reference on the Pallas kernels are in
``test_torch_array_raid6.py``.
"""
import pytest

from _port import assert_same_state, lifecycle_identical, pair, read_all_equal, workload

CASES = [("raid4", 4, False), ("raid5", 4, False), ("raid01", 4, False),
         ("raid5", 4, True)]


@pytest.mark.parametrize("scheme,n,hybrid", CASES)
def test_array_lifecycle_identical(scheme, n, hybrid):
    lifecycle_identical(scheme, n, hybrid)


def test_raid0_identical_without_failures():
    a, b = pair("raid0", 4)
    workload(a)
    workload(b)
    assert_same_state(a, b)
    read_all_equal(a, b)
    assert a.gc_once() == b.gc_once()
    assert_same_state(a, b)
