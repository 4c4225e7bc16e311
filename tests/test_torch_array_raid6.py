"""The port's ZapRAID array against the JAX package's: RAID-6, verify-on-read
and a reference running its Pallas kernels (see ``test_torch_array.py``)."""
import numpy as np
import pytest

from _port import assert_same_state, lifecycle_identical, pair, read_all_equal, workload
from repro_torch.core.l2p import unpack_pba


@pytest.mark.parametrize("n,hybrid", [(5, False), (4, True)])
def test_raid6_lifecycle_identical(n, hybrid):
    lifecycle_identical("raid6", n, hybrid)


@pytest.mark.parametrize("scheme,n", [("raid5", 4), ("raid6", 5)])
def test_verify_reads_repairs_one_corrupted_block(scheme, n):
    a, b = pair(scheme, n, verify_reads=True)
    ref = workload(a)
    workload(b)
    lba = sorted(ref)[10]
    for arr in (a, b):  # flip one bit of one block's media on both arrays
        seg_id, member, off = unpack_pba(int(arr.l2p.get(lba)))
        info = arr.segments[seg_id].info
        drv = arr.drives[info.drive_ids[member]]
        drv.corrupt_bit_rot(info.zone_ids[member], off, byte=3, bit=5)
    got = read_all_equal(a, b)
    assert np.array_equal(got[lba], ref[lba])
    assert b.stats.integrity_corruptions_detected == 1
    assert b.stats.integrity_blocks_repaired == 1
    assert_same_state(a, b)


def test_reference_on_pallas_kernels_identical():
    """The JAX side runs its Pallas kernels (interpret mode)."""
    a, b = pair("raid6", 5, jax_kw=dict(use_pallas=True, interpret=True))
    workload(a, n_writes=60)
    workload(b, n_writes=60)
    assert_same_state(a, b)
    a.drives[2].failed = b.drives[2].failed = True
    read_all_equal(a, b)
