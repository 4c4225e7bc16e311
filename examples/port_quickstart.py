"""Quickstart on the PyTorch/CUDA port: a ZapRAID array in 40 lines.

``examples/quickstart.py`` on ``repro_torch``: a (3+1) RAID-5 array over
four simulated ZNS drives with the group-based Zone-Append layout, a few
blocks written, a drive failed, everything read back through degraded
decoding, and the drive rebuilt.  The stripe codec runs on ``--device``:
its CUDA kernels on ``cuda`` (the default), their plain versions on
``cpu``.

Run: PYTHONPATH=src python examples/port_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.array import ZapRaidConfig, ZapRAIDArray
from repro_torch.core.zns import ZnsConfig, drive_images


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = ZapRaidConfig(
        scheme="raid5", n_drives=4,
        group_size=16,        # G: stripes per Zone-Append group (paper 3.2)
        chunk_blocks=1, logical_blocks=512, gc_free_segments_low=1,
        device=args.device,   # the parity kernels' device
    )
    zns = ZnsConfig(n_zones=16, zone_cap_blocks=128, block_bytes=4096)
    arr = ZapRAIDArray(cfg, zns)

    rng = np.random.default_rng(0)
    blocks = {lba: rng.integers(0, 256, (1, 4096), dtype=np.uint8) for lba in range(64)}
    for lba, blk in blocks.items():
        arr.write(lba, blk)
    arr.flush()
    print(f"wrote 64 blocks; write amplification = {arr.stats.write_amp():.2f}")

    seg = next(iter(arr.segments.values()))
    cst = seg.cst.table[:, :8]
    print(f"CST for segment 0 (first group, per drive):\n{cst}")

    arr.fail_drive(2)
    ok = all(np.array_equal(arr.read(l, 1)[0], b[0]) for l, b in blocks.items())
    print(f"drive 2 failed -> all reads still correct: {ok} "
          f"(degraded reads: {arr.stats.degraded_reads}, "
          f"CST entries touched: {arr.stats.cst_entries_accessed})")

    arr.rebuild_drive(2)
    print("drive 2 rebuilt from survivors (full-drive recovery, paper 3.5)")
    return {"write_amp": arr.stats.write_amp(), "cst": cst.tolist(), "reads_correct": ok,
            "degraded_reads": arr.stats.degraded_reads,
            "cst_entries_accessed": arr.stats.cst_entries_accessed,
            "media": drive_images(arr.drives)}


if __name__ == "__main__":
    main()
