"""Always-writable degraded array on the PyTorch/CUDA port: survivor-width
stripes end to end.

``examples/degraded_writes.py`` on ``repro_torch``:

1. build a timed (3+1) RAID-5 ZapRAID pipeline and replay a uniform write
   stream on the healthy array -- full-width stripe groups;
2. fail a drive mid-stream via the fault-injection harness
   (``repro_torch.sim.faults``): writes never stall -- new stripe groups
   open at survivor width (2 data + 1 parity on the three healthy drives);
3. schedule a paced replace-and-rebuild on the virtual clock: the rebuild
   reconstructs the failed member, then the re-widening pass relocates
   every survivor-width group back onto the full drive set;
4. replay the stream once more and compare write p50/p99 across the three
   states, then verify all data survived the round trip.

The figures are virtual time; the array's stripe codec runs on ``--device``
(``cuda`` by default, or ``cpu``).

Run: PYTHONPATH=src python examples/port_degraded_writes.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.core.array import ZapRaidConfig
from repro_torch.core.handlers import HandlerPipeline
from repro_torch.core.zns import ZnsConfig, drive_images
from repro_torch.sim import LatencyRecorder, TenantSpec, multi_tenant
from repro_torch.sim.faults import FaultEvent, FaultPlan


def build_pipe(device: str, seed: int = 11):
    cfg = ZapRaidConfig(scheme="raid5", n_drives=4, group_size=8,
                        chunk_blocks=1, logical_blocks=192,
                        gc_free_segments_low=1, device=device)
    zns = ZnsConfig(n_zones=16, zone_cap_blocks=64, block_bytes=256)
    return HandlerPipeline.build_timed(cfg, zns, seed=seed,
                                       flush_interval_us=200.0)


def write_stream(n_ops: int):
    return multi_tenant([
        TenantSpec(name="writer", kind="uniform", n_ops=n_ops,
                   rate_iops=50_000, read_frac=0.0, seed=23),
    ], logical_blocks=192)


def replay_now(pipe, load, ref):
    """Replay `load` re-based onto the current virtual clock, mirroring
    payloads into `ref` so the final verify can check the media."""
    t0 = pipe.engine.now
    shifted = [dataclasses.replace(r, t_us=r.t_us + t0) for r in load]
    rng = np.random.default_rng(0xFEED)

    def payload(r):
        data = rng.integers(0, 256, (r.n_blocks, 256), dtype=np.uint8)
        ref[r.lba:r.lba + r.n_blocks] = data
        return data

    pipe.recorder = LatencyRecorder()
    rec = pipe.replay(shifted, payload_fn=payload)
    return rec.percentiles(op="W")


def narrow_segments(arr) -> int:
    return sum(1 for r in arr.segments.values()
               if len(r.info.drive_ids) < arr.cfg.n_drives)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    pipe = build_pipe(args.device)
    arr = pipe.array
    load = write_stream(240)
    ref = np.zeros((192, 256), dtype=np.uint8)

    print("always-writable degraded array (virtual-time figures):")

    healthy = replay_now(pipe, load, ref)
    print(f"  healthy   p50={healthy['p50']:7.1f}us  "
          f"p99={healthy['p99']:7.1f}us  (full-width groups)")

    # drive 1 dies on the virtual clock; the array stays writable
    pipe.attach_faults(FaultPlan.scripted(
        [FaultEvent(t_us=pipe.engine.now + 5.0, kind="fail", drive=1)]))
    degraded = replay_now(pipe, load, ref)
    narrow = narrow_segments(arr)
    print(f"  degraded  p50={degraded['p50']:7.1f}us  "
          f"p99={degraded['p99']:7.1f}us  "
          f"(survivor-width groups: {narrow} narrow, "
          f"degraded_mode="
          f"{int(any(d.failed for d in arr.drives))})")

    # paced replace-and-rebuild + re-widening pass
    pipe.schedule_rebuild(1, at=pipe.engine.now + 10.0, interval_us=20.0)
    pipe.drain()
    print(f"  rebuild   re-widened {narrow} survivor-width groups "
          f"({narrow_segments(arr)} remain), drive 1 back in rotation")

    rebuilt = replay_now(pipe, load, ref)
    print(f"  rebuilt   p50={rebuilt['p50']:7.1f}us  "
          f"p99={rebuilt['p99']:7.1f}us  "
          f"({rebuilt['p99'] / max(healthy['p99'], 1e-9):.2f}x healthy p99)")

    got = arr.read(0, 192)
    assert np.array_equal(got, ref), "data lost across fail/rebuild!"
    print("  verify    all 192 logical blocks intact across "
          "fail -> degraded writes -> rebuild")
    return {"healthy": healthy, "degraded": degraded, "rebuilt": rebuilt,
            "narrow_groups": narrow, "media": drive_images(arr.drives)}


if __name__ == "__main__":
    main()
