"""End-to-end data integrity on the PyTorch/CUDA port: silent corruption,
scrub, self-repair.

``examples/scrub_repair.py`` on ``repro_torch``, the integrity layer on the
timed pipeline:

1. build a timed RAID-6 ZapRAID pipeline with ``verify_reads`` on and a
   ``MetricsSampler`` recording the stock metric catalog (with the
   ``integrity/*`` counters) every 100 virtual µs;
2. attach a probabilistic fault plan that fires a weighted media-fault mix
   -- bit rot, torn writes, misdirected writes, unreadable sectors -- into
   the drives while a write stream is in flight;
3. arm the paced scrub actor (``HandlerPipeline.schedule_scrub``): it walks
   sealed segments on the virtual clock, verifies every block against the
   per-block CRC32C lane, rebuilds bad blocks through parity (or
   regenerates headers and footers from provenance) and rewrites them in
   place, yielding whenever foreground I/O is queued;
4. drain, run one final scrub pass, and check that every logical read
   returns the reference bytes;
5. export ``out/port_scrub_metrics.json`` (schema-validated by the port's
   checker) whose final row carries nonzero ``integrity/blocks_repaired``.

The figures are virtual time; the array's stripe codec runs on ``--device``
(``cuda`` by default, or ``cpu``).  ``--out`` names the output directory.

Run: PYTHONPATH=src python examples/port_scrub_repair.py [--device cpu]
"""
import argparse
import json
import os

import numpy as np

from repro_torch.core.array import ZapRaidConfig
from repro_torch.core.handlers import HandlerPipeline
from repro_torch.core.zns import ZnsConfig, drive_images
from repro_torch.obs import (MetricsRegistry, MetricsSampler, standard_collector,
                             validate_metrics_series)
from repro_torch.sim.faults import FaultPlan

BB = 256
OUT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "out"))


def _pipe(device: str, seed: int = 0) -> HandlerPipeline:
    # raid6: the fault mix is hot enough that one stripe can take two
    # hits before the scrub reaches it -- m=2 keeps that repairable
    cfg = ZapRaidConfig(scheme="raid6", n_drives=5, group_size=4,
                        chunk_blocks=1, logical_blocks=128,
                        gc_free_segments_low=1, verify_reads=True, device=device)
    zns = ZnsConfig(n_zones=10, zone_cap_blocks=64, block_bytes=BB)
    return HandlerPipeline.build_timed(cfg, zns, seed=seed,
                                       flush_interval_us=200.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    pipe = _pipe(args.device)
    reg = MetricsRegistry()
    sampler = MetricsSampler(pipe.engine, reg, standard_collector(pipe),
                             interval_us=100.0)
    sampler.start(0.0)

    # weighted media-fault mix, Poisson arrivals on the virtual clock
    plan = FaultPlan.probabilistic(
        n_drives=5, horizon_us=4_000.0, seed=11,
        media_mix={"bit_rot": 3.0, "torn_write": 1.0,
                   "misdirected_write": 1.0, "unreadable": 2.0},
        media_mtbf_us=200.0,
    )
    inj = pipe.attach_faults(plan, seed=3)

    # write stream: several overwrite rounds so segments seal under load
    rng = np.random.default_rng(7)
    ref = {}
    t = 0.0
    for _ in range(4):
        for lba in range(0, 128, 2):
            blk = rng.integers(0, 256, (2, BB), dtype=np.uint8)
            pipe.submit_write(lba, blk, at=t)
            ref[lba], ref[lba + 1] = blk[0].copy(), blk[1].copy()
            t += 8.0

    # paced scrub actor starts mid-stream and yields to foreground I/O
    pipe.schedule_scrub(at=1_000.0, interval_us=50.0, n_passes=3)
    pipe.drain()
    # one closing pass picks up faults that landed after the actor's last
    # walk (the plan keeps firing until its horizon)
    totals = pipe.array.scrub_once()
    sampler.sample_once()

    arr = pipe.array
    st = arr.stats
    injected = sum(d.media_faults for d in arr.drives)
    kinds = sorted({k for _, k, _ in inj.log})
    scrub_us = pipe.recorder.notes.get("scrub_device_us", 0.0)
    print("paced scrub under a live write stream (virtual-time run):")
    print(f"  media faults injected : {injected:4d}  kinds={kinds}")
    print(f"  scrub passes          : {st.integrity_scrub_passes:4d}  "
          f"(blocks verified {st.integrity_scrub_blocks})")
    print(f"  corruptions detected  : "
          f"{st.integrity_corruptions_detected:4d}  "
          f"(+{st.integrity_unreadable_hits} unreadable)")
    print(f"  blocks repaired       : {st.integrity_blocks_repaired:4d}"
          f"  (final pass: {totals['repaired']})")
    print(f"  scrub device time     : "
          f"{scrub_us:8.1f}us "
          f"(foreground writes kept priority)")

    assert st.integrity_blocks_repaired > 0, "demo needs repairs"
    bad = [lba for lba, want in ref.items()
           if not np.array_equal(arr.read(lba, 1)[0], want)]
    assert not bad, f"wrong bytes after scrub: lbas {bad}"
    print(f"  all {len(ref)} logical blocks read back bit-exact -- "
          f"no reader ever saw corrupt data")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "port_scrub_metrics.json")
    sampler.to_json(path)
    with open(path) as f:
        doc = json.load(f)
    validate_metrics_series(doc)
    last = doc["series"][-1]["counters"]
    assert last.get("integrity/blocks_repaired", 0) > 0
    print(f"\n  wrote {path} ({len(doc['series'])} samples, "
          f"schema-validated; final integrity/blocks_repaired="
          f"{last['integrity/blocks_repaired']:.0f})")
    return {"injected": injected, "kinds": kinds, "scrub_passes": st.integrity_scrub_passes,
            "blocks_verified": st.integrity_scrub_blocks,
            "corruptions": st.integrity_corruptions_detected,
            "unreadable": st.integrity_unreadable_hits,
            "repaired": st.integrity_blocks_repaired, "final_pass": totals,
            "scrub_device_us": scrub_us, "samples": len(doc["series"]),
            "final_counters": last, "media": drive_images(arr.drives)}


if __name__ == "__main__":
    main()
