"""Warm-cache degraded reads on the PyTorch/CUDA port: the ZNS cache tier
end to end.

``examples/warm_cache_degraded.py`` on ``repro_torch``: what a read cache
buys a log-structured RAID array when a drive dies.  A timed ZapRAID
pipeline with the device-resident ``ZnsCacheTier`` (zone-structured arena,
count-min admission, zone-granular CLOCK eviction) serves a hotspot read
stream with one drive down, once cold and once warmed outside the measured
timeline; cold, every read on the failed drive fans out into k survivor
reads and queues; warm, the hot set is absorbed at cache latency.  The
figures are virtual time; the array's stripe codec runs on ``--device``
(``cuda`` by default, or ``cpu``).

Run: PYTHONPATH=src python examples/port_warm_cache_degraded.py [--device cpu]
"""
import argparse

from repro_torch.service.scenario import degraded_read_cache


def show(row: dict) -> None:
    mode = "warm" if row["warm"] else "cold"
    print(f"  {mode:5s} p50={row['p50_us']:8.1f}us  p99={row['p99_us']:8.1f}us  "
          f"hit_rate={row['hit_rate']:.2f}  "
          f"queue_bypasses={row['cache_bypasses']}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    print("degraded reads, one drive down, hotspot stream "
          "(virtual-time figures):")
    cold = degraded_read_cache(warm=False, device=args.device)
    warm = degraded_read_cache(warm=True, device=args.device)
    show(cold)
    show(warm)
    print(f"  warm cache cuts degraded p99 "
          f"{cold['p99_us'] / warm['p99_us']:.1f}x "
          f"(p50 {cold['p50_us'] / warm['p50_us']:.1f}x)")
    return {"cold": cold, "warm": warm}


if __name__ == "__main__":
    main()
