"""Trace replay on the PyTorch/CUDA port's discrete-event timed engine.

``examples/trace_replay.py`` on ``repro_torch``: a small embedded
MSR-Cambridge-style trace replayed through the timed ZapRAID pipeline
(virtual clock, per-zone device queues, real group barriers), then a bursty
multi-tenant mix and a degraded-read scenario, with their p50/p99 latency
figures.  The figures are virtual time of the device model; the array's
stripe codec runs on ``--device`` (``cuda`` by default, or ``cpu``) and
gives the same figures on either.

Run: PYTHONPATH=src python examples/port_trace_replay.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.array import ZapRaidConfig
from repro_torch.core.handlers import HandlerPipeline
from repro_torch.core.zns import ZnsConfig, drive_images
from repro_torch.sim import TenantSpec, multi_tenant, parse_msr_trace

BLOCK = 512

# A miniature MSR-format trace: Timestamp(100ns),Host,Disk,Type,Offset,Size,RT
TRACE = "\n".join(
    f"12816637200{3061629 + i * 400},src1,0,"
    f"{'Write' if i % 4 else 'Read'},{(i * 7 % 96) * BLOCK},{BLOCK * (1 + i % 2)},0"
    for i in range(200)
)


def build_pipeline(device, seed=0):
    cfg = ZapRaidConfig(scheme="raid5", n_drives=4, group_size=8,
                        chunk_blocks=1, logical_blocks=128,
                        gc_free_segments_low=1, device=device)
    zns = ZnsConfig(n_zones=12, zone_cap_blocks=64, block_bytes=BLOCK)
    pipe = HandlerPipeline.build_timed(cfg, zns, seed=seed)
    rng = np.random.default_rng(seed)
    pipe.precondition(
        (lba, rng.integers(0, 256, (1, BLOCK), dtype=np.uint8))
        for lba in range(128)
    )
    return pipe


def show(tag, rec) -> dict:
    out = {}
    for op, name in (("W", "write"), ("R", "read")):
        p = rec.percentiles(op=op)
        if p.get("n"):
            out[name] = p
            print(f"  {tag} {name}: n={p['n']} p50={p['p50']:.1f}us "
                  f"p99={p['p99']:.1f}us p999={p['p999']:.1f}us")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = {}

    # 1. replay the trace
    reqs = parse_msr_trace(TRACE, block_bytes=BLOCK, logical_blocks=128)
    print(f"parsed {len(reqs)} trace requests spanning "
          f"{reqs[-1].t_us / 1e3:.1f} ms of virtual time")
    rec = build_pipeline(args.device, seed=1).replay(reqs)
    out["trace"] = show("trace", rec)
    out["stage_means"] = rec.stage_means()
    print(f"  stage means: {({k: round(v, 1) for k, v in rec.stage_means().items()})}")

    # 2. bursty multi-tenant mix: who pays for the noisy neighbour?
    mix = multi_tenant([
        TenantSpec(name="bursty-writer", kind="hotspot", n_ops=400,
                   rate_iops=30_000, burst_factor=3.0, seed=5),
        TenantSpec(name="steady-reader", kind="uniform", n_ops=400,
                   rate_iops=15_000, read_frac=1.0, seed=6),
    ], logical_blocks=128)
    rec = build_pipeline(args.device, seed=2).replay(mix)
    for tenant in ("bursty-writer", "steady-reader"):
        op = "R" if "reader" in tenant else "W"
        p = out[tenant] = rec.percentiles(op=op, tenant=tenant)
        print(f"  tenant {tenant}: p50={p['p50']:.1f}us p99={p['p99']:.1f}us")

    # 3. degraded reads under load: fail a drive, replay the same read storm
    load = multi_tenant([
        TenantSpec(name="reader", kind="uniform", n_ops=500,
                   rate_iops=80_000, read_frac=1.0, seed=7),
    ], logical_blocks=128)
    healthy = build_pipeline(args.device, seed=3).replay(load).percentiles(op="R")
    pipe = build_pipeline(args.device, seed=3)
    pipe.array.fail_drive(1)
    degraded = pipe.replay(load).percentiles(op="R")
    print(f"  healthy  read p99: {healthy['p99']:.1f}us")
    print(f"  degraded read p99: {degraded['p99']:.1f}us "
          f"({degraded['p99'] / healthy['p99']:.2f}x, "
          f"{pipe.array.stats.degraded_reads} degraded decodes)")
    out.update(healthy=healthy, degraded=degraded,
               degraded_decodes=pipe.array.stats.degraded_reads,
               media=drive_images(pipe.array.drives))
    return out


if __name__ == "__main__":
    main()
