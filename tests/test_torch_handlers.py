"""The port's timed pipeline (``core/handlers`` over ``sim``) against the JAX
package's, scenario by scenario.

Each scenario is written once over a package namespace and run through the
reference (its default numpy codec path) and through the port on the CPU,
from the same seeds.  Everything the run produces must be equal: the latency
samples and their percentiles, stage sums and counts, notes and note counts
(of ``encode_sync_us``, the host wall time of the group encodes, only the
count), the stage counters, the virtual clock, the events fired, the drives'
bookings and images, L2P, validity and ``Stats``.  The scenarios are the
reference's timed benchmarks at their own geometry: Exp#10's trace replay and
the QoS rows (``benchmarks/run.py``), degraded writes
(``benchmarks/bench_degraded_write.py``), scrub and the repair storm
(``benchmarks/bench_scrub.py``), plus fault injection, the GC actor, and a
crash armed inside GC and inside a paced rebuild, recovered in each package.
The scenarios run at the sizes of the reference's ``--quick`` run, so the
port's outputs are also held to the rows it committed in ``BENCH_PR10.json``
(rounded to 0.01 µs, as written there).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _port import (
    BB,
    JAX,
    PORT,
    assert_same_state,
    assert_same_timed,
    configs,
    shift,
    timed_pair,
)
from repro_torch.core.array import ZapRaidConfig
from repro_torch.core.handlers import HandlerPipeline
from repro_torch.core.zns import ZnsConfig


_BENCH = json.loads(
    (Path(__file__).resolve().parents[1] / "BENCH_PR10.json").read_text())


def bench(name):
    """A reference row of ``BENCH_PR10.json``: (us_per_call, derived)."""
    return _BENCH[name]["us_per_call"], _BENCH[name]["derived"]


def _both(scenario, *args, **kw):
    """Run ``scenario(pkg, pipe, ...)`` on a (reference, port) pipeline pair
    built by ``timed_pair(**kw)``; returns both results."""
    pa, pb = timed_pair(*args, **kw)
    return (pa, scenario(JAX, pa)), (pb, scenario(PORT, pb))


# ------------------------------------------------------------ Exp#10 replay

EXP10_OPS = 400


def _exp10(pkg):
    """``benchmarks/run.py`` bench_trace: RAID-5 hybrid (3+1), G=8, 20 zones
    of 64 blocks of 256 bytes, 400 open-loop requests of 1-3 blocks, 85%
    writes, ~25 k IOPS."""
    rng = np.random.default_rng(5)
    cfg = pkg.array.ZapRaidConfig(
        scheme="raid5", n_drives=4, hybrid=True, n_small=1, n_large=3,
        group_size=8, small_chunk_blocks=1, large_chunk_blocks=2,
        logical_blocks=256, gc_free_segments_low=1,
        **({"device": "cpu"} if pkg is PORT else {}))
    zns = pkg.zns.ZnsConfig(n_zones=20, zone_cap_blocks=64, block_bytes=256)
    pipe = pkg.handlers.HandlerPipeline.build_timed(cfg, zns, seed=5)
    pipe.precondition((lba, rng.integers(0, 256, (1, 256), dtype=np.uint8))
                      for lba in range(256))
    reqs, t = [], 0.0
    for _ in range(EXP10_OPS):
        t += float(rng.exponential(40.0))
        r = rng.random()
        n = 1 if r < 0.60 else (2 if r < 0.75 else 3)
        lba = int(rng.integers(0, 256 - n))
        op = "W" if rng.random() < 0.85 else "R"
        reqs.append(pkg.sim.Request(t, "trace", op, lba, n))
    rec = pipe.replay(reqs)
    return pipe, rec


def test_exp10_trace_replay_matches_reference():
    pa, ra = _exp10(JAX)
    pb, rb = _exp10(PORT)
    assert_same_timed(pa, pb)
    assert ra.throughput_mib_s(256) == rb.throughput_mib_s(256)
    assert rb.note_counts["encode_sync_us"] > 0
    w, r = rb.percentiles(op="W"), rb.percentiles(op="R")
    assert bench("exp10/trace_timed/write_p50") == (
        round(w["p50"], 2), f"p99={w['p99']:.1f}us_p999={w['p999']:.1f}us_n={w['n']}")
    assert bench("exp10/trace_timed/read_p50") == (
        round(r["p50"], 2), f"p99={r['p99']:.1f}us_p999={r['p999']:.1f}us_n={r['n']}")
    assert bench("exp10/trace_timed_tput") == (
        round(rb.span_us() / EXP10_OPS, 2), f"{rb.throughput_mib_s(256):.1f}MiB/s_sim")


# -------------------------------------------------------------- QoS rows

def _read_load(pkg):
    T = pkg.sim.TenantSpec
    return pkg.sim.multi_tenant([
        T(name="scanner", kind="seq", n_ops=300, rate_iops=60_000,
          read_frac=1.0, seed=31),
        T(name="reader", kind="uniform", n_ops=300, rate_iops=30_000,
          read_frac=1.0, seed=32),
    ], logical_blocks=256)


@pytest.mark.parametrize("which", ["mixed", "healthy", "degraded", "rebuild"])
def test_qos_scenario_matches_reference(which):
    """``benchmarks/run.py`` bench_latency_qos on RAID-5 (3+1), G=8, 16
    zones: a bursty hotspot writer beside a uniform reader, and the read
    load healthy, with drive 1 failed, and with its rebuild running."""
    def run(pkg, pipe):
        T = pkg.sim.TenantSpec
        if which == "mixed":
            pipe.replay(pkg.sim.multi_tenant([
                T(name="writer", kind="hotspot", n_ops=300, rate_iops=80_000,
                  burst_factor=3.0, seed=21),
                T(name="reader", kind="uniform", n_ops=300, rate_iops=12_000,
                  read_frac=1.0, seed=22),
            ], logical_blocks=256))
            return
        if which != "healthy":
            pipe.array.fail_drive(1)
        if which == "rebuild":
            pipe.schedule_rebuild(1, at=50.0)
        pipe.replay(_read_load(pkg))

    (pa, _), (pb, _) = _both(run, seed=11, zones=16)
    assert_same_timed(pa, pb)
    rec = pb.recorder
    if which == "mixed":
        for tenant, op in (("writer", "W"), ("reader", "R")):
            p = rec.percentiles(op=op, tenant=tenant)
            assert bench(f"qos/tenant_{tenant}_p99") == (
                round(p["p99"], 2), f"n={p['n']}_p50={p['p50']:.1f}us")
        barrier = (f"total={rec.notes['group_barrier_wait_us']:.0f}us_groups="
                   f"{rec.note_counts['group_barrier_wait_us']}")
        assert bench("qos/group_barrier_wait")[1] == barrier  # barriers bind
        return
    p = rec.percentiles(op="R")
    assert p["n"] == 600
    if which == "rebuild":
        assert bench("qos/rebuild_read_p50") == (
            round(p["p50"], 2),
            f"p99={p['p99']:.1f}us_rebuild_busy={rec.notes['rebuild_device_us']:.0f}us")
    else:
        assert bench(f"qos/{which}_read_p50") == (
            round(p["p50"], 2), f"p99={p['p99']:.1f}us_p999={p['p999']:.1f}us")


# ---------------------------------------------------------- degraded writes

def _write_load(pkg, n_ops):
    return pkg.sim.multi_tenant([pkg.sim.TenantSpec(
        name="writer", kind="uniform", n_ops=n_ops, rate_iops=50_000,
        read_frac=0.0, seed=71)], logical_blocks=256)


@pytest.mark.parametrize("stage", ["healthy", "degraded", "rebuilt"])
def test_degraded_write_rows_match_reference(stage):
    """``benchmarks/bench_degraded_write.py``: the same write load healthy,
    with one drive failed (survivor-width groups), and after a paced
    replace-and-rebuild with re-widening."""
    n_ops = 300

    def run(pkg, pipe):
        load = _write_load(pkg, n_ops)
        if stage == "healthy":
            pipe.replay(load)
            return None
        pipe.array.fail_drive(1)
        pipe.replay(shift(load, pipe.engine.now))
        if stage == "degraded":
            return None
        narrow = sum(1 for r in pipe.array.segments.values()
                     if len(r.info.drive_ids) < pipe.array.cfg.n_drives)
        before = pipe.recorder.notes.get("rebuild_device_us", 0.0)
        pipe.schedule_rebuild(1, at=pipe.engine.now + 10.0, interval_us=20.0)
        pipe.drain()
        rebuild_us = pipe.recorder.notes.get("rebuild_device_us", 0.0) - before
        pipe.recorder = pkg.sim.LatencyRecorder()
        pipe.replay(shift(load, pipe.engine.now))
        return narrow, rebuild_us

    (pa, a), (pb, b) = _both(run, seed=7, zones=16, flush_interval_us=200.0)
    assert_same_timed(pa, pb)
    assert a == b
    assert bench(f"degraded/write_p99_{stage}")[0] == \
        round(pb.recorder.percentiles(op="W")["p99"], 2)
    if stage == "rebuilt":
        narrow, rebuild_us = b  # survivor-width segments were re-widened
        assert bench("degraded/rewiden_rebuild_us")[0] == round(rebuild_us, 2)
        assert bench("degraded/rewiden_rebuild_us")[1].endswith(
            f"_narrow_segments_relocated={narrow}")


# --------------------------------------------------------------- integrity

def _corrupt_per_group(pkg, arr, rng) -> int:
    """``bench_scrub._corrupt_per_group``: one bit-rot hit per stripe group
    of every sealed segment, cycling the victim member."""
    n_bad = 0
    for rec in sorted(arr.segments.values(), key=lambda r: r.info.seg_id):
        info = rec.info
        if info.state != int(pkg.segment.SegmentState.SEALED):
            continue
        ds = info.data_start()
        span = max(1, info.group_size) * info.chunk_blocks
        for g in range(-(-info.n_stripes * info.chunk_blocks // span)):
            m = g % info.n_drives
            d = arr.drives[info.drive_ids[m]]
            zone = info.zone_ids[m]
            off = ds + g * span + int(rng.integers(0, span))
            if off >= int(d.wp[zone]):
                continue
            d.corrupt_bit_rot(zone, off, int(rng.integers(0, d.cfg.block_bytes)),
                              int(rng.integers(0, 8)))
            n_bad += 1
    return n_bad


def _scrub_load(pkg):
    return pkg.sim.multi_tenant([pkg.sim.TenantSpec(
        name="reader", kind="uniform", n_ops=300, rate_iops=50_000,
        read_frac=1.0, seed=31)], logical_blocks=256)


@pytest.mark.parametrize("case", ["scrub_pass", "verify_off", "verify_on", "repair_storm"])
def test_scrub_rows_match_reference(case):
    """``benchmarks/bench_scrub.py``: one paced scrub pass over clean sealed
    media, the read load with verify-on-read off and on, and the read load
    while the scrub actor repairs a corruption storm."""
    def run(pkg, pipe):
        if case == "scrub_pass":
            pipe.schedule_scrub(at=pipe.engine.now + 10.0, interval_us=20.0)
            pipe.drain()
            return pipe.array.stats.integrity_scrub_blocks
        if case == "repair_storm":
            n_bad = _corrupt_per_group(pkg, pipe.array, np.random.default_rng(13))
            pipe.schedule_scrub(at=pipe.engine.now + 10.0, interval_us=50.0)
            pipe.replay(shift(_scrub_load(pkg), pipe.engine.now))
            return n_bad, pipe.array.stats.integrity_blocks_repaired
        pipe.replay(_scrub_load(pkg))
        return None

    (pa, a), (pb, b) = _both(run, seed=9, zones=16, flush_interval_us=200.0,
                             precondition_rounds=2, verify_reads=case != "verify_off")
    assert_same_timed(pa, pb)
    assert a == b
    p99 = round(pb.recorder.percentiles(op="R")["p99"], 2)
    if case == "scrub_pass":
        assert bench("integrity/scrub_throughput")[0] == \
            round(pb.recorder.notes["scrub_device_us"], 2)
        assert bench("integrity/scrub_throughput")[1].startswith(f"blocks={b}_")
    elif case == "verify_on":
        assert bench("integrity/verify_read_overhead_p99")[0] == p99
    elif case == "repair_storm":
        assert bench("integrity/repair_storm_p99")[0] == p99
        assert bench("integrity/repair_storm_p99")[1].startswith(
            f"corrupted={b[0]}_repaired={b[1]}_")


def test_fault_plan_with_media_faults_and_a_drive_cycle_matches_reference():
    """``attach_faults``: a seeded plan of bit rot, torn and misdirected
    writes, unreadable sectors and one fail/paced-rebuild cycle, under a
    mixed load with verify-on-read and a scrub pass."""
    def run(pkg, pipe):
        plan = pkg.sim.FaultPlan.probabilistic(
            n_drives=4, horizon_us=6_000.0, mtbf_us=4_000.0,
            repair_after_us=400.0, rebuild_interval_us=30.0, seed=3,
            media_mix={"bit_rot": 3, "torn_write": 1, "misdirected_write": 1,
                       "unreadable": 1},
            media_mtbf_us=700.0, media_count=2)
        inj = pipe.attach_faults(plan, seed=4)
        pipe.schedule_scrub(at=3_000.0, interval_us=40.0)
        pipe.replay(pkg.sim.synthetic(pkg.sim.TenantSpec(
            name="mix", kind="uniform", n_ops=400, rate_iops=60_000,
            read_frac=0.7, seed=41), 256))
        return [(t, k, d) for t, k, d in inj.log]

    (pa, a), (pb, b) = _both(run, seed=9, zones=16, flush_interval_us=200.0,
                             verify_reads=True)
    assert_same_timed(pa, pb)
    assert a == b
    kinds = {k for _, k, _ in b}
    assert {"fail", "rebuild"} <= kinds and len(kinds) >= 4, b


# -------------------------------------------------------------------- GC

def test_gc_actor_matches_reference():
    """``schedule_gc`` under an overwrite load on a small array: GC passes
    book device time that the foreground writes queue behind."""
    def run(pkg, pipe):
        pipe.schedule_gc(10.0, 100.0, n_ticks=150, watermark=4)
        pipe.replay(_write_load(pkg, 700))
        return pipe.array.stats.gc_runs

    (pa, a), (pb, b) = _both(run, seed=2, zones=6, flush_interval_us=200.0)
    assert_same_timed(pa, pb)
    assert a == b > 0
    assert pb.recorder.note_counts["gc_device_us"] > 0


# ------------------------------------------------------- crash and recovery

def _crash_run(pkg, pipe, where, seed):
    """Overwrites submitted one by one (acks recorded), with a crash armed
    inside the first GC pass or the second paced-rebuild step.  Returns the
    acknowledged image: every LBA whose last write dispatched before the
    crash was acked (or, never overwritten, holds its preconditioned block)."""
    arr = pipe.array
    # the pass the crash must land in, and the step that arms it: GC restages
    # its victim's live blocks, then commits them; a paced rebuild writes each
    # sealed segment's lost chunks to the replacement drive, one per step
    pass_name, arm_name = {"gc": ("gc_once", "_restage_live"),
                           "rebuild": ("_rebuild_segment", "_rebuild_segment")}[where]
    inside, steps = [], []

    def watch(fn):
        def call(*a, **k):
            try:
                return fn(*a, **k)
            except pkg.zns.DeviceCrashed:
                inside.append(True)
                raise
        return call

    def arm(fn):
        def call(rec, *a, **k):
            steps.append(rec.valid_count)
            if arr.budget.remaining is None and (
                    len(steps) == 2 if where == "rebuild" else rec.valid_count >= 5):
                arr.arm_crash(5)
            return fn(rec, *a, **k)
        return call

    setattr(arr, pass_name, watch(getattr(arr, pass_name)))
    setattr(arr, arm_name, arm(getattr(arr, arm_name)))
    if where == "rebuild":
        arr.fail_drive(1)
        pipe.schedule_rebuild(1, at=300.0, interval_us=60.0)
    else:
        pipe.schedule_gc(10.0, 100.0, n_ticks=60, watermark=7)
    pre = np.random.default_rng(seed)
    image = {lba: pre.integers(0, 256, (1, BB), dtype=np.uint8)[0] for lba in range(256)}
    rng = np.random.default_rng(23)
    writes, acked = [], set()
    t = 0.0
    for i in range(2000):
        t += float(rng.exponential(25.0))
        lba = int(rng.integers(0, 256))
        blk = rng.integers(0, 256, (1, BB), dtype=np.uint8)
        writes.append((t + pipe.service.cpu_dispatch_us, lba, blk[0]))
        pipe.submit_write(lba, blk, lambda _t, i=i: acked.add(i), at=t)
    with pytest.raises(pkg.zns.DeviceCrashed):
        pipe.drain()
    assert inside, f"the crash did not land inside {pass_name}: {steps}"
    for i, (t_dispatch, lba, blk) in enumerate(writes):
        if t_dispatch > pipe.engine.now:
            break
        if i in acked:
            image[lba] = blk
        else:  # dispatched, never acked: it may or may not have landed
            image.pop(lba, None)
    return image


@pytest.mark.parametrize("where", ["gc", "rebuild"])
def test_crash_mid_background_pass_recovers_as_reference(where):
    jc, jz, tc, tz = configs("raid5", 4, zones=8, append_order="timed")
    pa, pb = timed_pair("raid5", 4, seed=4, zones=8, flush_interval_us=200.0)
    acked_a = _crash_run(JAX, pa, where, seed=4)
    acked_b = _crash_run(PORT, pb, where, seed=4)
    assert_same_timed(pa, pb)
    assert acked_a.keys() == acked_b.keys() and len(acked_b) > 100
    ra = JAX.recovery.recover_array(pa.array.drives, jc, jz)
    rb = PORT.recovery.recover_array(pb.array.drives, tc, tz)
    assert_same_state(ra, rb)
    got = rb.read(0, 256)
    assert np.array_equal(got, ra.read(0, 256))
    for lba, blk in acked_b.items():
        assert np.array_equal(got[lba], blk), lba


def test_recovery_of_a_full_array_fails_as_reference():
    """A reference quirk the port reproduces: on 6 zones per drive, a crash
    after the GC actor has run leaves no free zone, and ``recover_array``
    raises while reopening segments instead of collecting garbage."""
    jc, jz, tc, tz = configs("raid5", 4, zones=6, append_order="timed")
    pa, pb = timed_pair("raid5", 4, seed=4, zones=6, flush_interval_us=200.0)
    errors = []
    for pkg, pipe, cfg, zns in ((JAX, pa, jc, jz), (PORT, pb, tc, tz)):
        arr = pipe.array
        gc_once = arr.gc_once

        def armed(gc_once=gc_once, arr=arr):
            if arr.stats.gc_runs == 0:
                arr.arm_crash(5)
            return gc_once()

        arr.gc_once = armed
        pipe.schedule_gc(10.0, 100.0, n_ticks=60)
        rng = np.random.default_rng(23)
        t = 0.0
        for _ in range(2000):
            t += float(rng.exponential(25.0))
            pipe.submit_write(int(rng.integers(0, 256)),
                              rng.integers(0, 256, (1, BB), dtype=np.uint8), at=t)
        with pytest.raises(pkg.zns.DeviceCrashed):
            pipe.drain()
        with pytest.raises(RuntimeError) as err:
            pkg.recovery.recover_array(arr.drives, cfg, zns)
        errors.append(str(err.value))
    assert_same_timed(pa, pb)
    assert errors[0] == errors[1] == "out of free zones; GC required"


# ------------------------------------------------------------ entry point

def test_build_timed_runs_on_cuda_by_default_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zns = ZnsConfig(n_zones=8, zone_cap_blocks=64, block_bytes=BB)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HandlerPipeline.build_timed(ZapRaidConfig(logical_blocks=128), zns)
    cfg = ZapRaidConfig(logical_blocks=128, device="cpu")
    cfg.device = "cuda"  # a config made where a card was, built where none is
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HandlerPipeline.build_timed(cfg, zns)
    pipe = HandlerPipeline.build_timed(
        ZapRaidConfig(logical_blocks=128, device="cpu"), zns)
    assert pipe.array.codec.device.type == "cpu"
    assert pipe.array.append_plan_fn is not None  # timed Zone-Append order
