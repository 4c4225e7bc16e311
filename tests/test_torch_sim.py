"""The port's timed-simulation primitives against the JAX package's: the
ZN540 performance model, the event engine, the latency recorder, the workload
generators, the timed drives' bookings, Zone-Append group planning and
seeded fault plans.  Same inputs through both, exact equality."""
import dataclasses
import json

import numpy as np
import pytest

from _port import JAX, PORT, same
from repro.core import perfmodel as jpm
from repro_torch.core import perfmodel as tpm

KINDS = ("seq", "uniform", "hotspot", "zipf")


# ------------------------------------------------------------- perfmodel

SIZES = (0.25, 1.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0)


@pytest.mark.parametrize("size", SIZES)
def test_perfmodel_command_curves_match_reference(size):
    for fn in ("zone_write_tput", "zone_append_tput"):
        for n_zones in (1, 2, 4):
            assert getattr(tpm, fn)(size, n_zones=n_zones) == \
                getattr(jpm, fn)(size, n_zones=n_zones)
    for qd in (1, 2, 3, 4, 6, 8):
        assert tpm.zone_append_tput(size, qd) == jpm.zone_append_tput(size, qd)
        assert tpm.zone_append_cmd_latency_us(size, qd) == \
            jpm.zone_append_cmd_latency_us(size, qd)
    assert tpm.zone_write_cmd_latency_us(size) == jpm.zone_write_cmd_latency_us(size)
    assert tpm.read_cmd_latency_us(size) == jpm.read_cmd_latency_us(size)


def test_perfmodel_array_estimates_match_reference():
    for k, m in ((3, 1), (2, 2), (4, 2)):
        for chunk in (4, 8, 16):
            for g in (1, 8, 256):
                for append in (True, False):
                    kw = dict(k=k, m=m, chunk_kib=chunk, group_size=g,
                              n_open_segments=2, use_append=append)
                    assert dataclasses.astuple(tpm.zapraid_write_perf(**kw)) == \
                        dataclasses.astuple(jpm.zapraid_write_perf(**kw))
                assert tpm.degraded_read_latency_us(k=k, chunk_kib=chunk, group_size=g) \
                    == jpm.degraded_read_latency_us(k=k, chunk_kib=chunk, group_size=g)
            assert tpm.full_drive_recovery_time_s(logical_gib=100, k=k, chunk_kib=chunk) \
                == jpm.full_drive_recovery_time_s(logical_gib=100, k=k, chunk_kib=chunk)
        for frac in (0.0, 0.5, 0.75, 1.0):
            kw = dict(k=k, m=m, cs_kib=8, cl_kib=16, n_small=1, n_large=3,
                      frac_small=frac, group_size=256)
            assert dataclasses.astuple(tpm.hybrid_write_perf(**kw)) == \
                dataclasses.astuple(jpm.hybrid_write_perf(**kw))
    for gib in (1.0, 100.0):
        assert tpm.crash_recovery_time_s(logical_gib=gib, chunk_kib=4) == \
            jpm.crash_recovery_time_s(logical_gib=gib, chunk_kib=4)


# ---------------------------------------------------------------- engine

def _engine_trace(pkg):
    eng = pkg.sim.Engine()
    log = []

    def ev(name, again=None):
        log.append((eng.now, name))
        if again is not None:
            eng.after(again, ev, name + "+", None)
            eng.at(eng.now - 5.0, ev, name + "-past", None)  # clamped to now

    rng = np.random.default_rng(0)
    for i in range(60):
        t = float(rng.integers(0, 8)) * 2.5  # many ties
        eng.at(t, ev, f"e{i}", 1.0 if i % 7 == 0 else None)
    fired = [eng.run(until=7.5)]
    log.append(("pending", eng.pending()))
    eng.touch_io(40.0)
    eng.touch_io(30.0)
    log.append(("watermark", eng.io_watermark, eng.mark_io(), eng.io_watermark))
    fired.append(eng.run())
    return log, fired, eng.now, eng.events_fired, eng.pending()


def test_engine_orders_ties_by_scheduling_order_as_reference():
    a, b = _engine_trace(JAX), _engine_trace(PORT)
    assert a == b
    log = b[0]
    times = [x[0] for x in log if isinstance(x[0], float)]
    assert times == sorted(times) and len(times) > 60  # the clock never goes back
    # events at one instant fire in the order they were scheduled
    at_zero = [name for t, name in log[:10] if t == 0.0]
    assert at_zero == sorted(at_zero, key=lambda n: int(n[1:]))


# --------------------------------------------------------------- recorder

def _fill(rec, rng, n=500):
    for i in range(n):
        t0 = float(rng.uniform(0, 10_000))
        tenant = ("a", "b", "c")[i % 3]
        op = "R" if rng.random() < 0.4 else "W"
        stages = {"device_us": float(rng.exponential(80.0))}
        if op == "W":
            stages["buffer_wait_us"] = float(rng.exponential(30.0))
        rec.record(tenant, op, t0, t0 + float(rng.lognormal(4.5, 0.6)), stages=stages)
    for _ in range(20):
        rec.note("group_barrier_wait_us", float(rng.exponential(10.0)))
    rec.notes["W_blocks"] = 777


def test_latency_recorder_reductions_match_reference(tmp_path):
    ra, rb = JAX.sim.LatencyRecorder(), PORT.sim.LatencyRecorder()
    empty = (ra.percentiles(), rb.percentiles(), ra.span_us(), rb.span_us(),
             ra.throughput_mib_s(256), rb.throughput_mib_s(256))
    assert same(empty[0], empty[1]) and empty[0]["n"] == 0 and empty[2:4] == (0.0, 0.0)
    _fill(ra, np.random.default_rng(1))
    _fill(rb, np.random.default_rng(1))
    for tenant in (None, "a", "b", "c", "nobody"):
        for op in (None, "R", "W"):
            assert same(ra.percentiles(op, tenant), rb.percentiles(op, tenant))
            assert np.array_equal(ra.latencies(op, tenant), rb.latencies(op, tenant))
        assert ra.stage_means(tenant) == rb.stage_means(tenant)
    for lo, hi in ((0, 2_000), (2_000, 8_000), (9_999, 12_000), (50_000, 60_000)):
        assert same(ra.windowed_percentiles(lo, hi, op="R", tenant="a"),
                    rb.windowed_percentiles(lo, hi, op="R", tenant="a"))
        assert same(ra.windowed_percentiles(lo, hi), rb.windowed_percentiles(lo, hi))
    assert same(ra.summary(), rb.summary())
    assert ra.to_bench_rows("t") == rb.to_bench_rows("t")
    for op in ("R", "W"):
        assert ra.throughput_mib_s(4096, op) == rb.throughput_mib_s(4096, op)
    ra.to_json(str(tmp_path / "a.json"), "t")
    rb.to_json(str(tmp_path / "b.json"), "t")
    assert json.loads((tmp_path / "a.json").read_text()) == \
        json.loads((tmp_path / "b.json").read_text())


# --------------------------------------------------------------- workloads

def _reqs(rs):
    return [dataclasses.astuple(r) for r in rs]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arrival,burst", [("open", 1.0), ("open", 3.0), ("closed", 1.0)])
def test_synthetic_streams_match_reference(kind, arrival, burst):
    kw = dict(name="t", kind=kind, n_ops=400, rate_iops=40_000, read_frac=0.3,
              n_blocks=2, burst_factor=burst, hot_frac=0.05, hot_prob=0.9,
              seed=7, arrival=arrival)
    a = JAX.sim.synthetic(JAX.sim.TenantSpec(**kw), 1000)
    b = PORT.sim.synthetic(PORT.sim.TenantSpec(**kw), 1000)
    assert _reqs(a) == _reqs(b)
    assert all(0 <= r.lba <= 998 for r in b)


def test_multi_tenant_merge_and_errors_match_reference():
    def specs(pkg):
        T = pkg.sim.TenantSpec
        return [T(name=f"t{i}", kind=k, n_ops=150, rate_iops=10_000 * (i + 1),
                  read_frac=0.5, burst_factor=1.0 + i, seed=i)
                for i, k in enumerate(KINDS)]
    a = JAX.sim.multi_tenant(specs(JAX), 512)
    b = PORT.sim.multi_tenant(specs(PORT), 512)
    assert _reqs(a) == _reqs(b)
    assert [r.t_us for r in b] == sorted(r.t_us for r in b)
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match="closed-loop"):
            pkg.sim.multi_tenant([pkg.sim.TenantSpec(name="c", arrival="closed")], 64)
        with pytest.raises(ValueError, match="unknown address kind"):
            pkg.sim.synthetic(pkg.sim.TenantSpec(name="x", kind="nope"), 64)
        with pytest.raises(ValueError, match="unknown arrival mode"):
            pkg.sim.synthetic(pkg.sim.TenantSpec(name="x", arrival="nope"), 64)


def test_parse_msr_trace_matches_reference():
    rng = np.random.default_rng(3)
    lines = ["Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime", ""]
    for _ in range(300):
        lines.append(",".join(map(str, [
            128166372000000000 + int(rng.integers(0, 10**7)), "hm", 0,
            "Write" if rng.random() < 0.7 else "Read",
            int(rng.integers(0, 1 << 34)), int(rng.choice([512, 4096, 8192, 65536, 1 << 20])),
            int(rng.integers(1, 5000))])))
    lines.append("garbage,row")
    text = "\n".join(lines)
    for scale in (1.0, 0.01):
        kw = dict(block_bytes=4096, logical_blocks=2048, tenant="msr", time_scale=scale)
        assert _reqs(JAX.sim.parse_msr_trace(text, **kw)) == \
            _reqs(PORT.sim.parse_msr_trace(text, **kw))
    assert PORT.sim.parse_msr_trace("", block_bytes=4096, logical_blocks=8) == []


# --------------------------------------------------------- timed drives

def _drives(pkg, n=4, seed=5):
    eng = pkg.sim.Engine()
    zns = pkg.zns.ZnsConfig(n_zones=6, zone_cap_blocks=64, block_bytes=4096)
    return eng, pkg.sim.make_timed_drives(n, zns, eng, seed=seed)


def _bookings(pkg):
    eng, drives = _drives(pkg)
    rng = np.random.default_rng(9)
    out = []
    for i in range(400):
        d = drives[int(rng.integers(0, len(drives)))]
        floor = float(i) * 3.0
        kind = int(rng.integers(0, 3))
        if kind == 0:
            out.append(d.book_zone_write(int(rng.integers(0, 6)), int(rng.integers(1, 5)), floor))
        elif kind == 1:
            out.append(d.book_append(int(rng.integers(0, 6)), int(rng.integers(1, 3)), floor))
        else:
            out.append(d.book_read(int(rng.integers(1, 40)), floor))
    svc = drives[0].service
    model = [svc.zone_write_us(4), svc.zone_append_us(2, 3), svc.read_us(8),
             dataclasses.astuple(svc)]
    state = [(list(d.t_zone_free), d.channels, d.za_slots, d.busy_us) for d in drives]
    return out, model, state, eng.io_watermark


def test_timed_drive_bookings_match_reference():
    a, b = _bookings(JAX), _bookings(PORT)
    assert a == b
    assert len(set(b[0])) > 300  # the per-drive jitter streams differ


def test_timed_drive_commands_and_reset_match_reference():
    def run(pkg):
        eng, drives = _drives(pkg, n=2)
        d = drives[1]
        blk = np.full((4, 4096), 9, np.uint8)
        oob = np.zeros(4, dtype=pkg.zns.OOB_DTYPE)
        eng.now = 10.0
        d.zone_write(0, 0, blk, oob)
        off = d.zone_append_commit(1, blk[:2], oob[:2])
        offs = d.zone_append_commit_many(2, blk.reshape(2, 2, 4096), oob.reshape(2, 2))
        d.read(0, 0, 4)
        d.read_blocks(0, np.arange(3))
        d.read_scattered(np.zeros(3, np.int64), np.arange(3))
        d.repair_blocks(0, np.arange(2), blk[:2])
        got = (off, list(offs), dict(d.chunk_done), d.chunk_completion(1, off),
               d.chunk_completion(5, 5), d.busy_us, list(d.channels))
        d.replace()
        return got, (list(d.t_zone_free), d.channels, d.chunk_done, d.busy_us)

    assert run(JAX) == run(PORT)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_group_appends_order_matches_reference(seed):
    def run(pkg):
        eng, drives = _drives(pkg, seed=seed)
        rng = np.random.default_rng(seed)
        results = []
        floor = 0.0
        for g in range(6):
            ops = [(s, d) for s in range(8) for d in range(4)]
            order, done = pkg.sim.plan_group_appends(
                drives, (1, 2, 3, 4), ops, int(rng.integers(1, 3)), floor)
            # commits in the planned order consume the planned times
            for idx in order:
                _, d = ops[idx]
                drives[d].zone_append_commit(
                    (1, 2, 3, 4)[d], np.zeros((1, 4096), np.uint8),
                    np.zeros(1, dtype=pkg.zns.OOB_DTYPE))
            results.append((order, done, [dict(x.chunk_done) for x in drives]))
            floor = done if g % 2 else floor + 5.0
        return results

    a, b = run(JAX), run(PORT)
    assert a == b
    assert any(o != sorted(o) for o, _, _ in b)  # timing reorders the group


def test_timed_cache_device_bookings_match_reference():
    def run(pkg):
        eng = pkg.sim.Engine()
        dev = pkg.sim.device.TimedCacheDevice(eng)
        out = [dev.book_read(n, float(i)) for i, n in enumerate((1, 16, 17, 200, 3))]
        return out, dev.channels, dev.busy_us, eng.io_watermark

    assert run(JAX) == run(PORT)


# ------------------------------------------------------------- fault plans

@pytest.mark.parametrize("seed", [0, 5, 11])
def test_fault_plan_probabilistic_schedules_match_reference(seed):
    def plan(pkg, **kw):
        p = pkg.sim.FaultPlan.probabilistic(n_drives=5, horizon_us=50_000.0, seed=seed, **kw)
        return [dataclasses.astuple(e) for e in p.events]

    for kw in (dict(mtbf_us=5_000.0, repair_after_us=700.0, rebuild_interval_us=30.0),
               dict(media_mix={"bit_rot": 2.0, "unreadable": 1.0, "torn_write": 0.5,
                               "misdirected_write": 0.5}, media_mtbf_us=900.0, media_count=3),
               dict(mtbf_us=9_000.0, repair_after_us=200.0,
                    media_mix={"bit_rot": 1.0}, media_mtbf_us=2_000.0)):
        a, b = plan(JAX, **kw), plan(PORT, **kw)
        assert a == b and b
        assert [e[0] for e in b] == sorted(e[0] for e in b)
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match="unknown media fault"):
            pkg.sim.FaultPlan.probabilistic(n_drives=4, horizon_us=1.0, seed=0,
                                            media_mix={"gremlins": 1.0}, media_mtbf_us=1.0)
        with pytest.raises(ValueError, match="unknown fault kind"):
            pkg.sim.FaultEvent(t_us=0.0, kind="gremlins", drive=0)
