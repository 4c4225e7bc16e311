"""The port's observability and cache tiers against the JAX package's, on
timed pipelines built alike in both: the tracer's events over a replay with
a drive failure and a paced rebuild, the metrics sampler's series over a
scrub that repairs injected faults, the SLO monitor's decisions on one
latency series, the frequency sketch, and the cache tier's hits, admission
rejects, stats and state on a timed replay."""
import dataclasses
import types

import numpy as np
import pytest

from _port import BB, JAX, LOGICAL, PORT, assert_same_timed, same, timed_pair


def _mixed_workload(pipe, *, fail, seed=5, reads=48, rounds=2):
    """``tests/test_obs.py``'s workload: two overwrite rounds, a read sweep,
    and optionally a drive failure, degraded reads and a paced rebuild."""
    rng = np.random.default_rng(seed)
    t = 0.0
    for _ in range(rounds):
        for lba in range(0, LOGICAL - 2, 2):
            pipe.submit_write(lba, rng.integers(0, 256, (2, BB), dtype=np.uint8), at=t)
            t += 8.0
    for i in range(reads):
        pipe.submit_read((i * 5) % (LOGICAL - 3), 3, at=t)
        t += 10.0
    if fail:
        pipe.schedule_drive_failure(1, t + 50.0)
        for i in range(reads):
            pipe.submit_read((i * 7) % (LOGICAL - 2), 2, at=t + 100.0 + 12.0 * i)
        pipe.schedule_rebuild(1, t + 100.0 + 14.0 * reads, interval_us=40.0)
    pipe.drain()


# ------------------------------------------------------------------ tracer

@pytest.mark.parametrize("scheme,n,reads", [("raid5", 4, 48), ("raid6", 5, 12)])
def test_tracer_events_match_reference_and_validate(scheme, n, reads):
    pa, pb = timed_pair(scheme, n, seed=1, flush_interval_us=200.0)
    events = []
    for pkg, pipe in ((JAX, pa), (PORT, pb)):
        tracer = pipe.attach_obs()
        assert isinstance(tracer, pkg.obs.Tracer)
        _mixed_workload(pipe, fail=True, reads=reads, rounds=1)
        ev = tracer.to_trace_events()
        pkg.obs.validate_trace_events(ev)
        events.append((ev, tracer.dropped))
    assert events[0] == events[1]
    assert_same_timed(pa, pb)
    names = {e["name"] for e in events[1][0]}
    assert {"zone_append", "read", "degraded.decode"} <= names
    assert {"rebuild.segment", "rebuild.rewiden"} & names


def test_tracing_is_observe_only_in_the_port():
    pa, pb = timed_pair("raid5", 4, seed=1, flush_interval_us=200.0, pkgs=(PORT, PORT))
    pb.attach_obs()
    for pipe in (pa, pb):
        _mixed_workload(pipe, fail=True)
    assert_same_timed(pa, pb)


def test_validate_trace_events_rejects_the_same_faults():
    for pkg in (JAX, PORT):
        tr = pkg.obs.Tracer()
        tr.req_begin(1, "io.request", 0.0)
        tr.req_end(1, "other", 5.0)
        with pytest.raises(AssertionError):
            pkg.obs.validate_trace_events(tr.to_trace_events())


# ----------------------------------------------------------------- metrics

def test_metrics_series_over_a_scrub_match_reference():
    """A sampler on the stock collector while a scripted media-fault plan
    rots, tears and unreads blocks and a paced scrub repairs them under a
    read load."""
    pa, pb = timed_pair("raid5", 4, seed=9, flush_interval_us=200.0,
                        precondition_rounds=2, verify_reads=True, zones=16)
    out = []
    for pkg, pipe in ((JAX, pa), (PORT, pb)):
        E = pkg.sim.FaultEvent
        inj = pipe.attach_faults(pkg.sim.FaultPlan.scripted(
            [E(t_us=50.0 * i, kind=k, drive=i % 4, count=2)
             for i, k in enumerate(["bit_rot", "unreadable", "bit_rot", "torn_write",
                                    "misdirected_write", "bit_rot"] * 3)]), seed=2)
        reg = pkg.obs.MetricsRegistry()
        sampler = pkg.obs.MetricsSampler(pipe.engine, reg, pkg.obs.standard_collector(pipe),
                                         interval_us=40.0)
        sampler.start(0.0)
        pipe.schedule_scrub(at=100.0, interval_us=30.0, n_passes=2)
        pipe.replay(pkg.sim.synthetic(pkg.sim.TenantSpec(
            name="r", kind="uniform", n_ops=300, rate_iops=40_000, read_frac=1.0,
            seed=3), LOGICAL))
        pkg.obs.validate_metrics_series({"series": sampler.series})
        out.append((sampler.series, reg.snapshot(), inj.log))
    assert same(out[0], out[1])
    assert_same_timed(pa, pb)
    last = out[1][0][-1]
    assert last["counters"]["integrity/blocks_repaired"] > 0
    assert last["counters"]["integrity/scrub_passes"] >= 1


def test_histogram_and_registry_match_reference():
    snaps = []
    for pkg in (JAX, PORT):
        reg = pkg.obs.MetricsRegistry()
        rng = np.random.default_rng(4)
        for v in rng.lognormal(4.0, 1.5, 500):
            reg.observe("lat", float(v))
        reg.inc("n", 3.0)
        reg.set("g", 7.0)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]


# --------------------------------------------------------------------- SLO

class _Service:
    """The part of a block service an ``SloMonitor`` reads and writes."""

    def __init__(self, engine, recorder, live_until):
        self.engine, self.recorder, self.live_until = engine, recorder, live_until
        self.tenants = {"ckpt": types.SimpleNamespace(
            qos=types.SimpleNamespace(name="ckpt", max_inflight=8))}
        self.max_inflight = 16
        self.class_caps = {}
        self.pumps = 0

    def _pump(self):
        self.pumps += 1

    @property
    def _live(self):
        return int(self.engine.now < self.live_until)


def _slo_run(pkg):
    eng = pkg.sim.Engine()
    rec = pkg.sim.LatencyRecorder()
    rng = np.random.default_rng(6)
    t = 0.0
    while t < 20_000.0:
        t += float(rng.exponential(60.0))
        base = 400.0 if 5_000.0 <= t < 10_000.0 else 90.0  # a pressure window
        lat = float(base * rng.lognormal(0.0, 0.3))
        eng.at(t, rec.record, "serve", "R", t - lat, t)
    svc = _Service(eng, rec, live_until=20_000.0)
    reg = pkg.obs.MetricsRegistry()
    mon = pkg.obs.SloMonitor(svc, "serve", 200.0, klass="ckpt", window_us=1500.0,
                             interval_us=250.0, min_samples=8, registry=reg)
    mon.start(0.0)
    eng.run()
    return mon.history, mon.actions, mon.summary(), reg.snapshot(), svc.pumps


def test_slo_monitor_decisions_match_reference():
    a, b = _slo_run(JAX), _slo_run(PORT)
    assert same(a, b)
    s = b[2]
    assert s["n_shrinks"] > 0 and s["n_restores"] > 0 and s["min_cap"] < s["default_cap"]


def _slo_over_service(pkg, pipe):
    """An ``SloMonitor`` on the real ``BlockDeviceService``: open-loop
    latency-class reads beside a closed-loop checkpoint-class aggressor
    writing 8-block extents."""
    svc = pkg.service.BlockDeviceService(pipe, max_inflight=8, policy="qos")
    svc.register("serve", pkg.service.LATENCY)
    svc.register("job", pkg.service.QosClass("ckpt", priority=2, max_inflight=6))
    reg = pkg.obs.MetricsRegistry()
    mon = pkg.obs.SloMonitor(svc, "serve", 150.0, klass="ckpt", window_us=1500.0,
                             interval_us=250.0, min_samples=8, registry=reg)
    mon.start(0.0)
    for i in range(300):
        svc.submit_read("serve", (i * 11) % (LOGICAL - 1), at=40.0 * i)
    aggr = pkg.sim.synthetic(pkg.sim.TenantSpec(
        name="job", kind="uniform", n_ops=300, n_blocks=8, read_frac=0.0,
        arrival="closed", window=32, seed=17), LOGICAL)
    pkg.service.ClosedLoopClient(svc, "job", aggr, window=32).start(0.0)
    svc.drain()
    return mon.history, mon.actions, mon.summary(), reg.snapshot(), svc.summary()


def test_slo_monitor_over_the_block_service_matches_reference():
    pa, pb = timed_pair("raid5", 4, seed=3, flush_interval_us=200.0)
    a, b = _slo_over_service(JAX, pa), _slo_over_service(PORT, pb)
    assert same(a, b)
    assert_same_timed(pa, pb)
    s = b[2]
    assert s["n_shrinks"] > 0 and s["n_restores"] > 0 and s["min_cap"] < s["default_cap"]


# ------------------------------------------------------------------ sketch

@pytest.mark.parametrize("decay_every", [None, 64])
def test_frequency_sketch_counts_match_reference(decay_every):
    rng = np.random.default_rng(8)
    keys = [rng.zipf(1.3, 200).astype(np.int64) % 5000 for _ in range(10)]
    got = []
    for pkg in (JAX, PORT):
        sk = pkg.cache.FrequencySketch(width=256, n_hashes=4, decay_every=decay_every, seed=3)
        est = []
        for k in keys:
            sk.add(k)
            est.append(sk.estimate(np.arange(64)))
        got.append((sk.table.copy(), est, sk.salts.copy()))
    assert np.array_equal(got[0][0], got[1][0]) and np.array_equal(got[0][2], got[1][2])
    assert all(np.array_equal(x, y) for x, y in zip(got[0][1], got[1][1]))
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError, match="power of two"):
            pkg.cache.FrequencySketch(width=100)


# ------------------------------------------------------------------- cache

CACHE_STATE = ("data_i32", "keys", "slot_of", "ref", "wp", "zone_seq")


@pytest.mark.parametrize("fail", [False, True])
def test_cache_tier_on_a_timed_replay_matches_reference(fail):
    """``attach_cache`` on a timed pipeline, warmed outside the measured
    timeline, then a hotspot read/write mix (degraded with a failed drive):
    hits complete on the cache device's clock, one-touch reads are rejected
    by the admission gate, overwrites refresh resident copies."""
    pa, pb = timed_pair("raid5", 4, seed=12, flush_interval_us=200.0)
    tiers, traces = [], []
    for pkg, pipe in ((JAX, pa), (PORT, pb)):
        tier = pkg.cache.ZnsCacheTier(
            pkg.cache.CacheConfig(n_zones=4, zone_cap_blocks=16, block_bytes=BB,
                                  admit_threshold=2), LOGICAL)
        pipe.attach_cache(tier)
        tracer = pipe.attach_obs()
        for _ in range(2):
            pipe.array.read(0, 32)  # two passes clear admission
        pipe.precondition(())
        if fail:
            pipe.array.fail_drive(2)
        pipe.replay(pkg.sim.multi_tenant([
            pkg.sim.TenantSpec(name="hot", kind="hotspot", n_ops=400, rate_iops=30_000,
                               read_frac=0.8, hot_frac=0.1, hot_prob=0.9, seed=14),
            pkg.sim.TenantSpec(name="scan", kind="seq", n_ops=200, rate_iops=20_000,
                               read_frac=1.0, n_blocks=4, seed=15),
        ], LOGICAL))
        tiers.append(tier)
        traces.append(tracer.to_trace_events())
    ta, tb = tiers
    assert dataclasses.asdict(ta.stats) == dataclasses.asdict(tb.stats)
    for name in CACHE_STATE:
        assert np.array_equal(getattr(ta, name), getattr(tb, name)), name
    assert np.array_equal(ta.sketch.table, tb.sketch.table)
    assert ta.resident_count() == tb.resident_count()
    assert ta.timed_dev.channels == tb.timed_dev.channels
    assert ta.timed_dev.busy_us == tb.timed_dev.busy_us
    assert traces[0] == traces[1]
    assert_same_timed(pa, pb)
    st = tb.stats
    assert st.hits > 0 and st.misses > 0 and st.rejects > 0 and st.refreshes > 0
    assert "cache_read" in {e["name"] for e in traces[1]}
