"""The port's block service (``service/``) against the JAX package's.

Each case of the reference's ``tests/test_service.py`` -- and the service
cases of ``tests/test_obs.py``, ``tests/test_cache.py`` and
``tests/test_degraded_writes.py`` -- is written once over a package namespace
and run through the reference and through the port on the CPU, from the same
seeds.  Everything the run produces must be equal, with no tolerance: every
request's timestamps, status, payload and result; the completion queue in
order; the service's summary and recorder; the pipeline's recorder, clock,
events, bookings and drive images; restored checkpoint leaves.  The
reference's own assertions are then held on the port's outputs.  The
launcher's ``--storage-sim`` report is compared line for line.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

from _port import (
    JAX,
    PORT,
    assert_same_recorder,
    assert_same_timed,
    cpu,
    same,
)

BB = 256
SLO_KW = dict(window_us=1500.0, interval_us=250.0, min_samples=8)


def _timed_pipe(pkg, scheme="raid5", group_size=4, seed=0, logical_blocks=128,
                zones=8, **cfg_kw):
    cfg = pkg.array.ZapRaidConfig(
        scheme=scheme, n_drives=4, group_size=group_size, chunk_blocks=1,
        logical_blocks=logical_blocks, gc_free_segments_low=1, **cfg_kw, **cpu(pkg))
    zns = pkg.zns.ZnsConfig(n_zones=zones, zone_cap_blocks=64, block_bytes=BB)
    return pkg.handlers.HandlerPipeline.build_timed(cfg, zns, seed=seed,
                                                    flush_interval_us=200.0)


def _precondition(pipe, n_blocks, seed=1):
    rng = np.random.default_rng(seed)
    pipe.precondition((lba, rng.integers(0, 256, (1, BB), dtype=np.uint8))
                      for lba in range(n_blocks))


def _request(r):
    """Every field of an ``IoRequest`` but its callback."""
    out = dataclasses.asdict(dataclasses.replace(r, cb_fn=None, data=None, result=None))
    out["data"] = None if r.data is None else r.data.tobytes()
    out["result"] = None if r.result is None else np.asarray(r.result).tobytes()
    return out


def _service(svc):
    """Everything a block service holds after a run: summary, counters of
    each tenant, the completion queue in order, its recorder."""
    return {
        "summary": svc.summary(),
        "tenants": {n: (t.accepted, t.rejected, t.completed, t.inflight, len(t.queue))
                    for n, t in svc.tenants.items()},
        "cq": [_request(r) for r in svc.cq._q],
        "pushed": svc.cq.pushed,
        "inflight": svc.inflight,
        "live": svc._live,
        "cache_bypasses": svc.cache_bypasses,
    }


def _both(run):
    """``run(pkg)`` -> (pipe, svc, extra) in each package; every output equal.
    Returns the port's (pipe, svc, extra)."""
    (pa, sa, ea), (pb, sb, eb) = run(JAX), run(PORT)
    assert_same_timed(pa, pb)
    if sa is not None:
        assert same(_service(sa), _service(sb))
        assert_same_recorder(sa.recorder, sb.recorder)
    assert same(ea, eb)
    return pb, sb, eb


def _requests(reqs):
    return [_request(r) for r in reqs]


# ------------------------------------------------------------- token bucket

def test_token_bucket_matches_reference():
    def run(pkg):
        tb = pkg.service.TokenBucket(rate_iops=10_000.0, burst=4, t0=0.0)
        out = [tb.peek(0.0), [tb.take(0.0) for _ in range(5)], tb.next_ready(0.0),
               tb.peek(50.0), tb.take(100.0), tb.peek(1e9)]
        rng = np.random.default_rng(3)
        t = 0.0
        for _ in range(200):
            t += float(rng.exponential(40.0))
            out.append((tb.take(t), tb.tokens, tb.next_ready(t)))
        return out

    a, b = run(JAX), run(PORT)
    assert same(a, b)
    assert b[:6] == [4.0, [True] * 4 + [False], pytest.approx(100.0),
                     pytest.approx(0.5), True, 4.0]


# ------------------------------------------- submission/completion ordering

def test_acks_and_completion_queue_match_reference():
    def run(pkg):
        pipe = _timed_pipe(pkg)
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=64)
        svc.register("t", pkg.service.QosClass("t"))
        rng = np.random.default_rng(0)
        done, t = [], 0.0
        for lba in range(24):
            t += 20.0
            svc.submit_write("t", lba, rng.integers(0, 256, (1, BB), dtype=np.uint8),
                             at=t, cb=done.append)
        svc.drain()
        for lba in range(24):
            svc.submit_read("t", lba, 1, cb=done.append)
        svc.drain()
        return pipe, svc, _requests(done)

    pipe, svc, done = _both(run)
    assert len(done) == 48 and all(r["status"] == "done" for r in done)
    assert all(r["t_done"] > r["t_submit"] for r in done)
    writes = {r["lba"]: r["data"] for r in done if r["op"] == "W"}
    assert all(r["result"] == writes[r["lba"]] for r in done if r["op"] == "R")
    reaped = svc.cq.drain()
    assert len(reaped) == 48 and svc.cq.pushed == 48
    assert all(reaped[i].t_done <= reaped[i + 1].t_done for i in range(47))


def test_service_media_matches_direct_calls_and_reference():
    """The service is a pure scheduling layer: the same writes through it
    and straight into the pipeline leave the same media, in each package
    and across them."""
    rng = np.random.default_rng(7)
    ops = [(int(rng.integers(0, 120)), rng.integers(0, 256, (1, BB), dtype=np.uint8))
           for _ in range(48)]

    def run(pkg, served):
        pipe = _timed_pipe(pkg, seed=3)
        svc = None
        if served:
            svc = pkg.service.BlockDeviceService(pipe, max_inflight=64)
            svc.register("t", pkg.service.QosClass("t"))
        t = 0.0
        for lba, data in ops:
            t += 15.0
            if served:
                svc.submit_write("t", lba, data, at=t)
            else:
                pipe.submit_write(lba, data, at=t)
        (svc or pipe).drain()
        return pipe, svc, None

    for served in (False, True):
        _both(lambda pkg: run(pkg, served))
    direct, _, _ = run(PORT, False)
    served, _, _ = run(PORT, True)
    for d1, d2 in zip(direct.array.drives, served.array.drives, strict=True):
        assert np.array_equal(d1.data, d2.data) and np.array_equal(d1.oob, d2.oob)
        assert np.array_equal(d1.wp, d2.wp)
    want = {lba: data[0] for lba, data in ops}
    for lba, blk in want.items():
        assert np.array_equal(served.array.read(lba, 1)[0], blk)


# ----------------------------------------------------------------- QoS

def _victim(pkg, policy):
    pipe = _timed_pipe(pkg, seed=5)
    _precondition(pipe, 128)
    svc = pkg.service.BlockDeviceService(pipe, max_inflight=8, policy=policy)
    svc.register("victim", pkg.service.LATENCY)
    svc.register("aggr", pkg.service.QosClass("ckpt", priority=2, max_inflight=4))
    for i in range(60):
        svc.submit_read("victim", (i * 7) % 128, at=50.0 * i)
    aggr = pkg.sim.synthetic(
        pkg.sim.TenantSpec(name="aggr", kind="uniform", n_ops=300, n_blocks=4,
                           arrival="closed", window=64, seed=2), 120)
    pkg.service.ClosedLoopClient(svc, "aggr", aggr, window=64).start(0.0)
    svc.drain()
    return pipe, svc, svc.recorder.percentiles(op="R", tenant="victim")["p99"]


def test_qos_isolation_matches_reference():
    _, _, p99_fifo = _both(lambda pkg: _victim(pkg, "fifo"))
    _, _, p99_qos = _both(lambda pkg: _victim(pkg, "qos"))
    assert p99_qos * 2.0 <= p99_fifo


def test_edf_order_matches_reference():
    def run(pkg):
        pipe = _timed_pipe(pkg, seed=1)
        _precondition(pipe, 64)
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=1, policy="qos")
        Q = pkg.service.QosClass
        svc.register("slack", Q("slack", priority=1, deadline_us=50_000.0))
        svc.register("tight", Q("tight", priority=1, deadline_us=100.0))
        reqs = [svc.submit_read("slack", 0, at=0.0), svc.submit_read("slack", 1, at=1.0),
                svc.submit_read("tight", 2, at=2.0)]
        svc.drain()
        return pipe, svc, _requests(reqs)

    _, _, (blocker, late, soon) = _both(run)
    assert blocker["t_dispatch"] < soon["t_dispatch"] < late["t_dispatch"]


def test_admission_rejects_match_reference():
    def run(pkg):
        pipe = _timed_pipe(pkg, seed=2)
        _precondition(pipe, 64)
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=1)
        svc.register("t", pkg.service.QosClass("t", queue_cap=3))
        done = []
        for i in range(10):
            svc.submit_read("t", i, at=0.0, cb=done.append)
        svc.drain()
        return pipe, svc, _requests(done)

    _, svc, done = _both(run)
    ten = svc.tenants["t"]
    assert ten.rejected > 0 and ten.accepted + ten.rejected == 10
    assert ten.completed == ten.accepted
    assert {r["status"] for r in done} == {"done", "rejected"}
    assert svc.cq.pushed == 10
    assert svc.recorder.percentiles(op="R", tenant="t")["n"] == ten.accepted


def test_token_pacing_matches_reference():
    def run(pkg):
        pipe = _timed_pipe(pkg, seed=3)
        _precondition(pipe, 64)
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=64)
        svc.register("t", pkg.service.QosClass("t", rate_iops=10_000.0, burst=2))
        done = []
        for i in range(12):
            svc.submit_read("t", i, at=0.0, cb=done.append)
        svc.drain()
        return pipe, svc, _requests(done)

    _, svc, done = _both(run)
    disp = sorted(r["t_dispatch"] for r in done)
    assert len(done) == 12 and disp[-1] - disp[0] >= 900.0


# ----------------------------------------------------------- closed loop

def test_closed_loop_matches_reference():
    def run(pkg):
        pipe = _timed_pipe(pkg, seed=4)
        _precondition(pipe, 128)
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=64)
        svc.register("t", pkg.service.QosClass("t"))
        reqs = pkg.sim.synthetic(pkg.sim.TenantSpec(
            name="t", kind="uniform", n_ops=50, read_frac=1.0, arrival="closed",
            window=3, seed=6), 128)
        client = pkg.service.ClosedLoopClient(svc, "t", reqs, window=3)
        client.start(0.0)
        svc.drain()
        return pipe, svc, (client.done(), client.completed, client.rejected)

    _, svc, (done, completed, rejected) = _both(run)
    assert done and completed == 50 and rejected == 0
    spans = sorted((s.t_submit, s.t_done) for s in svc.recorder.samples)
    assert all(sum(1 for a, b in spans if a <= t0 < b) <= 3 for t0, _ in spans)


def test_drained_queue_flushes_partial_stripe_as_reference():
    def run(pkg):
        pipe = _timed_pipe(pkg)
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=8)
        svc.register("t", pkg.service.QosClass("t"))
        done = []
        svc.submit_write("t", 5, np.ones((1, BB), np.uint8), at=0.0, cb=done.append)
        pipe.engine.run()  # not svc.drain(): the flush tick re-arms itself
        return pipe, svc, (_requests(done), pipe.engine.run())

    pipe, _, (done, more) = _both(run)
    assert len(done) == 1 and done[0]["status"] == "done" and more == 0
    assert pipe.array.stats.padded_blocks > 0


def test_stage_breakdown_matches_reference():
    def run(pkg):
        pipe = _timed_pipe(pkg, seed=8)
        _precondition(pipe, 64)
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=2)
        svc.register("a", pkg.service.LATENCY)
        svc.register("b", pkg.service.QosClass("b", priority=2))
        for i in range(20):
            svc.submit_read("a", i % 64, at=float(i))
            svc.submit_read("b", (i * 3) % 64, at=float(i))
        svc.drain()
        return pipe, svc, svc.recorder.summary()

    _, _, summ = _both(run)
    a = summ["tenants"]["a"]["stage_means_us"]
    b = summ["tenants"]["b"]["stage_means_us"]
    assert a["service_us"] > 0.0 and b["service_us"] > 0.0
    assert b["queue_wait_us"] > a["queue_wait_us"] >= 0.0


# ------------------------------------------------------- async checkpoints

def _ckpt_cfg(pkg, **kw):
    return pkg.ckpt.CheckpointConfig(group_size=4, chunk_blocks=1, block_bytes=BB,
                                     zone_cap_blocks=256, n_zones=16, **kw, **cpu(pkg))


def _ckpt_service(pkg, seed=0, **kw):
    ckpt, pipe = pkg.ckpt.CheckpointEngine.build_timed(
        _ckpt_cfg(pkg, **kw), 1024, seed=seed, flush_interval_us=200.0)
    svc = pkg.service.BlockDeviceService(pipe, max_inflight=16)
    svc.register("ckpt", pkg.service.QosClass("ckpt", priority=2))
    return ckpt, pipe, svc


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(128).astype(np.float32),
            "b": rng.standard_normal(64).astype(np.float32)}


def _ticket(t):
    return {k: v for k, v in vars(t).items() if k not in ("cb", "state")}


def _restored(rt, want):
    for k in want:
        assert isinstance(rt.state[k], np.ndarray)
        assert np.array_equal(rt.state[k], want[k]), k
    return _ticket(rt)


def test_checkpoint_async_roundtrip_and_crash_ordering_match_reference():
    s0, s1 = _state(1), _state(2)

    def run(pkg):
        ckpt, pipe, svc = _ckpt_service(pkg)
        t0 = ckpt.save_async(0, s0, service=svc)
        svc.drain()
        t1 = ckpt.save_async(1, s1, service=svc)
        svc.drain()
        reqs = _requests(svc.cq._q)
        rt = ckpt.restore_async(1, s1, service=svc)
        svc.drain()
        return pipe, svc, (_ticket(t0), _ticket(t1), _restored(rt, s1), ckpt.catalog,
                           ckpt._manifest_blocks().tobytes(), reqs, ckpt.lba_base)

    _, _, (t0, t1, rt, _, _, reqs, base) = _both(run)
    assert t0["done"] and t1["done"] and t1["t_done"] > t1["t_issue"]
    assert rt["done"] and rt["n_extents"] == 2
    # the manifest write was only submitted after every leaf extent acked
    for ticket in (t0, t1):
        manifest = [r for r in reqs if r["op"] == "W" and r["lba"] == base
                    and abs(r["t_done"] - ticket["t_done"]) < 1e-9]
        assert len(manifest) == 1
        leaves = [r for r in reqs if r["op"] == "W" and r["lba"] != base
                  and r["t_submit"] <= manifest[0]["t_submit"]]
        assert manifest[0]["t_submit"] >= max(r["t_done"] for r in leaves)


def test_checkpoint_async_degraded_restore_matches_reference():
    s0 = _state(3)

    def run(pkg):
        ckpt, pipe, svc = _ckpt_service(pkg, seed=9)
        ckpt.save_async(0, s0, service=svc)
        svc.drain()
        ckpt.fail_lane(1)
        rt = ckpt.restore_async(0, s0, service=svc)
        svc.drain()
        return pipe, svc, _restored(rt, s0)

    pipe, _, rt = _both(run)
    assert rt["done"] and pipe.array.stats.degraded_reads > 0


def test_checkpoint_windows_share_one_array_as_reference():
    def run(pkg):
        cfg = _ckpt_cfg(pkg)
        pipe = pkg.handlers.HandlerPipeline.build_timed(
            cfg.zap_cfg(1024), cfg.zns_cfg(), seed=0, flush_interval_us=200.0)
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=16)
        span = pkg.ckpt.MANIFEST_LBAS + 256
        engines, states, tickets = [], [], []
        for j in range(2):
            svc.register(f"job{j}", pkg.service.QosClass(f"job{j}", priority=2))
            engines.append(pkg.ckpt.CheckpointEngine(cfg, 1024, array=pipe.array,
                                                     lba_base=j * span, lba_span=span))
            states.append(_state(10 + j))
        for j, (eng, st) in enumerate(zip(engines, states)):
            tickets.append(eng.save_async(0, st, service=svc, tenant=f"job{j}"))
        svc.drain()
        out = [_ticket(t) for t in tickets]
        for j, (eng, st) in enumerate(zip(engines, states)):
            rt = eng.restore_async(0, st, service=svc, tenant=f"job{j}")
            svc.drain()
            out.append(_restored(rt, st))
        return pipe, svc, out

    _, _, out = _both(run)
    assert all(t["done"] for t in out)


def test_checkpoint_saves_through_failure_and_rebuild_match_reference():
    """``tests/test_degraded_writes.py``: async saves keep committing while a
    lane is failed and while its paced rebuild runs; all restore."""
    states = [_state(s) for s in (1, 2, 3)]

    def run(pkg):
        ckpt, pipe, svc = _ckpt_service(pkg, keep_last=3)
        E, plan = pkg.sim.FaultEvent, pkg.sim.FaultPlan
        tickets = [ckpt.save_async(0, states[0], service=svc)]
        svc.drain()
        inj = pipe.attach_faults(plan.scripted(
            [E(t_us=pipe.engine.now + 10.0, kind="fail", drive=1)]))
        tickets.append(ckpt.save_async(1, states[1], service=svc))
        svc.drain()
        failed = [d.failed for d in pipe.array.drives]
        pipe.attach_faults(plan.scripted([E(t_us=pipe.engine.now + 20.0, kind="rebuild",
                                            drive=1, interval_us=25.0)]))
        tickets.append(ckpt.save_async(2, states[2], service=svc))
        svc.drain()
        out = [failed] + [_ticket(t) for t in tickets]
        for idx, st in enumerate(states):
            rt = ckpt.restore_async(idx, st, service=svc)
            svc.drain()
            out.append(_restored(rt, st))
        return pipe, svc, (out, inj.log)

    pipe, _, (out, log) = _both(run)
    assert any(out[0]) and all(t["done"] for t in out[1:])
    assert log and log[0][1] == "fail"
    assert not any(d.failed for d in pipe.array.drives)


# ------------------------------------------------- obs and cache over a service

def test_request_spans_through_service_match_reference():
    def run(pkg):
        pipe = _timed_pipe(pkg, logical_blocks=96)
        _precondition(pipe, 96)
        tracer = pipe.attach_obs()
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=2, policy="qos")
        svc.tracer = tracer
        svc.register("t", pkg.service.QosClass("t"))
        reqs = pkg.sim.synthetic(pkg.sim.TenantSpec(
            name="t", kind="uniform", n_ops=64, read_frac=0.5, arrival="closed",
            window=8, seed=3), 96)
        client = pkg.service.ClosedLoopClient(svc, "t", reqs, window=8)
        client.start(0.0)
        svc.drain()
        events = tracer.to_trace_events()
        pkg.obs.validate_trace_events(events)
        return pipe, svc, (events, client.done(), client.rejected)

    _, _, (events, done, rejected) = _both(run)
    assert done and rejected == 0
    begins = [e["name"] for e in events if e["ph"] == "b"]
    assert begins.count("io.request") == 64 and begins.count("device.service") == 64
    assert "sq.wait" in begins
    assert any(e["ph"] == "n" and e["name"] == "qos.dispatch" for e in events)


def test_slo_monitor_over_the_service_matches_reference():
    """``tests/test_obs.py``: an ``SloMonitor`` on the real block service,
    with a metrics sampler, shrinks the checkpoint class's share under
    pressure and restores it."""
    def run(pkg):
        res = pkg.scenario.checkpoint_under_serving(
            policy="qos", seed=0, restore_check=False, slo_objective_us=200.0,
            slo_kwargs=dict(SLO_KW), sampler_interval_us=100.0, **cpu(pkg))
        res.pop("sampler")
        return res

    a, b = run(JAX), run(PORT)
    assert same(a, b)
    s = b["slo"]
    assert s["n_shrinks"] > 0 and s["n_restores"] > 0
    assert 1 <= s["min_cap"] < s["default_cap"] and s["final_cap"] <= s["default_cap"]
    caps = [r["gauges"].get("class/ckpt/cap") for r in b["metrics_series"]]
    assert any(c is not None and c < s["default_cap"] for c in caps)
    PORT.obs.validate_metrics_series({"series": b["metrics_series"]})


def _cache_pipe(pkg, logical=256):
    cfg = pkg.array.ZapRaidConfig(scheme="raid5", n_drives=4, group_size=8, chunk_blocks=1,
                                  logical_blocks=logical, gc_free_segments_low=1, **cpu(pkg))
    zns = pkg.zns.ZnsConfig(n_zones=16, zone_cap_blocks=64, block_bytes=BB)
    pipe = pkg.handlers.HandlerPipeline.build_timed(cfg, zns, seed=5)
    pipe.attach_cache(pkg.cache.ZnsCacheTier(
        pkg.cache.CacheConfig(n_zones=4, zone_cap_blocks=64, block_bytes=BB), logical))
    rng = np.random.default_rng(5)
    pipe.precondition((lba, rng.integers(0, 256, (1, BB), dtype=np.uint8))
                      for lba in range(logical))
    return pipe


def test_dispatcher_bypasses_cache_hits_as_reference():
    def run(pkg):
        pipe = _cache_pipe(pkg)
        for _ in range(2):
            pipe.array.read(10, 8)
        pipe.precondition(())
        svc = pkg.service.BlockDeviceService(pipe, max_inflight=1, policy="qos")
        svc.register("t", pkg.service.LATENCY)
        reqs = [svc.submit_read("t", 10, 8, at=0.0), svc.submit_read("t", 100, 8, at=0.0)]
        svc.drain()
        return pipe, svc, _requests(reqs)

    pipe, svc, (hit, miss) = _both(run)
    assert hit["status"] == miss["status"] == "done"
    assert hit["bypass"] and not miss["bypass"] and svc.cache_bypasses == 1
    assert hit["t_done"] - hit["t_submit"] < miss["t_done"] - miss["t_submit"]
    assert hit["result"] == pipe.array.read(10, 8).tobytes()


def test_degraded_read_cache_warm_beats_cold_as_reference():
    out = {}
    for warm in (False, True):
        a, b = (pkg.scenario.degraded_read_cache(warm=warm, n_ops=200, **cpu(pkg))
                for pkg in (JAX, PORT))
        assert same(a, b)
        out[warm] = b
    cold, warm = out[False], out[True]
    assert warm["hit_rate"] > cold["hit_rate"] and warm["cache_bypasses"] > 0
    assert warm["p99_us"] * 2 <= cold["p99_us"]


# ---------------------------------------------------------------- launcher

def test_storage_sim_launcher_prints_the_reference_lines():
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    outs = []
    for run, argv in ((jserve.run, []), (tserve.run, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run(["--storage-sim", "--policy", "both", *argv])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    lines = outs[1].splitlines()
    assert len(lines) == 13 and "restore bit-identical: True" in lines[0]
    assert lines[-1] == "QoS cuts the serving tenant's read p99 by 12.9x vs FIFO"


def test_storage_sim_defaults_to_the_card(monkeypatch):
    import torch
    from repro_torch.launch import serve as tserve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run(["--storage-sim"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.scenario.read_qd_sweep(qds=(1,), n_ops=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.ckpt.CheckpointConfig()
