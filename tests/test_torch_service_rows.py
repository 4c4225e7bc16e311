"""The committed rows of the block service, the cache tier over it and the
observability layer (``BENCH_PR10.json``'s ``service/*``, ``cache/*`` and
``obs/*``), reproduced by the port on the CPU.

Each row runs as the reference's ``benchmarks/run.py --quick`` runs it
(``bench_service``, ``bench_cache``, ``bench_obs``), through the reference and
through the port from the same seeds: the two outputs must be equal, and the
port's row -- its value rounded to 0.01 µs and its derived string, as the
benchmark writes them -- must equal the committed one.  Every value is
virtual time of the device model, the same on any backend.
"""
import json
from pathlib import Path

import pytest

from _port import JAX, PORT, cpu, same

_BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_PR10.json").read_text())
SLO_KW = dict(window_us=1500.0, interval_us=250.0, min_samples=8)
QUICK_OPS = 96  # bench_service / bench_obs under --quick


def bench(name):
    """A committed row: (us_per_call, derived)."""
    return _BENCH[name]["us_per_call"], _BENCH[name]["derived"]


def _both(fn):
    """``fn(pkg)`` through both packages; the outputs must be equal.
    Returns the port's."""
    a, b = fn(JAX), fn(PORT)
    assert same(a, b)
    return b


@pytest.mark.parametrize("qd", [1, 4, 16, 32])
def test_qd_sweep_row(qd):
    (row,) = _both(lambda pkg: pkg.scenario.read_qd_sweep(qds=(qd,), n_ops=QUICK_OPS,
                                                          **cpu(pkg)))
    assert bench(f"service/qd_sweep_qd{qd}") == (
        round(row["p99_us"], 2), f"virtual_iops={row['virtual_iops']:.0f}")


def _ckpt_vs_serve(pkg, policy, **kw):
    res = pkg.scenario.checkpoint_under_serving(policy=policy, **kw, **cpu(pkg))
    res.pop("sampler", None)
    return res


@pytest.mark.parametrize("policy", ["qos", "fifo"])
def test_ckpt_vs_serve_row(policy):
    res = _both(lambda pkg: _ckpt_vs_serve(pkg, policy))
    assert res["restore_ok"] is True
    assert bench(f"service/ckpt_vs_serve_p99_{policy}") == (
        round(res["serve_p99_us"], 2),
        f"ckpt_save_mean={res['ckpt_save_mean_us']:.0f}us_restore_ok={res['restore_ok']}")


def _healthy_cache(pkg, kind, burst_factor):
    """``bench_cache``'s healthy run: a cache tier on the scenario geometry,
    300 reads of ``kind`` at 40 k IOPS."""
    cfg = pkg.ckpt.CheckpointConfig(zone_cap_blocks=2048, n_zones=32, **cpu(pkg))
    pipe = pkg.handlers.HandlerPipeline.build_timed(
        cfg.zap_cfg(2048), cfg.zns_cfg(), seed=7, flush_interval_us=200.0)
    cache = pkg.cache.ZnsCacheTier(pkg.cache.CacheConfig(
        n_zones=8, zone_cap_blocks=32, block_bytes=cfg.block_bytes), 2048)
    pipe.attach_cache(cache)
    pkg.scenario._precondition_region(pipe, 0, 2048, seed=8)
    rec = pipe.replay(pkg.sim.synthetic(pkg.sim.TenantSpec(
        name="c", kind=kind, n_ops=300, rate_iops=40_000, read_frac=1.0,
        burst_factor=burst_factor, seed=9), 2048))
    return rec.percentiles(op="R"), cache.stats.hit_rate()


@pytest.mark.parametrize("kind,burst,label", [("zipf", 1.0, "zipf"), ("hotspot", 1.0, "hotspot"),
                                              ("hotspot", 3.0, "bursty")])
def test_cache_hit_row(kind, burst, label):
    p, hr = _both(lambda pkg: _healthy_cache(pkg, kind, burst))
    assert bench(f"cache/hit_{label}_p99") == (
        round(p["p99"], 2), f"hit_rate={hr:.2f}_p50={p['p50']:.1f}us")


@pytest.mark.parametrize("warm", [False, True])
def test_cache_degraded_row(warm):
    res = _both(lambda pkg: pkg.scenario.degraded_read_cache(warm=warm, n_ops=600, **cpu(pkg)))
    if warm:
        want = ("cache/degraded_warm_p99",
                f"hit_rate={res['hit_rate']:.2f}_bypasses={res['cache_bypasses']}")
    else:
        want = ("cache/degraded_cold_p99", f"hit_rate={res['hit_rate']:.2f}_n={res['n']}")
    assert bench(want[0]) == (round(res["p99_us"], 2), want[1])


@pytest.mark.parametrize("qd", [4, 16])
def test_trace_overhead_row(qd):
    def run(pkg):
        kw = dict(qds=(qd,), n_ops=QUICK_OPS, **cpu(pkg))
        return pkg.scenario.read_qd_sweep(**kw), pkg.scenario.read_qd_sweep(obs=True, **kw)

    (plain,), (traced,) = _both(run)
    delta = abs(traced["virtual_iops"] - plain["virtual_iops"]) / max(plain["virtual_iops"], 1e-9)
    assert delta == 0.0
    assert bench(f"obs/trace_overhead_qd{qd}") == (
        round(traced["p99_us"], 2),
        f"iops_delta={delta * 100:.2f}pct_of_{plain['virtual_iops']:.0f}")


def test_slo_admission_rows():
    """``bench_obs``'s SLO pair, with ``tests/test_obs.py``'s checks: the
    monitor cuts the serving p99 below the static run's, and checkpoint
    traffic still completes, later."""
    static = _both(lambda pkg: _ckpt_vs_serve(pkg, "qos", seed=0, restore_check=False))
    dyn = _both(lambda pkg: _ckpt_vs_serve(pkg, "qos", seed=0, restore_check=False,
                                           slo_objective_us=150.0, slo_kwargs=dict(SLO_KW)))
    s = dyn["slo"]
    assert bench("obs/slo_admission_static") == (
        round(static["serve_p99_us"], 2), f"ckpt_save_max={static['ckpt_save_max_us']:.0f}us")
    assert bench("obs/slo_admission_slo") == (
        round(dyn["serve_p99_us"], 2),
        f"cap_{s['default_cap']}to{s['min_cap']}_shrinks={s['n_shrinks']}"
        f"_restores={s['n_restores']}")
    assert static["serve_p99_us"] > 150.0
    assert dyn["serve_p99_us"] < static["serve_p99_us"] and s["n_shrinks"] > 0
    assert dyn["ckpt_save_max_us"] >= static["ckpt_save_max_us"]
