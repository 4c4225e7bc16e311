"""Canned multi-tenant scenarios over the block service.

Three scenarios shared by the serving launcher and ``chip_smoke.py``
(imported lazily by callers -- this module pulls in the checkpoint engine):

* :func:`read_qd_sweep` -- closed-loop read throughput vs offered queue
  depth: the saturation curve of the ZNS array (channel parallelism fills
  up, then the curve flattens);
* :func:`degraded_read_cache` -- latency-class reads against a
  one-drive-down array behind the cache tier, warm or cold;
* :func:`checkpoint_under_serving` -- the ML-cell workload: many simulated
  training jobs stream erasure-coded checkpoint saves through the service
  as throughput-class tenants while latency-class serving reads run
  alongside.  Run it once with ``policy="qos"`` and once with
  ``policy="fifo"`` to measure what admission control buys the serving
  tenant's tail.

Each takes ``device``, the device the array's stripe codec runs on
(``"cuda"`` by default; ``"cpu"`` runs the kernels' plain versions).  Virtual
time never depends on it: the same seed gives the same outputs on both.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.checkpoint.zapraid_ckpt import (
    MANIFEST_LBAS,
    CheckpointConfig,
    CheckpointEngine,
)
from repro_torch.core.handlers import HandlerPipeline
from repro_torch.service.dispatcher import BlockDeviceService, ClosedLoopClient
from repro_torch.service.qos import LATENCY, QosClass
from repro_torch.sim.workload import TenantSpec, synthetic


def _precondition_region(pipe, lo: int, n_blocks: int, *, seed: int,
                         extent: int = 256) -> None:
    """Install valid media under ``[lo, lo + n_blocks)`` outside the
    measured timeline, so read traffic hits mapped, reconstructable data."""
    bb = pipe.array.zns_cfg.block_bytes
    rng = np.random.default_rng(seed)

    def gen():
        lba = lo
        end = lo + n_blocks
        while lba < end:
            n = min(extent, end - lba)
            yield lba, rng.integers(0, 256, (n, bb), dtype=np.uint8)
            lba += n

    pipe.precondition(gen())


def read_qd_sweep(
    qds=(1, 2, 4, 8, 16, 32),
    *,
    n_ops: int = 192,
    logical_blocks: int = 4096,
    seed: int = 0,
    obs: bool = False,
    device: str = "cuda",
) -> list[dict]:
    """Closed-loop single-tenant read sweep; one fresh array per depth.

    Returns one row per queue depth: ``{"qd", "virtual_iops",
    "p50_us", "p99_us"}`` -- virtual-time figures, deterministic for a
    given seed.  With ``obs=True`` the full observability stack (span
    tracer on every layer + metrics sampler actor) rides along; the
    virtual-time figures must be identical either way, which is exactly
    what the ``obs/trace_overhead`` benchmark rows assert."""
    cfg = CheckpointConfig(zone_cap_blocks=2048, n_zones=32, device=device)
    rows = []
    for qd in qds:
        pipe = HandlerPipeline.build_timed(
            cfg.zap_cfg(logical_blocks), cfg.zns_cfg(), seed=seed,
            flush_interval_us=200.0,
        )
        _precondition_region(pipe, 0, logical_blocks, seed=seed + 1)
        svc = BlockDeviceService(pipe, max_inflight=max(64, qd), policy="fifo")
        if obs:
            from repro_torch.obs import (
                MetricsRegistry, MetricsSampler, standard_collector,
            )
            svc.tracer = pipe.attach_obs()
            sampler = MetricsSampler(
                pipe.engine, MetricsRegistry(),
                standard_collector(pipe, svc),
                interval_us=50.0, busy_fn=lambda s=svc: s._live > 0,
            )
            sampler.start(0.0)
        svc.register("sweep", QosClass("sweep"))
        reqs = synthetic(
            TenantSpec(name="sweep", kind="uniform", n_ops=n_ops,
                       read_frac=1.0, arrival="closed", window=qd, seed=seed),
            logical_blocks,
        )
        client = ClosedLoopClient(svc, "sweep", reqs, window=qd)
        client.start(0.0)
        svc.drain()
        assert client.done() and client.rejected == 0
        span = svc.recorder.span_us()
        pct = svc.recorder.percentiles(op="R")
        rows.append({
            "qd": qd,
            "virtual_iops": n_ops / span * 1e6 if span > 0 else 0.0,
            "p50_us": pct["p50"],
            "p99_us": pct["p99"],
        })
    return rows


def degraded_read_cache(
    *,
    warm: bool = True,
    kind: str = "hotspot",
    n_ops: int = 600,
    rate_iops: float = 60_000.0,
    logical_blocks: int = 2048,
    failed_drive: int = 1,
    cache_zones: int = 8,
    cache_zone_blocks: int = 32,
    burst_factor: float = 1.0,
    max_inflight: int = 8,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Latency-class reads against a one-drive-down array, with the ZNS
    cache tier warm (hot set resident before the failure) or cold.

    Cold, every read landing on the failed drive fans out into k survivor
    reads and the drive channels saturate; warm, the cache absorbs the hot
    set at cache-device latency and the residual misses see idle drives --
    the warm-vs-cold p99 gap is the figure the cache tier is for.  The same
    seeded address stream is measured in both modes, so the two rows differ
    only in cache state.  Returns virtual-time percentiles plus hit-rate
    and bypass counters."""
    from repro_torch.cache import CacheConfig, ZnsCacheTier

    cfg = CheckpointConfig(zone_cap_blocks=2048, n_zones=32, device=device)
    pipe = HandlerPipeline.build_timed(
        cfg.zap_cfg(logical_blocks), cfg.zns_cfg(), seed=seed,
        flush_interval_us=200.0,
    )
    cache = ZnsCacheTier(
        CacheConfig(n_zones=cache_zones, zone_cap_blocks=cache_zone_blocks,
                    block_bytes=cfg.block_bytes),
        logical_blocks,
    )
    pipe.attach_cache(cache)
    _precondition_region(pipe, 0, logical_blocks, seed=seed + 1)

    reqs = synthetic(
        TenantSpec(name="serve", kind=kind, n_ops=n_ops,
                   rate_iops=rate_iops, read_frac=1.0,
                   burst_factor=burst_factor, seed=seed),
        logical_blocks,
    )
    if warm:
        # replay the address stream functionally (outside the measured
        # timeline) twice: the second pass clears the admission sketch's
        # touch threshold for every block of the working set
        for _ in range(2):
            for r in reqs:
                pipe.array.read(r.lba, r.n_blocks)
        # discard warm-up timing/stats; the cache *contents* survive
        pipe.precondition(())

    pipe.array.fail_drive(failed_drive)
    svc = BlockDeviceService(pipe, max_inflight=max_inflight, policy="qos")
    svc.register("serve", LATENCY)
    for r in reqs:
        svc.submit_read("serve", r.lba, r.n_blocks, at=r.t_us)
    svc.drain()
    pct = svc.recorder.percentiles(op="R", tenant="serve")
    return {
        "warm": warm,
        "kind": kind,
        "p50_us": pct["p50"],
        "p99_us": pct["p99"],
        "n": pct["n"],
        "hit_rate": cache.stats.hit_rate(),
        "cache_bypasses": svc.cache_bypasses,
        # tier-level counters cover the measured window only (warm-up stats
        # are discarded by precondition)
        "cache_hits": int(cache.stats.hits),
        "cache_misses": int(cache.stats.misses),
    }


def checkpoint_under_serving(
    *,
    policy: str = "qos",
    n_jobs: int = 4,
    n_saves: int = 2,
    ckpt_interval_us: float = 2_000.0,
    leaf_blocks: int = 4,
    n_leaves: int = 12,
    serve_ops: int = 500,
    serve_rate_iops: float = 40_000.0,
    max_inflight: int = 8,
    seed: int = 0,
    restore_check: bool = True,
    slo_objective_us: Optional[float] = None,
    slo_kwargs: Optional[dict] = None,
    tracer=None,
    sampler_interval_us: Optional[float] = None,
    device: str = "cuda",
) -> dict:
    """Checkpoint traffic at scale under latency-sensitive serving.

    ``n_jobs`` training jobs share one timed array, each confined to its
    own LBA window, and stream ``n_saves`` erasure-coded checkpoints
    through the service as throughput-class tenants (class-wide in-flight
    cap = half the window, so checkpoint bursts can never occupy every
    dispatcher slot).  Meanwhile an open-loop Poisson stream of
    latency-class reads models serving traffic against a preconditioned
    region.  Returns per-tenant latency/figures plus the save tickets'
    resolution times; with ``restore_check`` the last checkpoint of job 0
    is also restored through the service and verified bit-identical.

    Observability options (repro_torch.obs): ``slo_objective_us`` arms an
    :class:`~repro_torch.obs.SloMonitor` protecting the serving tenant's p99 by
    dynamically shrinking/restoring the checkpoint class's in-flight share
    (result gains an ``"slo"`` summary); ``tracer`` threads a span tracer
    through every layer; ``sampler_interval_us`` attaches a metrics
    sampler (result gains ``"metrics_series"``).
    """
    cfg = CheckpointConfig(zone_cap_blocks=2048, n_zones=32, device=device)
    serve_blocks = 1024
    job_span = MANIFEST_LBAS + 512
    logical_blocks = serve_blocks + n_jobs * job_span

    pipe = HandlerPipeline.build_timed(
        cfg.zap_cfg(logical_blocks), cfg.zns_cfg(), seed=seed,
        flush_interval_us=200.0,
    )
    engine = pipe.engine
    _precondition_region(pipe, 0, serve_blocks, seed=seed + 7)

    svc = BlockDeviceService(pipe, max_inflight=max_inflight, policy=policy)
    monitor = sampler = None
    registry = None
    if tracer is not None:
        pipe.attach_obs(tracer)
        svc.tracer = tracer
    if slo_objective_us is not None or sampler_interval_us is not None:
        from repro_torch.obs import MetricsRegistry
        registry = MetricsRegistry()
    if sampler_interval_us is not None:
        from repro_torch.obs import MetricsSampler, standard_collector
        sampler = MetricsSampler(
            engine, registry, standard_collector(pipe, svc),
            interval_us=sampler_interval_us,
            busy_fn=lambda: svc._live > 0,
        )
        sampler.start(0.0)
    if slo_objective_us is not None:
        from repro_torch.obs import SloMonitor
        monitor = SloMonitor(
            svc, "serve", slo_objective_us, klass="ckpt",
            registry=registry, **(slo_kwargs or {}),
        )
        monitor.start(0.0)
    svc.register("serve", LATENCY)
    ckpt_qos = QosClass("ckpt", priority=2, max_inflight=max(2, max_inflight // 2))
    engines = []
    for j in range(n_jobs):
        svc.register(f"job{j}", ckpt_qos)
        engines.append(CheckpointEngine(
            cfg, logical_blocks, array=pipe.array,
            lba_base=serve_blocks + j * job_span, lba_span=job_span,
        ))

    # training state per job: a few leaves, each ``leaf_blocks`` blocks
    rng = np.random.default_rng(seed + 11)
    n_f32 = leaf_blocks * cfg.block_bytes // 4
    states = [
        {f"layer{i}": rng.standard_normal(n_f32).astype(np.float32)
         for i in range(n_leaves)}
        for _ in range(n_jobs)
    ]

    # serving traffic: open-loop latency-class reads
    for r in synthetic(
        TenantSpec(name="serve", kind="hotspot", n_ops=serve_ops,
                   rate_iops=serve_rate_iops, read_frac=1.0, seed=seed),
        serve_blocks,
    ):
        svc.submit_read("serve", r.lba, r.n_blocks, at=r.t_us)

    # checkpoint traffic: every job saves on a fixed cadence (staggered)
    tickets = []
    for j in range(n_jobs):
        for i in range(n_saves):
            t = 100.0 + j * (ckpt_interval_us / n_jobs) + i * ckpt_interval_us
            engine.at(t, lambda j=j, i=i: tickets.append(
                engines[j].save_async(i, states[j], service=svc,
                                      tenant=f"job{j}")
            ))
    svc.drain()
    assert len(tickets) == n_jobs * n_saves
    assert all(t.done for t in tickets)

    restore_ok = None
    if restore_check:
        rt = engines[0].restore_async(
            n_saves - 1, states[0], service=svc, tenant="job0"
        )
        svc.drain()
        assert rt.done
        restore_ok = all(
            np.array_equal(np.asarray(rt.state[k]), states[0][k])
            for k in states[0]
        )

    serve = svc.recorder.percentiles(op="R", tenant="serve")
    saves = np.array([t.latency_us for t in tickets])
    out = {
        "policy": policy,
        "serve_p50_us": serve["p50"],
        "serve_p99_us": serve["p99"],
        "serve_n": serve["n"],
        "ckpt_save_mean_us": float(saves.mean()),
        "ckpt_save_max_us": float(saves.max()),
        "restore_ok": restore_ok,
        "summary": svc.summary(),
    }
    if monitor is not None:
        out["slo"] = monitor.summary()
        out["slo_actions"] = monitor.actions
    if sampler is not None:
        out["metrics_series"] = sampler.series
        out["sampler"] = sampler
    return out
