"""Checkpoint traffic at scale under latency-sensitive serving, on the
PyTorch/CUDA port.

``examples/ckpt_under_serving.py`` on ``repro_torch``, the service tier end
to end at API level:

1. build a timed ZapRAID pipeline and wrap it in the async
   ``BlockDeviceService`` (submission queues + dispatcher + completion
   queue; acks fire at device-completion times on the virtual clock);
2. register a latency-class "serve" tenant and several throughput-class
   training jobs, each with its own ``CheckpointEngine`` window on the
   shared array;
3. stream concurrent checkpoint saves through the service while serving
   reads run alongside, then restore one job's checkpoint through the
   same path and verify it bit-identical;
4. print the per-tenant queue-wait/service split and the QoS-vs-FIFO
   p99 comparison.

The figures are virtual time; the array's stripe codec runs on ``--device``
(``cuda`` by default, or ``cpu``).

Run: PYTHONPATH=src python examples/port_ckpt_under_serving.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.checkpoint.zapraid_ckpt import (
    MANIFEST_LBAS,
    CheckpointConfig,
    CheckpointEngine,
)
from repro_torch.core.handlers import HandlerPipeline
from repro_torch.core.zns import drive_images
from repro_torch.service import LATENCY, BlockDeviceService, QosClass
from repro_torch.service.scenario import _precondition_region
from repro_torch.sim.workload import TenantSpec, synthetic

N_JOBS = 3


def run(policy: str, device: str) -> dict:
    cfg = CheckpointConfig(zone_cap_blocks=2048, n_zones=32, device=device)
    serve_blocks = 1024
    span = MANIFEST_LBAS + 512
    logical = serve_blocks + N_JOBS * span

    pipe = HandlerPipeline.build_timed(cfg.zap_cfg(logical), cfg.zns_cfg(),
                                       seed=0, flush_interval_us=200.0)
    _precondition_region(pipe, 0, serve_blocks, seed=7)

    svc = BlockDeviceService(pipe, max_inflight=8, policy=policy)
    svc.register("serve", LATENCY)
    ckpt_qos = QosClass("ckpt", priority=2, max_inflight=4)
    jobs = []
    for j in range(N_JOBS):
        svc.register(f"job{j}", ckpt_qos)
        jobs.append(CheckpointEngine(cfg, logical, array=pipe.array,
                                     lba_base=serve_blocks + j * span,
                                     lba_span=span))

    # serving traffic: open-loop latency-class reads over the hot region
    for r in synthetic(TenantSpec(name="serve", kind="hotspot", n_ops=400,
                                  rate_iops=40_000.0, read_frac=1.0),
                       serve_blocks):
        svc.submit_read("serve", r.lba, r.n_blocks, at=r.t_us)

    # checkpoint traffic: every job saves twice on a staggered cadence
    rng = np.random.default_rng(11)
    states = [
        {f"layer{i}": rng.standard_normal(4096).astype(np.float32)
         for i in range(12)}
        for _ in range(N_JOBS)
    ]
    tickets = []
    for j in range(N_JOBS):
        for step in range(2):
            t = 100.0 + j * 700.0 + step * 2_000.0
            pipe.engine.at(t, lambda j=j, s=step: tickets.append(
                jobs[j].save_async(s, states[j], service=svc,
                                   tenant=f"job{j}")))
    svc.drain()
    assert all(t.done for t in tickets)

    # restore job 0's last checkpoint through the same service path
    rt = jobs[0].restore_async(1, states[0], service=svc, tenant="job0")
    svc.drain()
    assert all(np.array_equal(np.asarray(rt.state[k]), states[0][k])
               for k in states[0])

    serve = svc.recorder.percentiles(op="R", tenant="serve")
    stages = svc.recorder.summary()["tenants"]["serve"]["stage_means_us"]
    saves = [t.latency_us for t in tickets]
    print(f"[{policy:4s}] serve p50 {serve['p50']:7.1f}us  "
          f"p99 {serve['p99']:7.1f}us  "
          f"(queue-wait {stages['queue_wait_us']:.1f}us / "
          f"service {stages['service_us']:.1f}us) | "
          f"ckpt save mean {np.mean(saves):7.1f}us | "
          f"restore bit-identical, resolved at t={rt.t_done:.0f}us")
    return {"p99": serve["p99"], "serve": serve, "stages": stages, "saves_us": saves,
            "restore_t_done": rt.t_done, "media": drive_images(pipe.array.drives)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    res = {pol: run(pol, args.device) for pol in ("qos", "fifo")}
    print(f"QoS cuts the serving tenant's read p99 by "
          f"{res['fifo']['p99'] / res['qos']['p99']:.1f}x vs FIFO")
    return res


if __name__ == "__main__":
    main()
