"""Observability end to end on the PyTorch/CUDA port: span traces, metric
time-series, SLO control.

``examples/trace_and_metrics.py`` on ``repro_torch``, the obs layer over the
checkpoint-under-serving scenario:

1. run the scenario *static* (fixed per-class in-flight shares) to get the
   baseline serving p99 under checkpoint pressure;
2. run it again with a span ``Tracer`` threaded through every layer, a
   ``MetricsSampler`` recording the metric catalog every 100 virtual
   microseconds, and an ``SloMonitor`` protecting the serving tenant's
   windowed p99 by shrinking (and later restoring) the checkpoint class's
   in-flight share;
3. export ``out/port_trace.json`` (open it at https://ui.perfetto.dev or
   chrome://tracing) and ``out/port_metrics.json``, validating both with
   the port's schema checkers;
4. print the static-vs-SLO serving p99 comparison and the monitor's
   actuation history.

The figures are virtual time; the array's stripe codec runs on ``--device``
(``cuda`` by default, or ``cpu``).  ``--out`` names the output directory.

Run: PYTHONPATH=src python examples/port_trace_and_metrics.py [--device cpu]
"""
import argparse
import json
import os

from repro_torch.obs import Tracer, validate_metrics_series, validate_trace_events
from repro_torch.service.scenario import checkpoint_under_serving

OBJECTIVE_US = 150.0
SLO_KW = dict(window_us=1500.0, interval_us=250.0, min_samples=8)
OUT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "out"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    print("checkpoint-under-serving, static admission (baseline):")
    static = checkpoint_under_serving(policy="qos", seed=0,
                                      restore_check=False, device=args.device)
    print(f"  serve p50={static['serve_p50_us']:6.1f}us  "
          f"p99={static['serve_p99_us']:6.1f}us  "
          f"ckpt save max={static['ckpt_save_max_us']:7.1f}us")

    print(f"\nsame scenario, SLO monitor (objective p99 <= {OBJECTIVE_US:.0f}us)"
          " + tracer + sampler:")
    tracer = Tracer()
    dyn = checkpoint_under_serving(
        policy="qos", seed=0, restore_check=False,
        slo_objective_us=OBJECTIVE_US, slo_kwargs=dict(SLO_KW),
        tracer=tracer, sampler_interval_us=100.0, device=args.device,
    )
    print(f"  serve p50={dyn['serve_p50_us']:6.1f}us  "
          f"p99={dyn['serve_p99_us']:6.1f}us  "
          f"ckpt save max={dyn['ckpt_save_max_us']:7.1f}us")
    slo = dyn["slo"]
    print(f"  SLO: cap {slo['default_cap']} -> min {slo['min_cap']} "
          f"(final {slo['final_cap']}), {slo['n_shrinks']} shrinks / "
          f"{slo['n_restores']} restores over {slo['ticks']} ticks")
    for a in dyn["slo_actions"]:
        print(f"    t={a['t_us']:7.1f}us  cap={a['cap']}  "
              f"window p99={a['p99_us']:6.1f}us (n={a['n']})")
    print(f"  serving p99 recovered "
          f"{static['serve_p99_us'] / dyn['serve_p99_us']:.2f}x vs static")

    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, "port_trace.json")
    metrics_path = os.path.join(args.out, "port_metrics.json")
    info = tracer.export(trace_path)
    dyn.pop("sampler").to_json(metrics_path)
    with open(trace_path) as f:
        validate_trace_events(json.load(f)["traceEvents"])
    with open(metrics_path) as f:
        validate_metrics_series(json.load(f))
    print(f"\n  wrote {trace_path} ({info['events']} events, "
          f"{info['dropped']} dropped) -- open at https://ui.perfetto.dev")
    print(f"  wrote {metrics_path} "
          f"({len(dyn['metrics_series'])} samples) -- both schema-validated")
    static.pop("sampler", None)
    return {"static": static, "slo": dyn, "trace_events": info["events"],
            "trace_dropped": info["dropped"]}


if __name__ == "__main__":
    main()
