"""Run one cell of the port's benchmark once and print its result line.

  python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix; the traffic file names the driver (``drivers/``).  The run
draws weights and inputs from ``--seed``, warms up on the cell's shapes,
measures for ``--seconds``, checks what the timed path produced against
the plain reference (``reference/``), and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``,
each compared number beside its limit (also the last lines of standard
error).  It exits non-zero and prints no result without the cards, or if
JAX or the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# The port builds its kernels into build/repro_torch/ of the checkout; any
# CUDA JIT cache goes beside it, at a fixed path.
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "port_bench" / "cuda_cache"))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(cell, rec, bench: dict) -> tuple[dict, list[str]]:
    """(the result line, the check lines for standard error)."""
    import torch

    from port_bench import common

    correct, checks = common.judge(rec.numbers, cell.limits)
    metrics = {}
    for m in common.metrics_for(bench, cell.workload, cell.trace):
        value = common.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(cell.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": rec.peak_bytes}
    line = {"correct": correct, "attempted": rec.units,
            "failed": sum(1 for c in checks.values()
                          if not isinstance(c["value"], float) or c["value"] > c["limit"]),
            "metrics": metrics, "device": device}
    if rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        line["breakdown"] = {"device_ops": rec.trace.top_device_ops(),
                             "idle_gaps": rec.trace.idle_gaps()}
    line["checks"] = checks
    lines = [f"check {name}: {c['value']} (limit {c['limit']})" for name, c in checks.items()]
    return line, lines


def run_cell(cell, bench: dict, *, fault=None) -> tuple[int, dict | None]:
    """Drive ``cell`` and print its result; (exit code, result line)."""
    from port_bench import common

    rec = common.driver(cell.traffic["driver"]).run(cell, T_START, fault=fault)
    line, lines = result(cell, rec, bench)
    bad = common.forbidden_modules()
    if bad:
        print(f"port_bench: JAX or the JAX package is loaded: {bad}", file=sys.stderr)
        return 3, None
    print(json.dumps({k: v for k, v in rec.notes.items() if k not in ("program", "reference")}),
          file=sys.stderr)
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0, line


def main(argv=None) -> int:
    args = parse(argv)
    import repro_torch  # noqa: F401  (the program under test: without it, no run)
    import torch

    from port_bench import common

    bench = common.spec()
    w = common.workload(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"port_bench: {w['name']} needs {w['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = common.Cell(workload=w["name"], config=common.config(w["config"]),
                       traffic=common.traffic(w["traffic"]), limits=common.limits(w["name"]),
                       seed=args.seed, seconds=args.seconds, trace=bool(args.trace))
    return run_cell(cell, bench)[0]


if __name__ == "__main__":
    sys.exit(main())
