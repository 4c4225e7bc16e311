"""The readings that a cell's limits are set from, in one process on the card.

  python3 port_bench/calibrate.py --workload <name> --seeds 1,2,... \\
      [--control-seeds 1,2,3] [--faults half_batch] [--fault-seeds 1,2,3] \\
      [--seconds 0.1] > readings.jsonl

For each seed: the program's numbers (a run of the cell with a short
window: training's numbers come from set-up, prefill's from the window's
kept call), on ``--control-seeds`` also the control's (the reference in
fp8, put in the program's place), and on ``--fault-seeds`` the numbers of
each fault of ``faults.py`` planted under the timed path.  One JSON line
per reading on standard output.  The benchmark's own runs
never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.1)
    args = ap.parse_args(argv)

    import torch

    from port_bench import common, faults

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    w = common.workload(args.workload)
    tr = common.traffic(w["traffic"])
    drv = common.driver(tr["driver"])
    table = faults.TRAIN if tr["driver"] == "train" else faults.PREFILL

    def emit(row):
        print(json.dumps(row), flush=True)

    def cell(seed):
        return common.Cell(workload=w["name"], config=common.config(w["config"]), traffic=tr,
                           limits=common.limits(w["name"]), seed=seed, seconds=args.seconds,
                           trace=False)

    controls, fault_seeds = set(ints(args.control_seeds)), set(ints(args.fault_seeds))
    seeds = ints(args.seeds) + sorted((controls | fault_seeds) - set(ints(args.seeds)))
    for seed in seeds:
        t = time.perf_counter()
        rec = drv.run(cell(seed), t, control=seed in controls)
        emit({"seed": seed, "kind": "program", "numbers": rec.numbers,
              "s": time.perf_counter() - t})
        if seed in controls:
            emit({"seed": seed, "kind": "control", "numbers": rec.notes["control"]})
        for name in (x for x in args.faults.split(",") if x):
            if seed in fault_seeds:
                rec = drv.run(cell(seed), time.perf_counter(), fault=table[name])
                emit({"seed": seed, "kind": f"fault:{name}", "numbers": rec.numbers})
        del rec
        common.free(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
