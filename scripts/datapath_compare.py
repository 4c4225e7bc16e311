#!/usr/bin/env python3
"""Time the storage datapath of one or more trees of the port, in turns,
on one GPU.

For each source directory given (a checkout's ``src``), in the order given,
a fresh process imports that tree's ``repro_torch`` with this checkout's
``chip_smoke.py`` and runs the per-stripe codec round trips
(``chip_smoke.codec_round_trips``) and ``chip_smoke.py``'s phases 2-4
(RAID-5, RAID-6 and crash recovery at the full geometry, same seeds).  Each
phase prints its ``chip_smoke`` JSON line; each tree ends with one line
holding its round trips, each phase's wall seconds, the process's CPU
seconds in it (all threads) and its involuntary context switches (the
host's other load), and the codec launches.  To compare a
change with its parent on one card, unpack the parent (``git archive``)
into a git-ignored directory and alternate them::

    python3 scripts/datapath_compare.py build/parent/src src src build/parent/src
"""
from __future__ import annotations

import gc
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(tree: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import CODEC_KERNELS, launch_counts, reset_launch_counts

    trips = {k: v["us"] for k, v in cs.codec_round_trips().items()}
    phases = {}
    reset_launch_counts()
    runs = (("raid5", lambda ph: cs.raid_end_to_end("raid5", "cuda", cs.FULL, cs.SEED, ph)),
            ("raid6", lambda ph: cs.raid_end_to_end("raid6", "cuda", cs.FULL, cs.SEED, ph)),
            ("crash", lambda ph: cs.crash_recovery("cuda", cs.FULL, cs.SEED, ph)))
    for name, run in runs:
        t, cpu = time.perf_counter(), time.process_time()
        preempted = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
        with cs.Phase(name) as ph:
            run(ph)
        phases[name] = {
            "wall_s": time.perf_counter() - t, "cpu_s": time.process_time() - cpu,
            "involuntary_switches":
                resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw - preempted,
            **{k: v for k, v in ph.info.items() if k.endswith("_s")}}
        gc.collect()
    counts = launch_counts()
    print(json.dumps({"tree": tree, "round_trips_us": trips, "phases": phases,
                      "launches": {k: counts[k] for k in CODEC_KERNELS}}), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        res = subprocess.run([sys.executable, __file__, "--one", tree], env=env, cwd=ROOT)
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
