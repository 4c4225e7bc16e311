#!/usr/bin/env python3
"""Time mamba2-1.3b's training at full width for one or more trees of the
port, in turns, on one GPU.

For each source directory given (a checkout's ``src``), in the order given,
a fresh process imports that tree's ``repro_torch`` with this checkout's
``chip_smoke.py``, builds the kernels and runs its ``mamba2_train`` phase
(``TRAIN``: 4 steps of 4 x 1,024 tokens through ``launch.train.run``, one
step profiled), and prints one JSON line: the tree, the step times, the
steady step, trained tokens/s, peak device memory, the profiled step's
wall and device ms, and the losses.  To compare a change with its parent on
one card, unpack the parent (``git archive``) into a git-ignored directory
and alternate them::

    python3 scripts/train_compare.py build/parent/src src src build/parent/src
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(tree: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, reset_launch_counts

    _build.build()
    _build.load()
    reset_launch_counts()
    with cs.Phase("mamba2_train") as ph:
        cs.mamba2_train(ph)
    info = ph.info
    prof = info.get("profile") or {}
    print(json.dumps({"tree": tree, "step_ms": info["step_ms"],
                      "steady_step_ms": info["steady_step_ms"],
                      "trained_tok_s": info["trained_tok_s"],
                      "peak_mem_bytes": info["peak_mem_bytes"],
                      "profile_wall_ms": prof.get("wall_ms"),
                      "profile_device_ms": prof.get("device_ms"),
                      "losses": info["losses"]}), flush=True)


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
