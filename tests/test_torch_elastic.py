"""The port's elastic runtime (``distributed/elastic.py``) against the JAX
package's: the re-mesh plans of ``tests/test_distributed.py``, the group
commit scheduler's statistics equal to the last bit, and the committed
``straggler/G*`` rows of ``BENCH_PR10.json`` (``benchmarks/run.py``
``bench_straggler``) from the port's scheduler."""
import dataclasses
import json
from pathlib import Path

import pytest

from _port import JAX, PORT

_BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_PR10.json").read_text())


def _remesh(pkg):
    rt = pkg.elastic.ElasticRuntime(n_hosts=32, chips_per_host=16, model_parallel=16)
    out = [rt.plan_mesh(), rt.on_failure([3, 7]), rt.on_join(3), rt.plan_mesh()]
    for r in range(32):
        rt.table.heartbeat(r, now=0.0 if r % 5 else 10.0)
    dead = rt.table.sweep(now=35.0, timeout=30.0)
    out += [dead, rt.table.healthy(), rt.on_failure(dead), rt.generation]
    return out


def test_remesh_after_failures_matches_reference():
    a, b = _remesh(JAX), _remesh(PORT)
    assert a == b
    assert b[0] == (32, 16)
    assert b[1]["mesh"] == (16, 16) and b[1]["healthy_hosts"] == 30
    assert b[1]["action"] == "restore_from_checkpoint_and_rejit"
    assert b[3] == (16, 16)


def _stats(pkg, n_workers, straggle_p, straggle_factor, seed, steps, groups):
    sched = pkg.elastic.GroupCommitScheduler(n_workers=n_workers, straggle_p=straggle_p,
                                             straggle_factor=straggle_factor, seed=seed)
    return ({g: sched.simulate(steps=steps, group_size=g) for g in groups},
            {g: sched.commit_table_bits(g) for g in groups})


def test_group_commit_matches_reference():
    args = (64, 0.05, 5.0, 3, 256, (1, 4, 16, 64))
    (ra, ba), (rb, bb) = _stats(JAX, *args), _stats(PORT, *args)
    assert {g: dataclasses.astuple(s) for g, s in ra.items()} == \
        {g: dataclasses.astuple(s) for g, s in rb.items()}
    assert {g: s.speedup for g, s in ra.items()} == {g: s.speedup for g, s in rb.items()}
    assert ba == bb
    assert rb[1].speedup == pytest.approx(1.0, abs=1e-6)
    assert rb[4].speedup > 1.05 and rb[16].speedup > rb[4].speedup
    assert rb[64].speedup >= rb[16].speedup * 0.95
    assert bb[16] == 64 * 16 * 4


def test_straggler_rows():
    (ra, ba), (rb, bb) = (_stats(pkg, 256, 0.03, 6.0, 1, 512, (1, 4, 16, 64))
                          for pkg in (JAX, PORT))
    assert {g: dataclasses.astuple(s) for g, s in ra.items()} == \
        {g: dataclasses.astuple(s) for g, s in rb.items()}
    for g, res in rb.items():
        assert _BENCH[f"straggler/G{g}"]["derived"] == \
            f"speedup={res.speedup:.3f}_cst_bits={bb[g]}"
