"""The rest of a run without a card: each driver at a small size on the CPU
(the port's plain paths, float32), the reference against it, the result
line, and the check failing under each fault and under the control."""
import dataclasses
import json

import pytest

from port_bench import common, faults, run
from port_bench.drivers import prefill, train

BENCH = common.spec()
SEED = 2 ** 31 + 11


def small(workload: str, *, trace: bool = False) -> common.Cell:
    """The cell at a smoke size of its configuration, float32, on the CPU."""
    from repro_torch.models.config import smoke

    w = common.workload(workload, BENCH)
    cfg = common.config(w["config"])
    cfg = dict(cfg, model=dataclasses.asdict(smoke(common.port_config(cfg))))
    tr = dict(common.traffic(w["traffic"]))
    if tr["driver"] == "train":
        tr.update(batch=4, seq_len=32, pool=4)
    else:
        tr.update(batch=2, prompt_len=32, pool=2, warmup_calls=1)
    return common.Cell(workload=w["name"], config=cfg, traffic=tr,
                       limits=common.limits(w["name"]), seed=SEED, seconds=0.2, trace=trace,
                       device="cpu")


@pytest.fixture(autouse=True)
def _jax_of_other_tests(monkeypatch):
    """A test worker may hold JAX from the package's own tests: the run's
    check then counts only what the run itself loads."""
    before = set(common.forbidden_modules())
    loaded = common.forbidden_modules
    monkeypatch.setattr(common, "forbidden_modules",
                        lambda: [m for m in loaded() if m not in before])


WORKLOADS = [w["name"] for w in BENCH["workloads"]]
TRAIN = [w for w in WORKLOADS if common.traffic(common.workload(w, BENCH)["traffic"])["driver"]
         == "train"]
PREFILL = [w for w in WORKLOADS if w not in TRAIN]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_run_is_correct_and_prints_the_line(workload, capsys):
    rc, line = run.run_cell(small(workload), BENCH)
    assert rc == 0 and line["correct"] is True
    out = capsys.readouterr()
    printed = json.loads(out.out.strip().splitlines()[-1])
    assert list(printed) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert printed["attempted"] > 0 and printed["failed"] == 0
    names = {m["name"] for m in common.metrics_for(BENCH, workload, trace=False)}
    assert set(printed["metrics"]) == names
    for m in printed["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(printed["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    tail = out.err.strip().splitlines()[-len(printed["checks"]):]
    for text, (name, c) in zip(tail, printed["checks"].items()):
        assert text == f"check {name}: {c['value']} (limit {c['limit']})"
    # float32 on both sides: the plain paths agree to rounding
    assert all(c["value"] < 1e-4 for c in printed["checks"].values())


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
@pytest.mark.parametrize("workload", TRAIN)
def test_a_train_fault_is_not_correct(workload, fault, capsys):
    rc, line = run.run_cell(small(workload), BENCH, fault=faults.TRAIN[fault])
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("fault", sorted(faults.PREFILL))
@pytest.mark.parametrize("workload", PREFILL)
def test_a_prefill_fault_is_not_correct(workload, fault, capsys):
    rc, line = run.run_cell(small(workload), BENCH, fault=faults.PREFILL[fault])
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    """The reference in fp8 in the program's place fails the cell's limits.
    A prefill's error grows with depth, so its cell runs 24 layers here."""
    cell = small(workload)
    drv = train if workload in TRAIN else prefill
    if drv is prefill:
        model = dict(cell.config["model"], n_layers=24, d_model=128, vocab=4096, ssm_state=32)
        cell = dataclasses.replace(cell, config=dict(cell.config, model=model),
                                   traffic=dict(cell.traffic, prompt_len=256))
    rec = drv.run(cell, 0.0, control=True)
    ok, _ = common.judge(rec.notes["control"], cell.limits)
    assert not ok


def test_traced_line_carries_the_device_window_and_breakdown(monkeypatch, capsys):
    """The traced line's keys, with the profiler on the CPU alone."""
    from port_bench import trace as tracing

    def capture(fn):
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(tracing.WINDOW):
                fn()
        return tracing.reduce(*tracing.events_of(prof))

    monkeypatch.setattr(tracing, "capture", capture)
    rc, line = run.run_cell(small(TRAIN[0], trace=True), BENCH)
    assert rc == 0
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in common.metrics_for(BENCH, TRAIN[0], trace=True)}
    assert set(line["metrics"]) <= names
