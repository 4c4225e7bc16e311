"""The readers of the program's spans (``port_bench/spans.py`` and the
metrics that use it) on events made by hand, and a traced run on the CPU
that holds the program's spans and prints only the cell's metrics."""
import pytest

from port_bench import common, run
from port_bench import spans as sp
from port_bench import trace as tr
from port_bench.tests.test_port_bench_run import BENCH, TRAIN, WORKLOADS, small
from port_bench.tests.test_port_bench_run import _jax_of_other_tests  # noqa: F401 (autouse)

NEW = ("forward_ms.train", "backward_ms.train", "remat_ms.train", "launches.train",
       "attention_share.prefill", "mamba_outside_scan_share.prefill",
       "mamba_launches.prefill", "serve_idle_ms.prefill")
MS = 1e-6   # one ns in ms


def _record(driver: str, hosts, devices, units: int = 2) -> common.Record:
    return common.Record(driver=driver, setup_s=0.0, window_s=1.0, work=0, units=0,
                         peak_bytes=0, flops_per_token=0.0, numbers={},
                         trace=tr.reduce(hosts, devices), traced_units=units)


def _train():
    """Thread 1 opens the forward (an op, and a Mamba-2 block holding an op),
    waits inside the backward, and runs AdamW; thread 2, autograd's, runs
    the backward: an op, a recomputed block holding an op, another op."""
    hosts = [tr.Host(0, 1000, tr.WINDOW, 1, 1), tr.Host(10, 100, sp.FORWARD, 1, 2),
             tr.Host(20, 30, "aten::mm", 1, 3), tr.Host(40, 80, sp.MAMBA, 1, 4),
             tr.Host(50, 60, "aten::mul", 1, 5), tr.Host(100, 400, sp.BACKWARD, 1, 6),
             tr.Host(400, 500, sp.ADAMW, 1, 7), tr.Host(410, 420, "aten::add", 1, 8),
             tr.Host(110, 120, "aten::mm", 2, 9), tr.Host(150, 250, sp.MAMBA, 2, 10),
             tr.Host(160, 170, "aten::mul", 2, 11), tr.Host(300, 310, "my::bwd", 2, 12)]
    devices = [tr.Device(25, 45, "gemm", 3), tr.Device(55, 75, "mul", 5),
               tr.Device(115, 140, "gemm", 9), tr.Device(165, 200, "mul", 11),
               tr.Device(305, 330, "bwd", 12), tr.Device(415, 460, "add", 8)]
    return hosts, devices


def _prefill():
    """Two batches of the serve loop: the first's prefill holds a Mamba-2
    block (an op and the SSD scan's operator), an attention application and
    a second block; the loop's own op and sync follow; the second batch's
    prefill holds one block."""
    hosts = [tr.Host(0, 1000, tr.WINDOW, 1, 1), tr.Host(10, 500, sp.SERVE, 1, 2),
             tr.Host(20, 300, sp.PREFILL, 1, 3), tr.Host(30, 100, sp.MAMBA, 1, 4),
             tr.Host(35, 40, "aten::mm", 1, 5), tr.Host(50, 60, sp.SCAN, 1, 6),
             tr.Host(52, 55, "aten::empty", 1, 7), tr.Host(110, 150, sp.ATTENTION, 1, 8),
             tr.Host(115, 120, "aten::bmm", 1, 9), tr.Host(160, 200, sp.MAMBA, 1, 10),
             tr.Host(165, 170, "aten::mm", 1, 11), tr.Host(310, 320, "aten::copy_", 1, 12),
             tr.Host(600, 900, sp.SERVE, 1, 13), tr.Host(610, 700, sp.PREFILL, 1, 14),
             tr.Host(620, 680, sp.MAMBA, 1, 15), tr.Host(630, 640, "aten::mm", 1, 16)]
    devices = [tr.Device(40, 60, "gemm", 5), tr.Device(60, 90, "ssd_scan_kernel", 7),
               tr.Device(120, 150, "bmm", 9), tr.Device(170, 200, "gemm", 11),
               tr.Device(320, 330, "copy", 12), tr.Device(640, 700, "gemm", 16)]
    return hosts, devices


def _read(name: str, rec) -> float | None:
    return common.reader(name)(rec)


def test_during_counts_autograds_thread_and_nested_does_not():
    t = tr.reduce(*_train())
    assert sp.device_s(sp.during(t, sp.BACKWARD)) == pytest.approx((25 + 35 + 25) * 1e-9)
    assert sp.nested(t, sp.BACKWARD) == []           # thread 2's ops nest under no span of 1
    assert t.device_s(sp.BACKWARD) == 0.0            # the trace's own rule agrees
    assert sp.device_s(sp.during(t, sp.FORWARD)) == pytest.approx(40e-9)
    assert sp.device_s(sp.nested(t, sp.FORWARD)) == pytest.approx(40e-9)
    rec = _record("train", *_train())
    assert _read("forward_ms.train", rec) == pytest.approx(40 * MS / 2)
    assert _read("backward_ms.train", rec) == pytest.approx(85 * MS / 2)
    assert _read("launches.train", rec) == pytest.approx(6 / 2)


def test_remat_is_the_blocks_that_begin_inside_the_backward():
    t = tr.reduce(*_train())
    assert sp.device_s(sp.nested(t, sp.MAMBA)) == pytest.approx((20 + 35) * 1e-9)
    assert sp.device_s(sp.nested(t, sp.MAMBA, began_during=sp.BACKWARD)) == \
        pytest.approx(35e-9)
    assert _read("remat_ms.train", _record("train", *_train())) == pytest.approx(35 * MS / 2)


def test_the_scan_inside_a_block_is_left_out_of_its_glue():
    rec = _record("prefill", *_prefill())
    t = rec.trace
    busy = 20 + 30 + 30 + 30 + 10 + 60
    assert t.busy_s == pytest.approx(busy * 1e-9)
    assert sp.device_s(sp.nested(t, sp.MAMBA)) == pytest.approx((20 + 30 + 30 + 60) * 1e-9)
    assert sp.device_s(sp.nested(t, sp.MAMBA, outside=sp.SCAN)) == \
        pytest.approx((20 + 30 + 60) * 1e-9)
    assert _read("mamba_outside_scan_share.prefill", rec) == pytest.approx(100 * 110 / busy)
    assert _read("mamba_launches.prefill", rec) == pytest.approx(4 / 3)
    assert _read("attention_share.prefill", rec) == pytest.approx(100 * 30 / busy)


def test_a_serve_gap_counts_outside_the_prefill_only():
    rec = _record("prefill", *_prefill())
    # gaps: [0,40) before any serve span; [90,120), [150,170), [200,320)
    # begin inside a prefill; [330,640) begins in the first serve span after
    # its prefill, [700,1000) in the second's, as its prefill closes
    assert sp.gaps(rec.trace) == [(0, 40), (90, 120), (150, 170), (200, 320), (330, 640),
                                  (700, 1000)]
    assert sp.serve_idle_s(rec.trace) == pytest.approx((310 + 300) * 1e-9)
    assert _read("serve_idle_ms.prefill", rec) == pytest.approx(610 * MS / 2)


def test_union_counts_overlap_once_inside_the_window():
    t = tr.reduce([tr.Host(10, 100, tr.WINDOW, 1, 1)], [])
    devs = [tr.Device(0, 30, "a", 0), tr.Device(20, 40, "b", 0), tr.Device(35, 38, "c", 0),
            tr.Device(90, 120, "d", 0)]
    assert sp.union_s(t, devs) == pytest.approx((30 + 10) * 1e-9)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_its_span(name):
    """The parent program has no spans: the trace holds the window, an op and
    its kernel, and every new reader returns None, in either driver."""
    hosts = [tr.Host(0, 100, tr.WINDOW, 1, 1), tr.Host(10, 20, "aten::mm", 1, 2)]
    devices = [tr.Device(15, 40, "gemm", 2)]
    for driver in ("train", "prefill"):
        assert _read(name, _record(driver, hosts, devices)) is None
    assert _read(name, _record("train" if name.endswith(".prefill") else "prefill",
                               *(_prefill() if name.endswith(".train") else _train()))) is None


def test_the_names_are_the_programs():
    from repro_torch.obs import spans as program

    assert sp.NAMES == program.NAMES


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_cpu_run_holds_the_programs_spans(workload, monkeypatch):
    """The traced line on the CPU (the profiler on the CPU alone, so no
    device work): only the cell's per-layer names, and the trace holds the
    program's spans of the cell's layers."""
    traces = []

    def capture(fn):
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(tr.WINDOW):
                fn()
        traces.append(tr.reduce(*tr.events_of(prof)))
        return traces[-1]

    monkeypatch.setattr(tr, "capture", capture)
    rc, line = run.run_cell(small(workload, trace=True), BENCH)
    assert rc == 0 and line["correct"] is True
    names = {m["name"] for m in common.metrics_for(BENCH, workload, trace=True)}
    assert set(line["metrics"]) <= names
    opened = {h.name for h in traces[0].hosts} & set(sp.NAMES)
    if workload in TRAIN:
        assert opened == {sp.FORWARD, sp.BACKWARD, sp.ADAMW, sp.MAMBA}
    else:
        hybrid = common.config(common.workload(workload, BENCH)["config"])["model"]["family"]
        assert opened == {sp.SERVE, sp.PREFILL, sp.MAMBA} | \
            ({sp.ATTENTION} if hybrid == "hybrid" else set())
