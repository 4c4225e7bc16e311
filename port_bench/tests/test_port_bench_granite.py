"""The granite-4.0-h cell's own pieces without a card: its driver end to end
on the CPU at a small size (the run, a fault, the control), the weights it
draws, its FLOP and byte counts by hand and against the model's leaves, the
three MoE readers on events made by hand, and a reference that takes
nothing of the port."""
import dataclasses

import pytest
import torch

from port_bench import common, faults, flops, run
from port_bench import trace as tr
from port_bench.drivers import hybrid_moe_prefill as drv
from port_bench.tests.test_port_bench_isolation import BENCH_DIR, _imports
from port_bench.tests.test_port_bench_run import BENCH, small
from port_bench.tests.test_port_bench_run import _jax_of_other_tests  # noqa: F401 (autouse)

WORKLOAD = "granite-4.0-h-small.prefill-4x4k"
MOE, MOE_EXPERTS = "repro_torch.moe", "repro_torch.moe_experts"
READERS = ("moe_share.prefill", "moe_experts_roofline.prefill", "moe_launches.prefill")


def test_the_cell_runs_its_driver_through_serve():
    cell = small(WORKLOAD)
    assert cell.traffic["driver"] == "hybrid_moe_prefill"
    rec = drv.run(cell, 0.0)
    assert rec.driver == "prefill" and rec.work > 0 and rec.units > 0
    # float32 on both sides: the plain paths agree to rounding
    assert set(rec.numbers) == {"logits", "cache", "token_gap"}
    assert all(v < 1e-4 for v in rec.numbers.values()), rec.numbers


def test_swapped_rows_is_not_correct():
    rc, line = run.run_cell(small(WORKLOAD), BENCH, fault=faults.PREFILL["swapped_rows"])
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("fault", sorted(drv.FAULTS))
def test_a_moe_fault_is_not_correct(fault):
    """Routed experts dropped, or every slot sent to the next expert: the
    cell's limits see the MoE, and the program's routing is back after."""
    from repro_torch.models import layers

    route = layers.moe_route
    rc, line = run.run_cell(small(WORKLOAD), BENCH, fault=drv.FAULTS[fault])
    assert rc == 0 and line["correct"] is False and line["failed"] >= 1
    assert layers.moe_route is route


def test_the_control_is_not_correct():
    """The reference in fp8 in the program's place fails the cell's limits.
    Its error grows with depth, so the cell runs 24 layers (attention at
    layers 5 and 15, the preset's spacing) at width 128."""
    cell = small(WORKLOAD)
    model = dict(cell.config["model"], n_layers=24, d_model=128, vocab=4096, ssm_state=32,
                 layer_types=["attention" if i in (5, 15) else "mamba" for i in range(24)])
    cell = dataclasses.replace(cell, config=dict(cell.config, model=model),
                               traffic=dict(cell.traffic, prompt_len=256))
    rec = drv.run(cell, 0.0, control=True)
    ok, _ = common.judge(rec.notes["control"], cell.limits)
    assert not ok


def test_a_traced_cpu_run_holds_the_programs_spans(monkeypatch):
    """The traced line on the CPU (the profiler on the CPU alone, so no
    device work): only the cell's per-layer names, and the trace holds the
    serve loop's, the Mamba-2 blocks', attention's and the MoE's spans."""
    from port_bench import spans as sp

    traces = []

    def capture(fn):
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(tr.WINDOW):
                fn()
        traces.append(tr.reduce(*tr.events_of(prof)))
        return traces[-1]

    monkeypatch.setattr(tr, "capture", capture)
    rc, line = run.run_cell(small(WORKLOAD, trace=True), BENCH)
    assert rc == 0 and line["correct"] is True
    assert set(line["metrics"]) <= {m["name"] for m in common.metrics_for(BENCH, WORKLOAD, True)}
    opened = {h.name for h in traces[0].hosts} & (set(sp.NAMES) | {MOE, MOE_EXPERTS})
    assert opened == {sp.SERVE, sp.PREFILL, sp.MAMBA, sp.ATTENTION, MOE, MOE_EXPERTS}


def test_weights_follow_the_seed_and_the_published_inits():
    from repro_torch.models.model import meta_model

    cfg = common.port_config(small(WORKLOAD).config)
    a, b, c = (drv.make_weights(cfg, s, "cpu") for s in (5, 5, 6))
    leaves = common.flat(meta_model(cfg).tree())
    assert set(a) == set(leaves)
    for name, like in leaves.items():
        assert a[name].shape == like.shape and a[name].dtype == like.dtype, name
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["layers.moe.w_gate"], c["layers.moe.w_gate"])
    dt = torch.nn.functional.softplus(a["mamba.dt_bias"])
    assert bool(((dt > 1e-3 * 0.999) & (dt < 1e-1 * 1.001)).all())
    assert bool(((a["mamba.a_log"].exp() >= 1) & (a["mamba.a_log"].exp() <= 16)).all())
    assert bool((a["layers.ln1"] == 1).all()) and bool((a["mamba.conv_b"] == 0).all())
    std = float(a["layers.moe.w_gate"].std()) * cfg.d_model ** 0.5
    assert 0.9 < std < 1.1  # N(0, 1 / fan_in)
    assert 0.9 < float(a["embed"].std()) / drv.EMBED_STD < 1.1


def test_projection_counts_match_the_models_leaves():
    from repro_torch.models.model import meta_model

    cfg = common.config("granite-4.0-h-small")
    m = cfg["model"]
    leaves = common.flat(meta_model(common.port_config(cfg)).tree())
    mamba = sum(leaves[f"mamba.{k}"].numel()
                for k in ("w_z", "w_x", "w_b", "w_c", "w_dt", "w_out")) // 36
    assert flops.layer_matmul_params(m) == mamba
    attn = sum(leaves[f"attn.{k}"].numel() for k in ("wq", "wk", "wv", "wo")) // 4
    assert drv.attention_matmul_params(m) == attn
    experts = sum(leaves[f"layers.moe.{k}"].numel() for k in ("w_gate", "w_in", "w_out"))
    shared = sum(v.numel() for k, v in leaves.items() if k.startswith("layers.moe.shared."))
    per_layer = (leaves["layers.moe.router"].numel() + experts * 10 // 72 + shared) // 40
    assert drv.moe_active_params(m) == per_layer


def test_prefill_flops_at_the_cells_shape():
    """17.1 GFLOP per prompt token at 4,096, of which the MoE layers take
    about 53% and the Mamba-2 projections about 43%."""
    m = common.config("granite-4.0-h-small")["model"]
    t = 4096
    per_token = drv.prefill_flops_per_token(m, t)
    by_hand = (2 * (36 * flops.layer_matmul_params(m) + 4 * drv.attention_matmul_params(m)
                    + 40 * drv.moe_active_params(m))
               + (2 * 4096 * 100352 + 36 * flops.ssd_fwd_flops(1, 128, t, 128, 128, 64)
                  + 4 * flops.attention_flops(t, 32, 128)) / t)
    assert per_token == pytest.approx(by_hand)
    assert abs(per_token / 1e9 - 17.1) < 0.05
    assert 0.52 < 2 * 40 * drv.moe_active_params(m) / per_token < 0.54
    assert 0.42 < 2 * 36 * flops.layer_matmul_params(m) / per_token < 0.44


def test_moe_expert_counts_by_hand():
    m = dict(d_model=2, d_ff=3, n_experts=4, top_k=2, shared_expert_ff=1, ssm_expand=2,
             ssm_head_dim=1, ssm_state=1, ssm_chunk=1, vocab=1, n_layers=1, n_heads=1,
             n_kv_heads=1, layer_types=["mamba"])
    # 5 tokens x 2 slots, each through 3 projections of 2 x 3
    assert drv.moe_experts_flops(m, 5) == 2 * 3 * 2 * 3 * 5 * 2
    # 4 experts' 3 x 2 x 3 weights once, 10 rows of 2 in and out, 2 bytes each
    assert drv.moe_experts_bytes(m, 5, 2) == (4 * 3 * 2 * 3 + 2 * 10 * 2) * 2


# ------------------------------------------------------------------ readers

def _moe_trace():
    """One prefill with two MoE layers on thread 1: the first holds a router
    op and its experts' span with two products (whose kernels overlap), the
    second an experts' span with one product; an attention op outside."""
    hosts = [tr.Host(0, 1000, tr.WINDOW, 1, 1), tr.Host(10, 900, "repro_torch.serve", 1, 2),
             tr.Host(100, 300, MOE, 1, 3), tr.Host(110, 120, "aten::mm", 1, 4),
             tr.Host(130, 250, MOE_EXPERTS, 1, 5), tr.Host(140, 150, "aten::mm", 1, 6),
             tr.Host(160, 170, "aten::mm", 1, 7), tr.Host(400, 600, MOE, 1, 8),
             tr.Host(420, 500, MOE_EXPERTS, 1, 9), tr.Host(430, 440, "aten::mm", 1, 10),
             tr.Host(700, 710, "aten::bmm", 1, 11)]
    devices = [tr.Device(115, 135, "router", 4), tr.Device(145, 185, "gemm", 6),
               tr.Device(165, 205, "gemm", 7), tr.Device(435, 475, "gemm", 10),
               tr.Device(705, 745, "attention", 11)]
    return hosts, devices


def _record(hosts, devices, driver="prefill", least=None) -> common.Record:
    rec = common.Record(driver=driver, setup_s=0.0, window_s=1.0, work=0, units=0,
                        peak_bytes=0, flops_per_token=0.0, numbers={},
                        trace=tr.reduce(hosts, devices), traced_units=1)
    if least is not None:
        rec.notes["moe_experts_least_s"] = least
    return rec


def test_the_moe_readers_on_a_trace_made_by_hand():
    rec = _record(*_moe_trace(), least=30e-9)
    busy = 20 + (205 - 145) + 40 + 40  # the two overlapping products count once
    assert rec.trace.busy_s == pytest.approx(busy * 1e-9)
    moe = 20 + (205 - 145) + 40
    assert common.reader("moe_share.prefill")(rec) == pytest.approx(100 * moe / busy)
    assert common.reader("moe_launches.prefill")(rec) == pytest.approx(4 / 2)
    # two experts' spans of 30 ns least each, over 40 + 40 + 40 ns of their kernels
    assert common.reader("moe_experts_roofline.prefill")(rec) == pytest.approx(100 * 60 / 120)


@pytest.mark.parametrize("name", READERS)
def test_a_moe_reader_finds_nothing_without_its_span(name):
    """The parent program has no MoE spans, and a train record none of
    them: every reader returns None."""
    hosts = [tr.Host(0, 100, tr.WINDOW, 1, 1), tr.Host(10, 20, "aten::mm", 1, 2)]
    devices = [tr.Device(15, 40, "gemm", 2)]
    assert common.reader(name)(_record(hosts, devices, least=1e-9)) is None
    assert common.reader(name)(_record(*_moe_trace(), driver="train", least=1e-9)) is None


def test_the_roofline_needs_the_drivers_least_time():
    assert common.reader("moe_experts_roofline.prefill")(_record(*_moe_trace())) is None


def test_the_program_spells_the_moe_spans_alike():
    from repro_torch.obs import spans

    assert (spans.MOE, spans.MOE_EXPERTS) == spans.MOE_NAMES == (MOE, MOE_EXPERTS)


def test_the_reference_takes_nothing_of_the_port():
    names = _imports(BENCH_DIR / "reference" / "granite_hybrid.py")
    tops = {n.split(".")[0] for n in names}
    assert tops <= {"__future__", "dataclasses", "math", "torch", "port_bench"}, tops
    assert all(n.startswith("port_bench.reference") for n in names if n.startswith("port_bench"))
    assert not any(n.split(".")[0] in ("jax", "jaxlib", "flax", "repro", "repro_torch")
                   for n in names)
