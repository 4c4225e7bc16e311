"""The benchmark's FLOP and byte functions against hand counts, and the
trace reduction on events made by hand."""
import pytest

from port_bench import common, flops
from port_bench import trace as tr


def test_ssd_forward_flops_by_hand():
    # b=1, h=1, t=4, q=2, n=1, p=1: two chunks, each with a 3-entry triangle:
    # C B^T 2*3*1, the triangle times dt*x 2*3*1, C h_prev and the update 4*2*1*1.
    assert flops.ssd_fwd_flops(1, 1, 4, 2, 1, 1) == 2 * (6 + 6 + 8)
    # heads share C B^T: a second head adds only its own products
    assert flops.ssd_fwd_flops(1, 2, 4, 2, 1, 1) == 2 * (6 + 2 * (6 + 8))


def test_ssd_backward_flops_by_hand():
    # per chunk: C B^T 2*3*n; per head 4*3*p + 4*3*n + 8*q*n*p
    assert flops.ssd_bwd_flops(1, 1, 4, 2, 1, 1) == 2 * (6 + 12 + 12 + 16)
    assert flops.ssd_bwd_flops(2, 1, 2, 2, 3, 5) == 2 * 2 * 3 * 3 + 2 * (4 * 3 * 5 + 4 * 3 * 3
                                                                       + 8 * 2 * 3 * 5)


def test_ssd_bytes_by_hand():
    b, h, t, q, n, p = 2, 3, 8, 4, 5, 7
    x, bc, dt, a = b * t * h * p, 2 * b * t * n, b * t * h, h
    y, hf, states = b * t * h * p, b * h * n * p, b * (t // q) * h * n * p
    assert flops.ssd_fwd_bytes(b, h, t, q, n, p, 2, False) == 2 * (x + bc) + 4 * (dt + a) + \
        4 * (y + hf)
    assert flops.ssd_fwd_bytes(b, h, t, q, n, p, 2, True) == 2 * (x + bc) + 4 * (dt + a) + \
        4 * (y + hf + states)
    ins = 2 * (x + bc) + 4 * (dt + a) + 4 * y + 4 * states
    assert flops.ssd_bwd_bytes(b, h, t, q, n, p, 2) == ins + 2 * (x + bc) + 4 * (dt + a)


def test_least_time_is_the_larger_bound():
    assert flops.least_s(989e12, 0) == pytest.approx(1.0)
    assert flops.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert flops.least_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_attention_flops_by_hand():
    # t=2: 3 causal pairs, QK^T and PV 2*hd each, per head
    assert flops.attention_flops(2, 4, 8) == 3 * 2 * 2 * 8 * 4


@pytest.mark.parametrize("name", ["mamba2-1.3b", "zamba2-2.7b"])
def test_projection_weights_match_the_models_leaves(name):
    from repro_torch.models.model import meta_model

    cfg = common.config(name)
    leaves = common.flat(meta_model(common.port_config(cfg)).tree())
    layers = cfg["model"]["n_layers"]
    per_layer = sum(leaves[f"layers.block.{k}"].numel()
                    for k in ("w_z", "w_x", "w_b", "w_c", "w_dt", "w_out")) // layers
    assert flops.layer_matmul_params(cfg["model"]) == per_layer
    shared = sum(v.numel() for k, v in leaves.items()
                 if k.startswith(("shared.attn.", "shared.mlp.")))
    assert flops.shared_matmul_params(cfg["model"]) == shared


def test_step_flops_compose():
    m = common.config("mamba2-1.3b")["model"]
    t = 2048
    proj = 48 * flops.layer_matmul_params(m) + 2048 * 50280
    h = 4096 // 64
    ssd = 48 * (flops.ssd_fwd_flops(1, h, t, 128, 128, 64) + flops.ssd_bwd_flops(1, h, t, 128, 128, 64))
    assert flops.train_flops_per_token(m, t) == pytest.approx(6 * proj + ssd / t)
    z = common.config("zamba2-2.7b")["model"]
    pre = (2 * (54 * flops.layer_matmul_params(z) + 9 * flops.shared_matmul_params(z))
           + (2 * 2560 * 32000 + 54 * flops.ssd_fwd_flops(1, 80, 4096, 128, 64, 64)
              + 9 * flops.attention_flops(4096, 32, 80)) / 4096)
    assert flops.prefill_flops_per_token(z, 4096) == pytest.approx(pre)


# ------------------------------------------------------------------ trace

def _events():
    # main thread 1: the window 0..100, a step 10..90 holding an op 20..30 and
    # a span 40..80 that holds an op 50..60 and a nested op of the same name
    hosts = [tr.Host(0, 100, tr.WINDOW, 1, 1), tr.Host(10, 90, "bench.step", 1, 2),
             tr.Host(20, 30, "aten::mm", 1, 3), tr.Host(40, 80, "bench.apply", 1, 4),
             tr.Host(50, 60, "my::op", 1, 5), tr.Host(52, 58, "my::op", 1, 6),
             tr.Host(62, 70, "my::op", 1, 7),
             # another thread (autograd): an op with the same times as nothing above
             tr.Host(20, 40, "my::op", 2, 8)]
    devices = [tr.Device(22, 35, "gemm", 3), tr.Device(30, 45, "gemm", 3),
               tr.Device(53, 57, "k1", 6), tr.Device(63, 66, "k2", 7),
               tr.Device(41, 44, "k3", 8), tr.Device(95, 120, "late", 3)]
    return hosts, devices


def test_busy_is_the_union_inside_the_window():
    t = tr.reduce(*_events())
    # [22, 45) [53, 57) [63, 66) [95, 100)
    assert t.busy == [(22, 45), (53, 57), (63, 66), (95, 100)]
    assert t.busy_s == pytest.approx((23 + 4 + 3 + 5) * 1e-9)
    assert t.window_s == pytest.approx(100e-9)


def test_device_time_under_ops_and_spans():
    t = tr.reduce(*_events())
    assert t.device_s("my::op") == pytest.approx((4 + 3 + 3) * 1e-9)
    assert t.device_s("bench.apply") == pytest.approx((4 + 3) * 1e-9)
    assert t.device_s("aten::mm") == pytest.approx((13 + 15 + 25) * 1e-9)
    assert t.calls("my::op") == 3  # 50..60 (holding 52..58), 62..70, and thread 2's
    assert t.top_device_ops(2) == [["gemm", pytest.approx(28e-9)], ["late", pytest.approx(25e-9)]]


def test_idle_gaps_by_the_innermost_span():
    t = tr.reduce(*_events())
    gaps = dict(t.idle_gaps())
    # a gap is named by the span open where it starts:
    # [0,22) -> window; [45,53) -> bench.apply; [57,63) -> bench.apply;
    # [66,95) -> bench.apply (66 < 80)
    assert gaps[tr.WINDOW] == pytest.approx(22e-9)
    assert gaps["bench.apply"] == pytest.approx((8 + 6 + 29) * 1e-9)


def test_a_trace_needs_one_window():
    hosts, devices = _events()
    with pytest.raises(RuntimeError):
        tr.reduce(hosts[1:], devices)
