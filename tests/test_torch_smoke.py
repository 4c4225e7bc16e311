"""``chip_smoke.py``'s reading of a kernel's SASS, on hand-written listings
in ``cuobjdump -sass`` form (the card's toolkit is not here): the count of
ALU instructions that sets the operations half of each codec kernel's bound,
and the tensor-core instructions the SSD kernels must hold.  Also the SSD
scan's FLOP and byte counts (``kernels/ssd_scan.py``) that its bounds read."""
import importlib.util
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as ssd

_ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listing(fragment, body):
    lines = [f"\t\tFunction : _ZN12_GLOBAL__N_{fragment}EEvPKiPi"]
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/ {ins} ; /* 0x0 */")
    return "\n".join(lines) + "\n"


def _sass(loop_body):
    xor = [
        "S2R R0, SR_TID.X",
        "LDG.E.128.CONSTANT R4, desc[UR4][R2.64]",  # 0x10: 2 loads per pass
        "LDG.E.128.CONSTANT R8, desc[UR4][R6.64]",
        "LOP3.LUT R12, R4, R8, R12, 0x96, !PT",
        "IADD3 R2, P0, R2, 0x40, RZ",
        "VIADD R1, R1, 0x2",
        "ISETP.GE.AND P1, PT, R1, UR5, PT",
        "@!P1 BRA 0x10",
        "EXIT",
    ]
    gf = ["S2R R0, SR_TID.X",
          "LDG.E.128.CONSTANT R4, desc[UR4][R2.64]", *loop_body, "@P0 BRA 0x10",
          "STG.E.128 desc[UR4][R6.64], R8",
          "ISETP.NE.AND P2, PT, R0, RZ, PT",
          "@P2 BRA 0x0",  # an outer loop with no more loads is not the main one
          "EXIT"]
    return (_listing("17xor_reduce_kernelILb1E", xor)
            + _listing("19gf256_matmul_kernelILb1E", gf))


def test_alu_ops_per_row_load_counts_the_main_loop(monkeypatch):
    smoke = _smoke()
    body = ["LDS R9, [R10]", "LOP3.LUT R8, R4, R9, R8, 0x78, !PT",
            "SHF.R.U32.HI R11, RZ, 0x7, R4", "IMAD R11, R11, 0x1d, RZ",
            "UIADD3 UR4, UR4, 0x1, URZ", "LEA R2, P1, R3, R2, 0x2"]
    sass = _sass(body)
    seen = []
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/bin/nvcc")

    def run(cmd, **_):
        seen.append(cmd)
        return types.SimpleNamespace(stdout=sass)

    monkeypatch.setattr(subprocess, "run", run)
    got = smoke.alu_ops_per_row_load(Path("libcodec.so"))
    assert seen == [["/toolkit/bin/cuobjdump", "-sass", "libcodec.so"]]
    # XOR: LOP3, IADD3 and ISETP over 2 loads (VIADD, S2R and BRA not ALU)
    # GF: LOP3, SHF and LEA over 1 load (IMAD, UIADD3 and LDS are not ALU)
    assert got == {"xor_reduce": 1.5, "gf256_matmul": 3.0}


def test_alu_ops_per_row_load_raises_without_the_kernel(monkeypatch):
    smoke = _smoke()
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    sass = _listing("17xor_reduce_kernelILb1E", ["EXIT"])
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=sass))
    with pytest.raises(RuntimeError, match="no loop"):
        smoke.alu_ops_per_row_load(Path("libcodec.so"))


_SCAN = "115ssd_scan_kernelI13__nv_bfloat16Lb1EEEvNS_7SsdArgsE"
_GRAM = "121ssd_chunk_gram_kernelIfLb0EEEvNS_7SsdArgsE"


def _ssd_listing(name, body):
    return _listing(name, body).replace("EEvPKiPi", "")


def test_tensor_core_instructions_counts_hmma(monkeypatch):
    smoke = _smoke()
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    sass = (_ssd_listing(_SCAN, ["LDSM.16.MT88.4 R4, [R2]",
                                 "HMMA.16816.F32.BF16 R8, R4, R12, R8",
                                 "HMMA.16816.F32.BF16 R16, R4, R14, R16", "EXIT"])
            + _ssd_listing(_GRAM, ["HMMA.16816.F32.BF16 R8, R4, R12, RZ", "EXIT"])
            + _listing("17xor_reduce_kernelILb1E", ["LOP3.LUT R1, R2, R3, R4, 0x96, !PT"]))
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=sass))
    assert smoke.tensor_core_instructions(Path("lib.so")) == {
        "ssd_scan_kernel<bf16,async>": 2, "ssd_chunk_gram_kernel<f32,scalar>": 1}


def test_tensor_core_instructions_raises_on_fma_only_kernels(monkeypatch):
    smoke = _smoke()
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    sass = _ssd_listing(_SCAN, ["FFMA R1, R2, R3, R1", "EXIT"])
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=sass))
    with pytest.raises(RuntimeError, match="tensor-core"):
        smoke.tensor_core_instructions(Path("lib.so"))


def test_ssd_flops_count_g_once_per_batch_row():
    """G = C B^T is shared by the heads of a batch row: adding heads adds
    only their own products."""
    q, n, p, nc = 128, 128, 64, 8
    tri = q * (q + 1) // 2
    per_head = nc * (2 * tri * p + 4 * q * n * p)
    assert ssd.ssd_flops(4, 1, 1024, q, n, p) == 4 * (nc * 2 * tri * n + per_head)
    assert ssd.ssd_flops(4, 64, 1024, q, n, p) - ssd.ssd_flops(4, 1, 1024, q, n, p) \
        == 4 * 63 * per_head


def test_ssd_tensor_flops_at_the_serving_shape():
    """1,312 m16n8k16 products per block and chunk -- C h_prev over 8 x 8
    tiles, M X over the triangle's 36 and the state update over 8 x 8, each
    with two halves on four 8-column tiles: (64 + 36 + 64) x 8 -- and 576
    per G (36 tiles x 8 x 2), 4,096 FLOP each."""
    blocks, chunks, batch = 4 * 64 * 2, 8, 4
    assert ssd.ssd_tensor_flops(4, 64, 1024, 128, 128, 64) \
        == 4096 * chunks * (blocks * 1312 + batch * 576)
    # f32 inputs take three products where bf16 takes two (one for G)
    assert ssd.ssd_tensor_flops(1, 1, 128, 128, 128, 32, f32=True) == 4096 * (1968 + 1728)


_XOR2 = "17stripe_xor_kernelILi2ELb1E"
_GF22 = "19stripe_gf256_kernelILi2ELi2ELb1E"


def _stripe_sass(xor_body):
    loads_first = ["LDG.E.128 R4, desc[UR4][R20.64]", "LDG.E.128 R8, desc[UR4][R22.64]",
                   "LOP3.LUT R12, R4, R8, RZ, 0x96, !PT", "STG.E.128 desc[UR4][R24.64], R12",
                   "EXIT"]
    return (_listing(_XOR2, xor_body) + _listing(_GF22, loads_first)
            # the runtime (k = 0) and scalar (Lb0E) instances are not read
            + _listing("17stripe_xor_kernelILi0ELb1E", ["LDG.E.128 R4, desc[UR4][R20.64]",
                                                        "LOP3.LUT R8, R4, RZ, RZ, 0x3c, !PT"])
            + _listing("17stripe_xor_kernelILi2ELb0E", ["LDG.E R4, desc[UR4][R20.64]"]))


def _stripe_loads(monkeypatch, sass, instances):
    smoke = _smoke()
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=sass))
    monkeypatch.setattr(smoke, "STRIPE_INSTANCES", frozenset(instances))
    return smoke.stripe_loads_first(Path("lib.so"))


def test_stripe_loads_first_passes_when_every_load_precedes_the_combine(monkeypatch):
    body = ["LDG.E.128 R4, desc[UR4][R20.64]", "IADD3 R22, P0, R20, UR6, RZ",
            "LDG.E.128 R8, desc[UR4][R22.64]", "LOP3.LUT R12, R4, R8, RZ, 0x96, !PT",
            "STG.E.128 desc[UR4][R24.64], R12", "EXIT"]
    got = _stripe_loads(monkeypatch, _stripe_sass(body),
                        ["stripe_xor<k=2>", "stripe_gf256<k=2,m=2>"])
    assert got == {"stripe_xor<k=2>": "2/2", "stripe_gf256<k=2,m=2>": "2/2"}


@pytest.mark.parametrize("body,match", [
    # the first row's lanes combined before the second load is issued
    (["LDG.E.128 R4, desc[UR4][R20.64]", "LOP3.LUT R12, R4, RZ, RZ, 0x3c, !PT",
      "LDG.E.128 R8, desc[UR4][R22.64]", "LOP3.LUT R12, R12, R8, RZ, 0x96, !PT", "EXIT"],
     "1 of 2 row loads"),
    # one load for two rows
    (["LDG.E.128 R4, desc[UR4][R20.64]", "LOP3.LUT R12, R4, RZ, RZ, 0x3c, !PT", "EXIT"],
     "1 of 1 row loads"),
])
def test_stripe_loads_first_raises_on_a_combine_between_loads(monkeypatch, body, match):
    with pytest.raises(AssertionError, match=match):
        _stripe_loads(monkeypatch, _stripe_sass(body),
                      ["stripe_xor<k=2>", "stripe_gf256<k=2,m=2>"])


def test_stripe_loads_first_raises_on_a_missing_instance(monkeypatch):
    body = ["LDG.E.128 R4, desc[UR4][R20.64]", "LDG.E.128 R8, desc[UR4][R22.64]",
            "LOP3.LUT R12, R4, R8, RZ, 0x96, !PT", "EXIT"]
    with pytest.raises(RuntimeError, match="stripe_xor<k=3>"):
        _stripe_loads(monkeypatch, _stripe_sass(body), ["stripe_xor<k=2>", "stripe_xor<k=3>"])


def test_stripe_alu_ops_counts_each_compile_time_instance(monkeypatch):
    smoke = _smoke()
    body = ["LDG.E.128 R4, desc[UR4][R20.64]", "IADD3 R22, P0, R20, UR6, RZ",
            "LDG.E.128 R8, desc[UR4][R22.64]", "LOP3.LUT R12, R4, R8, RZ, 0x96, !PT",
            "IMAD R1, R1, 0x2, RZ", "STG.E.128 desc[UR4][R24.64], R12", "EXIT"]
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=_stripe_sass(body)))
    # ALU-pipe instructions only (IMAD runs on the FMA pipe); the runtime and
    # scalar instances are not read
    assert smoke.stripe_alu_ops(Path("lib.so")) == {"stripe_xor<k=2>": 2,
                                                    "stripe_gf256<k=2,m=2>": 1}


def test_pcie_peak_rate_is_gen5_x16():
    # 32 GT/s x 16 lanes x 128/130 / 8 bits: ~63.0 GB/s each way
    assert _smoke().PCIE_BYTES_PER_S == pytest.approx(63.015e9, rel=1e-4)


# ------------------------------------------------ the timed pipeline's phases

# The raid_end_to_end rehearsal geometry: 12 zones of 1,024 blocks, a 4,096-
# block volume, G=32.
TINY = dict(zones=12, zone_cap_blocks=1024, logical_blocks=4096, group=32)


def _count_plain_versions(monkeypatch):
    """Count calls of the codec kernels' plain versions: on the CPU, where a
    kernel would be launched on the card."""
    from repro_torch.kernels import ref

    calls = {}
    for name in ("parity_xor_ref", "parity_xor_batch_ref", "gf256_matmul_ref",
                 "gf256_matmul_batch_ref"):
        def counted(*a, _fn=getattr(ref, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ref, name, counted)
    return calls


def test_timed_phases_rehearse_on_the_cpu(monkeypatch):
    smoke = _smoke()
    calls = _count_plain_versions(monkeypatch)
    ph = smoke.Phase("timed")
    pipe, want = smoke.timed_replay("cpu", TINY, 0, ph, n_requests=400)
    info = ph.info
    assert info["write_us"]["n"] + info["read_us"]["n"] == 400
    assert info["write_us"]["p50"] > 0 and info["read_us"]["p999"] >= info["read_us"]["p99"]
    assert info["encode_sync_us"]["count"] > 0 and info["throughput_mib_s"] > 0
    assert info["events_fired"] == pipe.engine.events_fired > 400
    assert info["readback"] == "byte-exact"
    # the group encode (xor_reduce) and the Zone-Write stripes (stripe_xor)
    assert calls["parity_xor_batch_ref"] and calls["parity_xor_ref"]
    ph = smoke.Phase("timed_degraded")
    smoke.timed_degraded(pipe, want, 0, ph, n_ops=200)
    info = ph.info
    assert info["read_us"]["n"] == 400 and info["rebuild_device_us"] > 0
    assert info["readback"] == "byte-exact"
    assert not pipe.array.drives[1].failed


def test_timed_replay_is_deterministic_and_the_comparison_sees_a_difference():
    smoke = _smoke()
    a = smoke.timed_outputs(smoke.scenario_exp10("cpu"))
    b = smoke.timed_outputs(smoke.scenario_exp10("cpu"))
    assert smoke.output_differences(a, b) == []
    b["samples"][7] = b["samples"][7][:3] + (b["samples"][7][3] + 1e-9,)
    b["images"][2]["data"][0, 0, 0] ^= 1
    b["percentiles"]["None/R"]["p99"] = float("nan")
    assert smoke.output_differences(a, b) == ["samples", "percentiles", "images"]


def test_timed_card_vs_cpu_rehearses_on_the_cpu(monkeypatch):
    smoke = _smoke()
    calls = _count_plain_versions(monkeypatch)
    got = smoke.timed_card_vs_cpu(0, device="cpu")
    assert list(got) == ["exp10", "qos_rebuild", "raid6_degraded"]
    assert all(r["result"] == "equal" and r["samples"] >= 600 for r in got.values())
    # the RAID-6 scenario runs both GF(256) forms
    assert calls["gf256_matmul_ref"] and calls["gf256_matmul_batch_ref"]


def test_trace_requests_follow_the_exp10_mix():
    smoke = _smoke()
    reqs = smoke.trace_requests(65_536, 20_000, 3)
    sizes = np.bincount([r.n_blocks for r in reqs], minlength=4)[1:] / len(reqs)
    assert np.allclose(sizes, [0.60, 0.15, 0.25], atol=0.015)
    assert abs(np.mean([r.op == "W" for r in reqs]) - 0.85) < 0.01
    gaps = np.diff([0.0] + [r.t_us for r in reqs])
    assert abs(gaps.mean() - 40.0) < 1.0 and (gaps >= 0).all()
    assert all(0 <= r.lba <= 65_536 - r.n_blocks for r in reqs)


# ---------------------------- the block service's and the checkpoints' phases

def test_storage_sim_rehearses_on_the_cpu():
    smoke = _smoke()
    ph = smoke.Phase("storage_sim")
    smoke.storage_sim(ph, device="cpu", n_ops=dict(qds=(1, 4), qd_ops=24, cache_ops=60))
    info = ph.info
    assert list(info) == list(smoke.storage_sim_runs())
    assert all(r["result"] == "equal" for r in info.values())
    assert info["ckpt_vs_serve_qos"]["restore_ok"] is True
    # the committed rows of the reference's --quick run (BENCH_PR10.json)
    assert round(info["ckpt_vs_serve_qos"]["serve_p99_us"], 2) == 235.27
    assert round(info["ckpt_vs_serve_fifo"]["serve_p99_us"], 2) == 3046.71
    assert [r["qd"] for r in info["qd_sweep"]["rows"]] == [1, 4]


def test_checkpoint_phases_rehearse_on_the_cpu(monkeypatch):
    """The ``ckpt`` and ``state_parity`` phases at smoke width: every
    restore and rebuild bit-exact; RAID-6 and m = 2 reach both GF(256)
    forms, RAID-5 and m = 1 both XOR forms."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke as smoke_cfg

    smoke = _smoke()
    calls = _count_plain_versions(monkeypatch)
    weights = smoke.mamba2_weights(0, device="cpu", cfg=smoke_cfg(get_config("mamba2-1.3b")))
    ph = smoke.Phase("ckpt")
    smoke.ckpt_phase(weights, ph, device="cpu", layers=(2, 1),
                     geom=dict(zones=16, zone_cap_blocks=256, logical_blocks=4096))
    for scheme, fail in (("raid5", [1]), ("raid6", [1, 3])):
        r = ph.info[scheme]
        assert r["restores"] == "bit-exact" and r["failed_lanes"] == fail
        assert r["degraded_reads"] > 0 and r["bytes"] > 0 and r["save_mib_s"] > 0
    assert calls["parity_xor_batch_ref"] and calls["gf256_matmul_batch_ref"]
    ph = smoke.Phase("state_parity")
    lanes = smoke.state_parity_phase({k: w.shape for k, w in weights.items()}, 0, ph,
                                     device="cpu")
    info = ph.info
    assert info["params"] == sum(w.numel() for w in weights.values())
    assert info["state_bytes"] == 8 * info["params"]
    for m in (1, 2):
        assert info[f"m{m}"]["rebuilt"] == "bit-exact"
        assert info[f"m{m}"]["parity_bytes"] == m * info["state_bytes"] // smoke.PARITY["k"]
    assert info["m2"]["two_lost_wall_ms"] > 0 and "two_lost_wall_ms" not in info["m1"]
    assert len(lanes) == smoke.PARITY["k"]
    assert lanes[0].numel() * 4 == info["largest_shard_bytes"]
    assert calls["parity_xor_ref"] and calls["gf256_matmul_ref"]


def test_zero1_shards_pad_and_cut_into_views():
    import torch

    smoke = _smoke()
    state = {"a": torch.arange(10.0), "b": torch.arange(8.0).view(2, 4)}
    shards = smoke.zero1_shards(state, 4)
    assert [s["a"].tolist() for s in shards] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 0, 0]]
    assert [s["b"].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert shards[1]["b"].data_ptr() == state["b"].data_ptr() + 8  # a view, no copy


# --------------------------------------------------------- the serving phases

# The serving phases' sizes for a rehearsal: 3 requests of 12 tokens at
# batch 2, 4 generated each; the decode check at t = 10 (a ragged chunk of 8).
SERVE_TINY = dict(requests=3, batch=2, prompt=12, gen=4)
CHECK_TINY = dict(batch=2, t=10, k=3)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "qwen2.5-3b", "zamba2-2.7b"])
def test_serving_path_phases_rehearse_on_the_cpu(arch):
    """``model_setup``, ``serve_phase``, ``serve_profile`` and
    ``decode_matches_prefill`` at smoke size; no device metric is written
    from a CPU run."""
    from repro_torch.models.config import smoke as smoke_cfg

    smoke = _smoke()
    ph = smoke.Phase("setup")
    model = smoke.model_setup(arch, 0, ph, device="cpu", shrink=smoke_cfg, sizes=SERVE_TINY)
    assert ph.info["arch"] == arch and ph.info["init_s"] > 0
    assert ph.info["params"] == sum(w.numel() for w in model.parameters())
    ph = smoke.Phase("serve")
    st = smoke.serve_phase(model, 0, ph, sizes=SERVE_TINY)
    assert (st.requests, st.prefill_calls, st.decode_tokens) == (3, 2, 2 * 2 * 3)
    assert ph.info["prefill_tok_s"] > 0 and ph.info["peak_mem_bytes"] is None
    ph = smoke.Phase("profile")
    smoke.serve_profile(model, 0, ph, sizes=SERVE_TINY)
    assert list(ph.info) == ["prefill", "decode_step"]
    assert all(list(v) == ["wall_ms"] for v in ph.info.values())
    ph = smoke.Phase("decode_check")
    smoke.decode_matches_prefill(arch, 0, ph, device="cpu", shrink=smoke_cfg, sizes=CHECK_TINY)
    assert len(ph.info["max_abs_err"]) == 3 and max(ph.info["max_abs_err"]) < 2e-4
    assert ph.info["dtype"] == "float32"


def test_moe_vlm_and_encdec_phases_rehearse_on_the_cpu():
    from repro_torch.models import layers as L
    from repro_torch.models.config import smoke as smoke_cfg

    smoke = _smoke()
    real = L.moe_dispatch
    ph = smoke.Phase("moe_serve")
    smoke.moe_serve(0, ph, device="cpu", shrink=smoke_cfg,
                    sizes=dict(smoke.MOE_SERVE, **SERVE_TINY))
    info = ph.info
    assert L.moe_dispatch is real  # the counting wrapper is taken out again
    assert info["reduced"] == "2 of 2 layers" and info["requests_served"] == 3
    # prefill: 2 calls x 2 layers x batch 2 x 12 tokens, top-1
    assert info["prefill_routed_slots"] == 2 * 2 * 2 * 12
    assert 0 <= info["prefill_dropped_share"] < 1
    assert info["decode_dropped_share"] == 0  # one token always fits its expert
    ph = smoke.Phase("vlm")
    smoke.vlm_phase(0, ph, device="cpu", shrink=smoke_cfg, sizes=dict(smoke.VLM, **SERVE_TINY))
    assert ph.info["with_prefix"]["vis_embeds"] == [2, 4, 32]
    assert ph.info["with_prefix"]["decode_steps"] == smoke.VLM["decode_steps"]
    assert ph.info["requests_served"] == 3  # then served without a prefix
    ph = smoke.Phase("encdec")
    smoke.encdec_phase(0, ph, device="cpu", shrink=smoke_cfg,
                       sizes=dict(smoke.ENCDEC, **SERVE_TINY))
    assert ph.info["frames"] == [2, 8, 64] and ph.info["decode_steps"] == 3
    assert ph.info["decode_tok_s"] > 0


def test_serving_sizes_match_the_published_shapes():
    from repro_torch.configs import get_config

    smoke = _smoke()
    whisper = get_config(smoke.ENCDEC["arch"])
    assert smoke.ENCDEC["prompt"] + smoke.ENCDEC["gen"] == 448  # whisper's decoder context
    assert whisper.enc_len == 1500
    llama = smoke.model_config(smoke.MOE_SERVE["arch"], n_layers=smoke.MOE_SERVE["layers"])
    assert llama.param_count() == 6_473_175_040
    assert smoke.model_config("qwen2.5-3b").param_count() == 3_397_009_408
    assert smoke.model_config("zamba2-2.7b").param_count() == 2_422_379_968


# ------------------------------------------------------------------- training

_BWD_NS = "48_GLOBAL__N__59688088_15_ssd_scan_bwd_cu_b5911426"
_BWD = _BWD_NS + "20ssd_bwd_chunk_kernelI13__nv_bfloat16Lb1E"
_DSTATE = _BWD_NS + "21ssd_bwd_dstate_kernelIfLb0E"


def _bwd_listing(name, body):
    lines = [f"\t\tFunction : _ZN{name}EEvNS_7BwdArgsE"]
    lines += [f"        /*{16 * i:04x}*/ {ins} ; /* 0x0 */" for i, ins in enumerate(body)]
    return "\n".join(lines) + "\n"


def test_bwd_fma_instructions_count_ffma(monkeypatch):
    """The backward's SASS check (it held the FFMA of the CUDA-core kernels
    this check replaced): HMMA/HGMMA instructions of each instance of its
    three product kernels, raising if one has none."""
    smoke = _smoke()
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    hmma = ["LDSM.16.M88.4 R4, [R2]", "HMMA.16816.F32.BF16 R8, R4, R12, R8",
            "HMMA.16816.F32.BF16 R16, R4, R14, R16", "EXIT"]
    names = [_BWD_NS + f"{len(k)}{k}I{t}Lb{a}E"
             for k in ("ssd_bwd_dstate_kernel", "ssd_bwd_chunk_kernel", "ssd_bwd_dbc_kernel")
             for t, a in (("f", 0), ("13__nv_bfloat16", 0), ("13__nv_bfloat16", 1))]
    sass = "".join(_bwd_listing(n, hmma) for n in names)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=sass))
    got = smoke.bwd_tensor_core_instructions(Path("lib.so"))
    assert len(got) == 9 and set(got.values()) == {2}
    assert got["ssd_bwd_chunk_kernel<bf16,async>"] == 2
    assert got["ssd_bwd_dstate_kernel<f32,scalar>"] == 2
    # an instance on the CUDA cores alone fails the check
    sass = "".join(_bwd_listing(n, hmma if n != names[4] else ["FFMA R1, R2, R3, R1", "EXIT"])
                   for n in names)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: types.SimpleNamespace(stdout=sass))
    with pytest.raises(RuntimeError, match="tensor-core"):
        smoke.bwd_tensor_core_instructions(Path("lib.so"))


def test_ssd_bwd_tensor_flops_at_the_training_shape():
    """The products the backward issues at mamba2-1.3b's training shape (4
    groups of 16 heads): the state pass 12 products per (row, p-slice,
    chunk, state tile, time tile); G^T's 36-tile triangle per block; per
    head 36 tiles x 4 p-tiles x 2 x (2 + 3) and 8 x 8 x 4 x 2 x 2 for B dH';
    the db/dc pass 8 x 4 x 4 x 5 per (batch, chunk, n-slice, head) and 8 x
    4 x 8 x 4 at its end -- 55.9 GFLOP, ~1.85x the 30.2 the function needs."""
    b, t, h, p, n, q = 4, 1024, 64, 64, 128, 128
    nc, mma = t // q, 4096
    dstate = b * h * 2 * nc * 8 * 8 * 12
    gram_t = b * nc * 4 * 36 * 8 * 2
    per_head = 36 * 4 * 2 * 5 + 8 * 8 * 4 * 2 * 2
    dbc = b * nc * 4 * (h * 8 * 4 * 4 * 5 + 8 * 4 * 8 * 4)
    want = mma * (dstate + gram_t + b * h * nc * per_head + dbc)
    assert ssd.ssd_bwd_tensor_flops(b, h, t, q, n, p, 4) == want == 55_868_129_280
    assert want / ssd.ssd_bwd_flops(b, h, t, q, n, p) == pytest.approx(1.848, abs=1e-3)
    # f32 inputs split x, b and c too: more products, never fewer
    assert ssd.ssd_bwd_tensor_flops(b, h, t, q, n, p, 4, f32=True) > want


def test_ssd_bwd_bound_at_the_training_shape():
    """mamba2-1.3b's training scan: ~30.2 GFLOP (the triangles' four
    products, four (q x n x p) products per head and chunk, C B^T once per
    batch row) and 140.5 MB (x, b, c bf16; dt, a f32; dy f32 in and dx, db,
    dc, ddt, da out): bytes-bound, 41.9 us at 3.35 TB/s."""
    import torch

    smoke = _smoke()
    b, t, h, p, n, q = 4, 1024, 64, 64, 128, 128
    tri = q * (q + 1) // 2
    assert ssd.ssd_bwd_flops(b, h, t, q, n, p) == (t // q) * (
        b * 2 * tri * n + b * h * (2 * 2 * tri * p + 2 * 2 * tri * n + 4 * 2 * q * n * p))
    x = torch.empty((b, t, h, p), dtype=torch.bfloat16)
    bc = torch.empty((b, t, n), dtype=torch.bfloat16)
    dt, a = torch.empty((b, t, h)), torch.empty(h)
    dy = torch.empty((b, t, h, p))
    nbytes = ssd.ssd_bwd_bytes((x, dt, a, bc, bc, None, dy, None))
    assert nbytes == 2 * (2 * x.numel() + 4 * dt.numel() + 4 * h + 2 * 2 * bc.numel()) \
        + 4 * dy.numel() == 140_509_696
    assert nbytes / smoke.HBM_BYTES_PER_S > ssd.ssd_bwd_flops(b, h, t, q, n, p) \
        / smoke.BF16_TENSOR_FLOP_PER_S


def test_training_phases_rehearse_on_the_cpu():
    """``mamba2_train`` (its argv at smoke size), ``mamba2_grad_check``,
    ``train_ckpt`` (both runs: the restart recomputes its losses, the second
    restore reads degraded) and ``train_families`` on the CPU."""
    from repro_torch.models.config import smoke as smoke_cfg

    smoke = _smoke()
    argv = ["--arch", "mamba2-1.3b", "--steps", "3", "--global-batch", "2", "--seq-len", "20",
            "--ckpt-every", "5"]
    ph = smoke.Phase("mamba2_train")
    smoke.mamba2_train(ph, "cpu", dict(smoke.TRAIN, steps=3), argv)
    assert len(ph.info["losses"]) == 3 and ph.info["tokens_per_step"] == 40
    assert ph.info["trained_tok_s"] > 0 and ph.info["params"] > 0
    ph = smoke.Phase("mamba2_grad_check")
    smoke.mamba2_grad_check(ph, "cpu", smoke_cfg, dict(layers=2, batch=2, seq_len=25))
    assert ph.info["leaves"] == 16 and ph.info["worst_rel_err"] == 0.0
    ph = smoke.Phase("train_ckpt")
    smoke.train_ckpt(ph, "cpu")
    assert ph.info["default"]["engine"]["degraded_reads"] == 0  # the lane was rebuilt first
    assert ph.info["degraded_restore"]["engine"]["degraded_reads"] > 0
    for run in ph.info.values():
        assert len(run["losses"]) == 22 and run["recomputed"] == run["losses"][10:12]
    ph = smoke.Phase("train_families")
    smoke.train_families(ph, "cpu")
    from repro_torch.configs import ARCHS

    assert list(ph.info["archs"]) == ARCHS


def test_sharded_phases_rehearse_on_the_cpu(tmp_path):
    """``sharded_train`` after ``mamba2_train`` at smoke size on the CPU's
    (1, 1) gloo mesh (the same losses and leaf norms, bit for bit), then
    ``sharded_ckpt`` on its trained DTensors (a degraded restore into them,
    state parity over DTensor shards beside the ``state_parity`` phase on
    the same seed) before the mesh is torn down, ``dryrun`` over two worker
    processes for two cells and a skip, and ``examples`` (every port
    example once on the CPU)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke as smoke_cfg

    smoke = _smoke()
    spec = dict(smoke.TRAIN, steps=2, global_batch=2, seq_len=20)
    argv = ["--arch", "mamba2-1.3b", "--steps", "2", "--global-batch", "2", "--seq-len", "20",
            "--ckpt-every", "5"]
    ph = smoke.Phase("mamba2_train")
    smoke.mamba2_train(ph, "cpu", spec, argv)
    want = ph.info
    weights = smoke.mamba2_weights(smoke.SEED, "cpu", cfg=smoke_cfg(get_config("mamba2-1.3b")))
    shapes = {k: w.shape for k, w in weights.items()}
    plain = smoke.Phase("state_parity")
    smoke.state_parity_phase(shapes, smoke.SEED, plain, "cpu")
    try:
        ph = smoke.Phase("sharded_train")
        _, trained = smoke.sharded_train(ph, want, "cpu", spec, shrink=smoke_cfg)
        assert ph.info["losses"] == want["losses"] and ph.info["losses_bit_equal"]
        assert ph.info["leaf_norms_bit_equal"] and ph.info["mesh"] == {"data": 1, "model": 1}
        ph = smoke.Phase("sharded_ckpt")
        geom = dict(zones=16, zone_cap_blocks=256, logical_blocks=4096)
        launched = smoke.sharded_ckpt(ph, trained, shapes, plain.info, "cpu",
                                      spec=dict(smoke.SHARDED_CKPT, geom=geom))
    finally:
        smoke.end_mesh()
    assert not dist.is_initialized()
    from repro_torch.kernels import launch_counts

    assert launched == dict.fromkeys(launch_counts(), 0)  # the CPU launches no kernel
    ckpt, parity = ph.info["ckpt"], ph.info["state_parity"]
    assert ckpt["leaves"] == 1 + 4 * 13 and ckpt["degraded_reads"] > 0
    assert ckpt["stats"]["saves"] == 1 and ckpt["save_mib_s"] > 0
    for m in (1, 2):
        assert parity[f"m{m}"]["rebuilt"] == "bit-exact"
        assert parity[f"m{m}"]["plain_encode_wall_ms"] == plain.info[f"m{m}"]["encode_wall_ms"]
    ph = smoke.Phase("dryrun")
    rows = smoke.dryrun_phase(ph, tmp_path, device="cpu", workers=2, multi=(),
                              archs=["mamba2-1.3b", "smollm-135m"], shapes=["long_500k"])
    assert sorted(r["status"] for r in rows) == ["ok", "skip"]
    assert ph.info["ok"] == 1 and ph.info["skip"] == 1


def test_examples_phase_rehearses_on_the_cpu(tmp_path):
    """``examples``: every port example through its ``main`` on the CPU,
    each run's lines written under ``out``."""
    smoke = _smoke()
    ph = smoke.Phase("examples")
    smoke.examples_phase(ph, "cpu", out=tmp_path)
    info = ph.info["examples"]
    assert list(info) == list(smoke.EXAMPLES)
    assert all(row["outputs"] == "equal" and row["wall_s"] > 0 for row in info.values())
    assert info["ckpt_under_serving"]["last_line"].startswith("QoS cuts the serving tenant")
    assert (tmp_path / "cpu" / "port_scrub_metrics.json").exists()
    assert len(list(tmp_path.glob("*_cpu.txt"))) == 10
