"""``chip_smoke.py``'s reading of a kernel's SASS, on hand-written listings
in ``cuobjdump -sass`` form (the card's toolkit is not here): the count of
ALU instructions that sets the operations half of each codec kernel's bound,
and the tensor-core instructions the SSD kernels must hold.  Also its FLOP
counts of the SSD scan."""
import importlib.util
import subprocess
import types
from pathlib import Path

import pytest

from repro_torch.kernels import _build

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
    smoke = _smoke()
    q, n, p, nc = 128, 128, 64, 8
    tri = q * (q + 1) // 2
    per_head = nc * (2 * tri * p + 4 * q * n * p)
    assert smoke.ssd_flops(4, 1, 1024, q, n, p) == 4 * (nc * 2 * tri * n + per_head)
    assert smoke.ssd_flops(4, 64, 1024, q, n, p) - smoke.ssd_flops(4, 1, 1024, q, n, p) \
        == 4 * 63 * per_head


def test_ssd_tensor_flops_at_the_serving_shape():
    """1,312 m16n8k16 products per block and chunk -- C h_prev over 8 x 8
    tiles, M X over the triangle's 36 and the state update over 8 x 8, each
    with two halves on four 8-column tiles: (64 + 36 + 64) x 8 -- and 576
    per G (36 tiles x 8 x 2), 4,096 FLOP each."""
    smoke = _smoke()
    blocks, chunks, batch = 4 * 64 * 2, 8, 4
    assert smoke.ssd_tensor_flops(4, 64, 1024, 128, 128, 64) \
        == 4096 * chunks * (blocks * 1312 + batch * 576)
    # f32 inputs take three products where bf16 takes two (one for G)
    assert smoke.ssd_tensor_flops(1, 1, 128, 128, 128, 32, f32=True) == 4096 * (1968 + 1728)


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


def test_pcie_peak_rate_is_gen5_x16():
    # 32 GT/s x 16 lanes x 128/130 / 8 bits: ~63.0 GB/s each way
    assert _smoke().PCIE_BYTES_PER_S == pytest.approx(63.015e9, rel=1e-4)
