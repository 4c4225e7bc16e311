"""``chip_smoke.py``'s count of ALU instructions in a kernel's SASS, on a
hand-written listing in ``cuobjdump -sass`` form (the card's toolkit is not
here).  The count sets the operations half of each kernel's bound."""
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
