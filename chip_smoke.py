#!/usr/bin/env python3
"""Chip smoke test of ``repro_torch`` on one NVIDIA GPU: ZapRAID's datapath
and Mamba-2 1.3B serving.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch/`` (one ``nvcc`` per source, in parallel) and then runs,
failing on the first error:

1. kernels -- each codec kernel against its plain torch version, bit-exact,
   at the datapath's shapes and at odd lane counts; timed on the card
   (profiler device time and CUDA events) beside its bound: the larger of
   bytes over the memory rate and the integer instructions of its compiled
   main loop (``cuobjdump -sass``) over the card's INT32 rate.  The
   single-stripe kernels in both operand forms (CUDA tensors, and pinned
   host memory the card maps, as the datapath runs them) at k = 2..8 and
   the runtime instance's shapes, every RAID-6 (2+2) survivor set and
   unaligned views, and the codec's own staged form (``encode_np`` /
   ``decode_np`` on the card against the CPU) at k = 2..8 and every
   survivor set; their host-operand launch is bound by bytes over the PCIe
   link's peak rate (Gen5 x16), beside the copy engines' pinned rates,
   measured here with one 256 MiB copy each way.  The SASS of
   every compile-time single-stripe instance must issue all k row loads
   before the first combine.
   Also timed: a one-element op's launch (the floor of any launch) and the
   whole ``encode_np`` / ``decode_np`` round trips at the Zone-Write shapes
   (``ROUND_TRIPS``, 2,000 calls each on the host's clock).  The SSD scan
   against its plain sequential version (tolerance ``SSD_TOL``) at the
   serving shape in bf16 and f32, with an initial state, at t < chunk, at
   the CPU tests' shapes, at q = n = p = 128 and on an unaligned view, and
   its C B^T kernel against its own; their SASS must hold tensor-core
   instructions; timed beside their bounds (bytes over the memory rate, or
   FLOPs over the bf16 tensor-core rate);
2. RAID-5 end to end -- ZapRAID's hybrid deployment (3+1 drives, 4 KiB
   blocks, one Zone-Append segment of 8 KiB chunks with G=256, three
   Zone-Write segments of 16 KiB chunks) filled once by a seeded stream of
   small and large writes; read, fail a drive, degraded read, rebuild, read;
3. RAID-6 (2+2) on the same geometry and traffic: write, fail, degraded
   read, rebuild, then two failures and a read;
4. crash recovery -- a crash armed mid-group, ``recover_array``, and a
   read-back of every acknowledged block;
5. card vs CPU -- one small workload through ``device="cuda"`` and
   ``device="cpu"``; the drive images must be byte-equal;
6. mamba2_serve -- ``mamba2-1.3b`` at full width (48 layers, bf16, random
   weights from ``SEED``) serves 8 requests of 1,024 prompt tokens and 32
   generated tokens at batch 4 through ``repro_torch.launch.serve.serve``:
   prefill and decode tokens/s, peak device memory, finite logits, and 48
   SSD launches per prefill call; then, in f32 at the same width,
   ``prefill(t)`` plus k ``decode_step``s must give the last logits of
   ``prefill(t + i)`` at every step (t = 250 pads a ragged chunk, k = 3).
   Between the two, a profile of one prefill call and one decode step gives
   device time by kernel and the card's idle share of each.

Each phase prints one JSON line.  The codec kernels' launch counts are
zeroed just before phase 2 and read just after phase 4; the SSD scan's are
zeroed just before the serving run of phase 6 and read just after it.  The
``kernels`` line reports them.  The last two lines are the card's name and
power limit and the ``{"ok": true, "device": ...}`` result.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The bound of a kernel is the larger of its bytes over the H100's 3.35 TB/s
# of HBM3 (NVIDIA data sheet) and its integer operations over the INT32 rate:
# 64 INT32 lanes per SM per clock (H100 whitepaper), times this card's SMs
# and its maximum SM clock.  The operations are counted in the kernel's
# compiled code (SASS): the instructions of the ALU pipe, which runs the
# INT32 lanes, in its main loop.  IMAD runs on the FMA pipe and uniform (U*)
# instructions once per warp, so neither is counted, nor is the code around
# the loop: the time this gives is a lower bound.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM_CLOCK = 64
# The SSD kernels' operations are floating-point: their bound counts the
# FLOPs the function needs over the dense bf16 tensor-core rate (NVIDIA data
# sheet; the timed inputs are bf16), the least time the card could take for
# them; the FLOPs the kernels issue on the tensor cores are printed beside
# it at the same rate.
BF16_TENSOR_FLOP_PER_S = 989e12
# The single-stripe kernels read and write host memory across PCIe: their
# bound counts the bytes over the link's peak rate each way.  The H100's
# host interface is PCIe Gen5 x16 (NVIDIA data sheet): 32 GT/s per lane,
# 16 lanes, 128b/130b line code (PCI-SIG base specification 5.0).  Packet
# headers are not counted, so no transfer reaches it; a copy that beats it
# fails the run.
PCIE_BYTES_PER_S = 32e9 * 16 * (128 / 130) / 8
ALU_OPCODES = frozenset({
    "LOP3", "SHF", "IADD3", "LEA", "ISETP", "SEL", "PRMT", "IMNMX", "IABS",
    "BMSK", "SGXT", "FLO", "POPC", "BREV",
})
# The 128-bit (aligned-row) instances of the batched kernels in codec.cu, by a
# fragment of their mangled names.  Their main loops' ALU work per row load
# also counts the single-stripe rows' operations (the same function).
SASS_FUNCTIONS = {"xor_reduce": "17xor_reduce_kernelILb1E",
                  "gf256_matmul": "19gf256_matmul_kernelILb1E"}

# The compile-time instances of the single-stripe kernels in codec.cu: XOR of
# k = 2..8 rows, and GF(256) (m, k) = (2, k) encodes and (k, k) decodes.
STRIPE_INSTANCES = frozenset(
    [f"stripe_xor<k={k}>" for k in range(2, 9)]
    + [f"stripe_gf256<k={k},m={m}>" for k in range(2, 9) for m in {2, k}])

# ZapRAID's hybrid setting (arXiv 2402.17963 Sec. 3.3/5, as encoded at
# benchmarks/run.py hybrid_write_perf): N_s=1 small segment with C_s=8 KiB and
# G=256, N_l=3 large Zone-Write segments with C_l=16 KiB, 4 KiB blocks.
BLOCK_BYTES = 4096
SEED = 0  # of the traffic and the data; every phase makes its blocks from it
FULL = dict(zones=12, zone_cap_blocks=16384, logical_blocks=65536, group=256)

# Mamba-2 serving (src/repro_torch/configs/mamba2_1_3b.py): requests, batch,
# prompt and generated tokens; the decode check's prompt t and steps k.
SERVE = dict(requests=8, batch=4, prompt=1024, gen=32)
DECODE_CHECK = dict(batch=2, t=250, k=3)
# The SSD kernel multiplies on the tensor cores: bf16 inputs as they are,
# f32 inputs and the operands it computes in f32 (the masked decay matrix,
# the state, B scaled by the decay weights) as hi + lo bf16 halves, with
# exact products and f32 sums -- about 16 bits of each operand.  Its plain
# version is the step-by-step f32 recurrence on the same input values; they
# also differ in summation order and in exp of cumulative sums vs products
# of per-step decays: ~1e-4 of the outputs' scale at the serving shape
# (the kernel's arithmetic emulated in tests/test_torch_ssd.py).
SSD_TOL = 1e-3
# prefill + decode vs a longer prefill, in f32 at full width: the two paths
# sum in different orders through 48 layers (the reference's decode test
# holds 2e-2 at smoke size, tests/test_models.py).
DECODE_TOL = 2e-2


def _die(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------- setup

def array_config(scheme: str, device: str, geom: dict):
    from repro_torch.core.array import ZapRaidConfig
    from repro_torch.core.zns import ZnsConfig

    cfg = ZapRaidConfig(
        scheme=scheme, n_drives=4, group_size=geom["group"],
        logical_blocks=geom["logical_blocks"], hybrid=True, n_small=1,
        n_large=3, small_chunk_blocks=2, large_chunk_blocks=4,
        append_order="rng", device=device,
    )
    zns = ZnsConfig(n_zones=geom["zones"], zone_cap_blocks=geom["zone_cap_blocks"],
                    block_bytes=BLOCK_BYTES)
    return cfg, zns


def traffic(logical_blocks: int, seed: int):
    """Fill the logical space once: 75% small writes of 1-3 blocks, 25% large
    writes of 4-64 blocks, at consecutive LBAs.  Returns [(lba, n)]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out, lba = [], 0
    while lba < logical_blocks:
        n = int(rng.integers(1, 4)) if rng.random() < 0.75 else int(rng.integers(4, 65))
        n = min(n, logical_blocks - lba)
        out.append((lba, n))
        lba += n
    return out


def payload(logical_blocks: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, 256, (logical_blocks, BLOCK_BYTES), dtype=np.uint8)


def check_read_all(arr, want, what: str) -> None:
    import numpy as np

    got = arr.read(0, want.shape[0])
    if not np.array_equal(got, want):
        bad = int(np.flatnonzero((got != want).any(axis=1))[0])
        raise AssertionError(f"{what}: block {bad} differs")


class Phase:
    """Times one phase and reports the kernel launches it added."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        from repro_torch.kernels import launch_counts

        self.before = launch_counts()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        import torch
        from repro_torch.kernels import launch_counts

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        after = launch_counts()
        _emit({"phase": self.name,
               "seconds": time.perf_counter() - self.t0,
               "launches": {k: after[k] - self.before[k] for k in after},
               **self.info})
        return False


# ------------------------------------------------------------ phase 1: kernels

def alu_ops_per_row_load(library: Path) -> dict[str, float]:
    """ALU-pipe instructions per 16-byte row load in each kernel's main loop,
    from the library's SASS (``cuobjdump -sass``).

    The main loop is the backward branch whose span holds the most 128-bit
    global loads.  A thread runs it once per row it loads, so its ALU
    instructions over its loads, times the row loads of a launch, count the
    launch's ALU work inside that loop."""
    import re

    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    instr = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    out = {}
    for kernel, fragment in SASS_FUNCTIONS.items():
        body = next((f for f in sass.split("Function : ")[1:]
                     if f.split(None, 1)[0].find(fragment) >= 0), None)
        if body is None:
            raise RuntimeError(f"no {fragment} in the SASS of {library}")
        code = [(int(a, 16), op, rest.strip()) for a, op, rest in instr.findall(body)]
        best = None
        for addr, op, target in code:
            if op.split(".")[0] != "BRA" or not target.startswith("0x"):
                continue
            if int(target, 16) >= addr:
                continue
            loop = [o for a, o, _ in code if int(target, 16) <= a <= addr]
            loads = sum(o.startswith("LDG.E.128") for o in loop)
            alu = sum(o.split(".")[0] in ALU_OPCODES for o in loop)
            if loads and (best is None or loads > best[0]):
                best = (loads, alu)
        if best is None:
            raise RuntimeError(f"{fragment}: no loop with a 128-bit load in its SASS")
        out[kernel] = best[1] / best[0]
    return out


def stripe_loads_first(library: Path) -> dict[str, str]:
    """For each compile-time, 128-bit instance of the single-stripe kernels:
    how many of its 16-byte global loads (``LDG.E.128``) are issued before
    the first instruction that reads a loaded register, as "before/all", in
    the SASS.  The design puts all k row loads in flight before the first
    combine: it raises unless every instance of ``STRIPE_INSTANCES`` issues
    k loads, all of them before the first use."""
    import re

    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    out = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        kernel = re.search(r"(stripe_xor_kernel|stripe_gf256_kernel)ILi(\d+)E(?:Li(\d+)E)?Lb1E",
                           name)
        if kernel is None or kernel[2] == "0":
            continue
        loaded: set[int] = set()
        before = total = 0
        used = False
        for op, args in instr.findall(body):
            operands = [a.strip() for a in args.split(",")]
            reads = operands if op.startswith("ST") else operands[1:]
            regs = {int(r) for a in reads for r in re.findall(r"\bR(\d+)\b", a)}
            if not used and regs & loaded:
                used = True
            if op.startswith("LDG.E.128"):
                total += 1
                before += not used
                base = int(re.match(r"R(\d+)", operands[0])[1])
                loaded |= set(range(base, base + 4))
        key = kernel[1].replace("_kernel", "") + f"<k={kernel[2]}" + \
            (f",m={kernel[3]}>" if kernel[3] else ">")
        out[key] = f"{before}/{total}"
        if not before == total == int(kernel[2]):
            raise AssertionError(f"{key}: {before} of {total} row loads issued before the "
                                 f"first combine, want all {kernel[2]}")
    missing = STRIPE_INSTANCES - set(out)
    if missing:
        raise RuntimeError(f"no {sorted(missing)} in the SASS of {library}")
    return out


def _time_ms(fn, args_list, iters: int) -> tuple[float, float]:
    """(device ms, call ms) per call, over ``iters`` calls cycling through
    ``args_list`` (distinct copies whose total exceeds the 50 MB L2, so
    inputs come from device memory).

    Device ms is the summed time of the GPU kernels (and memsets) the calls
    ran, from ``torch.profiler``; it raises if the profile holds none.  Call
    ms is CUDA-event time from the first call to the last, which includes
    the host's launch overhead whenever the host cannot keep the card busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run():
        for i in range(iters):
            fn(*args_list[i % len(args_list)])

    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages())
    if dev_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the timed calls")
    return dev_us / 1e3 / iters, call_ms


def _time_host_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``, a launch that returns once
    its result is in host memory: device ms is the kernel's time from
    ``torch.profiler`` (the link's crossings included); call ms is host-clock
    time per call, launch to return."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    call_ms = 1e3 * (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages())
    if dev_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time for the timed calls")
    return dev_us / 1e3 / iters, call_ms


def link_rates() -> dict:
    """The host link: its peak rate each way (the single-stripe kernels'
    bound divides their bytes by it), and the pinned host <-> device copy
    rates the copy engines reach, one 256 MiB copy each way after a warm-up
    copy, timed with CUDA events; raises if a copy beats the peak."""
    import torch

    nbytes = 256 << 20
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host.fill_(1)
    out = {"peak_bytes_per_s": PCIE_BYTES_PER_S, "bytes": nbytes}
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        dst.copy_(src, non_blocking=True)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        out[f"{name}_bytes_per_s"] = nbytes / (start.elapsed_time(end) * 1e-3)
        if out[f"{name}_bytes_per_s"] > out["peak_bytes_per_s"]:
            raise AssertionError(f"{name} copy at {out[f'{name}_bytes_per_s']:.4g} B/s beats "
                                 "the PCIe Gen5 x16 peak")
    del host, dev
    return out


def launch_floor(iters: int = 2000) -> dict:
    """What one launch costs whatever the kernel: a one-element torch op's
    device time (``torch.profiler``), its call time back to back (CUDA
    events), and the host-clock time of the op plus a stream synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream()
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x.add_(1)
    end.record()
    end.synchronize()
    call_us = 1e3 * start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        x.add_(1)
        stream.synchronize()
    sync_us = 1e6 * (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            x.add_(1)
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()) / iters
    return {"device_us": dev_us, "call_us": call_us, "launch_sync_us": sync_us}


# The per-stripe round trips of StripeCodec.encode_np / decode_np at the
# datapath's Zone-Write shapes (16 KiB chunks): RAID-5 (3+1) encode and a
# one-erasure decode (data role 0 lost), RAID-6 (2+2) encode and a decode
# with both data roles lost.
ROUND_TRIPS = (("raid5", "encode", ()), ("raid5", "decode", (1, 2, 3)),
               ("raid6", "encode", ()), ("raid6", "decode", (2, 3)))


def codec_round_trips(iters: int = 2000, chunk_bytes: int = 16384) -> dict:
    """Host-clock µs per ``encode_np`` / ``decode_np`` call on the card at
    ``ROUND_TRIPS``, over ``iters`` calls after a warm-up, with the codec
    kernels launched per call; each result is checked once.  It uses only
    the codec's public calls, so it times any tree's ``repro_torch`` on
    ``sys.path``."""
    import numpy as np
    from repro_torch.core.raid import StripeCodec, make_scheme
    from repro_torch.kernels import launch_counts

    rng = np.random.default_rng(5)
    out = {}
    for scheme, op, roles in ROUND_TRIPS:
        codec = StripeCodec(make_scheme(scheme, 4), device="cuda")
        k = codec.scheme.k
        data = rng.integers(0, 256, (k, chunk_bytes), dtype=np.uint8)
        code = np.concatenate([data, codec.encode_np(data)])
        if op == "encode":
            def call(d=data):
                return codec.encode_np(d)
        else:
            surv = np.ascontiguousarray(code[list(roles)])

            def call(s_=surv, r=roles):
                return codec.decode_np(s_, r)
        got = call()
        want = code[k:] if op == "encode" else data
        if not np.array_equal(got, want):
            raise AssertionError(f"{scheme} {op}_np: wrong bytes")
        for _ in range(100):
            call()
        before = launch_counts()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        us = 1e6 * (time.perf_counter() - t0) / iters
        after = launch_counts()
        out[f"{scheme}_{op}"] = {
            "shape": list(code[list(roles)].shape if roles else data.shape), "us": us,
            "launches_per_call": {n: (after[n] - before[n]) / iters
                                  for n in after if after[n] != before[n]}}
    return out


def stripe_cases(rand, coeff):
    """The single-stripe kernels' check cases as (XOR data, GF (coeff,
    data)) lists, CUDA tensors: the main shapes, odd lane counts, k = 2..8
    and the runtime instance's k, every RAID-6 (2+2) survivor set, RAID-6
    at 5 drives (k = 3) and m = 3 outputs of k = 2 (runtime)."""
    from repro_torch.core import gf

    odd = (1, 4, 1023)
    xor = [rand(3, 4096), rand(3, 16)] + [rand(3, n) for n in odd] \
        + [rand(k, 1024) for k in (1, 2, 3, 4, 5, 6, 7, 8, 9)]
    enc22 = coeff(gf.rs_parity_matrix(2, 2))
    surv22 = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    gfc = [(coeff(gf.rs_decode_matrix(2, 2, s)), rand(2, 4096)) for s in surv22]
    gfc = [(enc22, rand(2, 4096))] + gfc + [(enc22, rand(2, n)) for n in odd]
    for k in range(2, 11):  # encode (2, k) and decode (k, k); 9, 10 runtime
        gfc.append((coeff(gf.rs_parity_matrix(k, 2)), rand(k, 1024)))
        gfc.append((coeff(gf.rs_decode_matrix(k, 2, tuple(range(2, k + 2)))), rand(k, 1024)))
    gfc.append((coeff(gf.rs_parity_matrix(2, 3)), rand(2, 1024)))  # (3, 2)
    return xor, gfc


def codec_stripe_checks(seed: int = 17) -> int:
    """Hold the datapath's own form of the single-stripe kernels -- the
    codec's staged, row-padded pinned buffers and its one launch per stripe
    -- bit-exact against the same codec on the CPU (the plain versions on the
    same staged rows): ``encode_np`` and ``decode_np`` of every survivor set,
    RAID-5 at k = 2..8 and RAID-6 at k = 2..8, at chunks of 1, 4, 1023 and
    4,096 lanes.  Returns the number of calls checked."""
    import itertools

    import numpy as np
    from repro_torch.core.raid import StripeCodec, make_scheme

    rng = np.random.default_rng(seed)
    checked = 0
    for scheme, extra in (("raid5", 1), ("raid6", 2)):
        for k in range(2, 9):
            card, cpu = (StripeCodec(make_scheme(scheme, k + extra), device=d)
                         for d in ("cuda", "cpu"))
            for nbytes in (4, 16, 4092, 16384):
                data = rng.integers(0, 256, (k, nbytes), dtype=np.uint8)
                par = card.encode_np(data)
                if not np.array_equal(par, cpu.encode_np(data)):
                    raise AssertionError(f"{scheme} k={k} encode_np({nbytes} B) differs")
                code = np.concatenate([data, par])
                for roles in itertools.combinations(range(k + extra), k):
                    surv = np.ascontiguousarray(code[list(roles)])
                    got = card.decode_np(surv, roles)
                    if not (np.array_equal(got, cpu.decode_np(surv, roles))
                            and np.array_equal(got, data)):
                        raise AssertionError(f"{scheme} k={k} decode_np{roles}({nbytes} B) "
                                             "differs")
                checked += 1 + len(list(itertools.combinations(range(k + extra), k)))
    return checked


# The TPU kernels the single-stripe kernels replace.
STRIPE_REPLACES = {"parity_xor": "src/repro/kernels/parity_xor.py:73",
                   "gf256_matmul": "src/repro/kernels/gf256_matmul.py:103"}


def stripe_checks(int32_ops_per_s: float | None = None,
                  alu_per_load: dict[str, float] | None = None,
                  rates: dict | None = None) -> list[dict]:
    """Hold the single-stripe kernels bit-exact against their plain versions
    in both operand forms -- CUDA tensors, and pinned host memory the card
    maps -- at ``stripe_cases`` and on views off a 16-byte boundary, and in
    the codec's own staged form (``codec_stripe_checks``).  With
    the rates and ALU counts given, also time both forms at the main shapes
    and return the ``parity_xor`` and ``gf256_matmul`` rows."""
    import numpy as np
    import torch
    from repro_torch.kernels import gf256_matmul as gfm
    from repro_torch.kernels import parity_xor as px
    from repro_torch.kernels import _build, ref

    rng = np.random.default_rng(13)
    side = torch.cuda.Stream()

    def rand(*shape):
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).cuda()

    def coeff(mat):
        return torch.from_numpy(np.asarray(mat, np.int32))

    def pinned(t, skew=0):
        """t's values in pinned host memory, ``skew`` int32 into the buffer."""
        buf = torch.empty(t.numel() + skew, dtype=torch.int32, pin_memory=True)
        view = buf[skew:].view(t.shape)
        view.copy_(t.cpu())
        return view

    def xor_host(d):
        out = torch.empty((d.shape[1],), dtype=torch.int32, pin_memory=True)
        px.parity_xor_host(d, out, side.cuda_stream)
        return out

    def gf_host(c, d):
        out = torch.empty((c.shape[0], d.shape[1]), dtype=torch.int32, pin_memory=True)
        gfm.gf256_matmul_host(c, d, out, side.cuda_stream)
        return out

    xor_cases, gf_cases = stripe_cases(rand, coeff)
    skewed = rand(2 * 3 * 64 + 1)[1:]  # device views off a 16-byte boundary
    xor_cases.append(skewed[: 3 * 64].view(3, 64))
    gf_cases.append((gf_cases[0][0], skewed[: 2 * 64].view(2, 64)))

    def check(name, got, want):
        if got.shape != want.shape or not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"{name}: kernel differs from its plain version")

    n_checked = 0
    for d in xor_cases:  # tolerance 0: every lane is integer bytes
        check(f"parity_xor{tuple(d.shape)}", px.parity_xor(d), ref.parity_xor_ref(d))
        skew = 1 if d.data_ptr() % 16 else 0
        hd = pinned(d, skew)
        check(f"parity_xor_host{tuple(d.shape)} skew {skew}", xor_host(hd),
              ref.parity_xor_ref(hd))
        n_checked += 2
    for c, d in gf_cases:
        for cc in (c, c.cuda()):  # coefficients from the host, or read back
            check(f"gf256_matmul{tuple(c.shape)}x{tuple(d.shape)}",
                  gfm.gf256_matmul(cc, d), ref.gf256_matmul_ref(c, d.cpu()))
        skew = 1 if d.data_ptr() % 16 else 0
        hd = pinned(d, skew)
        check(f"gf256_matmul_host{tuple(c.shape)}x{tuple(d.shape)} skew {skew}",
              gf_host(c, hd), ref.gf256_matmul_ref(c, hd))
        n_checked += 3
    torch.cuda.synchronize()
    n_checked += codec_stripe_checks()
    if rates is None:
        return [{"cases": n_checked}]

    peak = rates["peak_bytes_per_s"]
    rows = []
    main = {"parity_xor": (None, rand(3, 4096)),
            "gf256_matmul": (gf_cases[0][0], rand(2, 4096))}
    for name, (c, d) in main.items():
        k, n = d.shape
        m = 1 if c is None else c.shape[0]
        # host-operand form, as StripeCodec launches it: addresses resolved once
        hd = pinned(d)
        hout = torch.empty((m, n), dtype=torch.int32, pin_memory=True)
        src, dst = _build.host_device_pointer(hd), _build.host_device_pointer(hout)
        if c is None:
            def launch(src=src, dst=dst):
                px.stripe_launch(src, dst, k, n, True, side.cuda_stream, True)
            kernel, plain, plain_args = px.parity_xor, ref.parity_xor_ref, (d,)
            ops = alu_per_load["xor_reduce"] * k * -(-n // 4)
        else:
            c_host = c.contiguous()

            def launch(src=src, dst=dst, c_host=c_host):
                gfm.stripe_launch(c_host.data_ptr(), m, k, src, dst, n, True,
                                  side.cuda_stream, True)
            kernel, plain, plain_args = gfm.gf256_matmul, ref.gf256_matmul_ref, (c, d)
            ops = alu_per_load["gf256_matmul"] * m * k * -(-n // 4)
        ms, call_ms = _time_host_ms(launch, 2000)
        want = plain(*plain_args).cpu().view(m, n)
        if not torch.equal(hout, want):
            raise AssertionError(f"{name}: host-operand launch differs after timing")
        # device-operand form, inputs rotated past the L2
        copies = [plain_args] + [((c,) if c is not None else ()) + (rand(k, n),)
                                 for _ in range(max(1, (96 << 20) // (4 * k * n)))]
        dev_ms, dev_call_ms = _time_ms(kernel, copies, 200)
        plain_ms, plain_call_ms = _time_ms(plain, copies[:8], 20)
        in_b, out_b = 4 * k * n, 4 * m * n
        link_ms = 1e3 * max(in_b, out_b) / peak  # the link is full duplex
        op_ms = 1e3 * ops / int32_ops_per_s
        hbm_ms = 1e3 * (in_b + out_b) / HBM_BYTES_PER_S
        rows.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/codec.cu",
            "replaces": STRIPE_REPLACES[name], "launches": 0, "max_abs_err": 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(link_ms, op_ms),
            "bound_by": "bytes" if link_ms >= op_ms else "operations", "library_ms": None,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "shape": ([list(c.shape)] if c is not None else []) + [list(d.shape)],
            "bytes_us": 1e3 * link_ms, "ops_us": 1e3 * op_ms, "cases": n_checked,
            "form": "host-mapped operands (the datapath's)",
            "device_operands": {"ms": dev_ms, "call_ms": dev_call_ms,
                                "bound_ms": max(hbm_ms, op_ms)},
        })
    return rows


def kernel_checks(alu_per_load: dict[str, float], int32_ops_per_s: float) -> list[dict]:
    """Hold the batched codec kernels against their plain versions,
    bit-exact, on the card; time both at the datapath's group shape.
    Returns one row per entry.

    ``alu_per_load`` is ``alu_ops_per_row_load`` of the built library; every
    main shape takes the 128-bit path, whose threads load one 16-byte row per
    input chunk (and, in the GF product, again per output row)."""
    import numpy as np
    import torch
    from repro_torch.core import gf
    from repro_torch.kernels import gf256_matmul as gfm
    from repro_torch.kernels import parity_xor as px
    from repro_torch.kernels import ref

    rng = np.random.default_rng(7)

    def rand(*shape):
        return torch.from_numpy(
            rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
        ).to("cuda")

    def coeff(mat):
        return torch.from_numpy(np.asarray(mat, np.int32)).to("cuda")

    def row_loads(n):  # 16-byte row loads of one n-lane chunk
        return -(-n // 4)

    xor_alu, gf_alu = alu_per_load["xor_reduce"], alu_per_load["gf256_matmul"]

    enc22 = coeff(gf.rs_parity_matrix(2, 2))
    decs22 = [coeff(gf.rs_decode_matrix(2, 2, s))
              for s in [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]]
    odd = (1, 4, 1023)
    # (entry, kernel fn, plain fn, cases, main-shape args, bytes fn, ALU ops fn)
    entries = [
        ("parity_xor_batch", px.parity_xor_batch, ref.parity_xor_batch_ref,
         [(rand(256, 3, 2048),)] + [(rand(5, 3, n),) for n in odd],
         lambda: (rand(256, 3, 2048),),
         lambda d: 4 * d.shape[0] * (d.shape[1] + 1) * d.shape[2],
         lambda d: xor_alu * d.shape[0] * d.shape[1] * row_loads(d.shape[2])),
        ("gf256_matmul_batch", gfm.gf256_matmul_batch, ref.gf256_matmul_batch_ref,
         [(c, rand(256, 2, 2048)) for c in [enc22, *decs22]]
         + [(enc22, rand(5, 2, n)) for n in odd],
         lambda: (enc22, rand(256, 2, 2048)),
         lambda c, d: 4 * d.shape[0] * (d.shape[1] + c.shape[0]) * d.shape[2],
         lambda c, d: gf_alu * c.numel() * d.shape[0] * row_loads(d.shape[2])),
    ]
    source = "src/repro_torch/kernels/csrc/codec.cu"
    replaces = {
        "parity_xor_batch": "src/repro/kernels/parity_xor.py:49",
        "gf256_matmul_batch": "src/repro/kernels/gf256_matmul.py:76",
    }
    rows = []
    for name, fn, plain, cases, main, nbytes, nops in entries:
        max_err = 0
        for args in cases:  # tolerance 0: every lane is integer bytes
            got, want = fn(*args), plain(*args)
            err = int((got.long() - want.long()).abs().max()) \
                if got.shape == want.shape else -1
            if err != 0:
                raise AssertionError(f"{name}{[tuple(a.shape) for a in args]}: "
                                     f"kernel differs from its plain version ({err})")
            max_err = max(max_err, err)
        main_args = main()
        b = nbytes(*main_args)
        # enough distinct copies that the rotation exceeds the L2 cache
        copies = [main_args] + [main() for _ in range(max(1, (96 << 20) // b))]
        ms, call_ms = _time_ms(fn, copies, 200)
        plain_ms, plain_call_ms = _time_ms(plain, copies, 20)
        byte_ms = 1e3 * b / HBM_BYTES_PER_S
        op_ms = 1e3 * nops(*main_args) / int32_ops_per_s
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name], "launches": 0, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "shape": [list(a.shape) for a in main_args],
            "bytes_us": 1e3 * byte_ms, "ops_us": 1e3 * op_ms, "cases": len(cases),
        })
        del copies
    return rows


def ssd_flops(nb: int, nh: int, t: int, chunk: int, n: int, p: int) -> int:
    """FLOPs the scan needs.  Per batch row and chunk, the lower triangle of
    C B^T: b and c are shared by the ``nh`` heads of a batch row, so G is
    counted once per batch row, not per head.  Per head and chunk, the
    triangle's product with dt*X, C h_prev and the state update."""
    q = min(chunk, t)
    tri = q * (q + 1) // 2
    return (t // q) * (nb * 2 * tri * n + nb * nh * (2 * tri * p + 4 * q * n * p))


def ssd_tensor_flops(nb: int, nh: int, t: int, chunk: int, n: int, p: int,
                     f32: bool = False) -> int:
    """FLOPs the two kernels issue on the tensor cores, as m16n8k16 products
    of 4,096 FLOP.  Per block (batch, head, 32 columns of p) and chunk: C
    h_prev over all (q/16) x (n/16) tiles, M X over the tiles on and below
    the diagonal and the state update over (n/16) x (q/16), each tile with
    two products (hi and lo halves; three with f32 inputs) per 8 columns.
    Per batch row and chunk, G's tiles on and below the diagonal, with one
    product per 8 columns (three with f32 inputs)."""
    q = min(chunk, t)
    qt, nt, slices = -(-q // 16), -(-n // 16), -(-p // 32)
    tri = qt * (qt + 1) // 2
    per_block = 4 * (3 if f32 else 2) * (qt * nt + tri + nt * qt)
    per_gram = tri * nt * 2 * (3 if f32 else 1)
    return 4096 * (t // q) * (nb * nh * slices * per_block + nb * per_gram)


def ssd_bytes(args) -> int:
    """Bytes the scan must move with its operands as given (b and c shared
    by the heads of a batch row are read once): the inputs once, y and
    h_final (f32) once."""
    x, dt, a, b, c, h0 = args
    nb, t, nh, p = x.shape
    n = b.shape[-1]
    ins = sum(v.numel() * v.element_size() for v in (x, dt, a, b, c, h0) if v is not None)
    return ins + 4 * nb * t * nh * p + 4 * nb * nh * n * p


def tensor_core_instructions(library: Path) -> dict[str, int]:
    """HMMA/HGMMA instructions in the SASS of each SSD kernel instance
    (``cuobjdump -sass``); raises if one has none."""
    import re

    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        kernel = re.search(r"(ssd_scan_kernel|ssd_chunk_gram_kernel)I(\w+?)Lb([01])E", name)
        if kernel is None:
            continue
        key = f"{kernel[1]}<{'bf16' if 'bfloat16' in kernel[2] else 'f32'}," \
              f"{'async' if kernel[3] == '1' else 'scalar'}>"
        out[key] = len(re.findall(r"\bH(?:G)?MMA\.", body))
    if not out or not all(out.values()):
        raise RuntimeError(f"SSD kernels without tensor-core instructions in their SASS: {out}")
    return out


def ssd_checks() -> list[dict]:
    """Hold the SSD kernels against their plain versions on the card; time
    both at the serving shape.  Returns the ``ssd_scan`` and
    ``ssd_chunk_gram`` rows."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(11)
    cfg = get_config("mamba2-1.3b")  # its prefill's scan at the serving shape
    nb, t = SERVE["batch"], SERVE["prompt"]
    nh, p, n = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    chunk = cfg.ssm_chunk

    def heads(dtype, nb, t, nh, p, n, h0=False, skew=0):
        """Operands as ``mamba_apply`` gives them: x, b, c strided views of
        one (B, T, H*P + 2N) conv output; dt (B, T, H); a (H,).  ``skew``
        starts the conv output that many elements into its buffer."""
        wide = nh * p + 2 * n
        conv = torch.from_numpy(rng.standard_normal(nb * t * wide + skew).astype(np.float32))
        conv = conv.to("cuda", dtype)[skew:].view(nb, t, wide)
        x = conv[..., : nh * p].reshape(nb, t, nh, p)
        dt = torch.from_numpy(rng.uniform(0.01, 0.2, (nb, t, nh)).astype(np.float32)).cuda()
        a = -torch.from_numpy(rng.uniform(0.5, 2.0, (nh,)).astype(np.float32)).cuda()
        s0 = torch.from_numpy(rng.standard_normal((nb, nh, n, p), np.float32)).cuda() \
            if h0 else None
        return x, dt, a, conv[..., nh * p : nh * p + n], conv[..., nh * p + n :], s0

    def rows(dtype, bh, t, p, n):
        """Operands in the Pallas kernel's layout, as the CPU tests make them."""
        f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).cuda()  # noqa: E731
        dt = torch.from_numpy(rng.uniform(0.01, 0.2, (bh, t)).astype(np.float32)).cuda()
        a = -torch.from_numpy(rng.uniform(0.5, 2.0, (bh,)).astype(np.float32)).cuda()
        return f(bh, t, p).to(dtype), dt, a, f(bh, t, n).to(dtype), f(bh, t, n).to(dtype), None

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (label, args, chunk)
        ("main bf16", heads(bf16, nb, t, nh, p, n), chunk),
        ("main f32", heads(f32, nb, t, nh, p, n), chunk),
        ("main bf16 h0", heads(bf16, nb, t, nh, p, n, h0=True), chunk),
        ("t<chunk bf16", heads(bf16, nb, 64, nh, p, n), chunk),
        ("t<chunk f32 h0", heads(f32, 2, 100, 8, p, n, h0=True), chunk),
    ] + [(f"cpu-test t={tt} chunk={ch} {dt_}", rows(d, 3, tt, 8, 16), ch)
         for tt, ch in [(64, 16), (128, 128), (256, 64)]
         for dt_, d in (("f32", f32), ("bf16", bf16))] + [
        # shapes the earlier FMA kernel refused (its shared memory ran out)
        ("q=n=p=128 bf16 h0", heads(bf16, 2, 256, 4, 128, 128, h0=True), 128),
        ("q=n=p=128 f32", heads(f32, 2, 256, 4, 128, 128), 128),
        # views off a 16-byte boundary take the scalar load path
        ("unaligned bf16 h0", heads(bf16, 2, 256, 8, p, n, h0=True, skew=1), chunk),
    ]
    cont = rows(f32, 2, 128, 4, 8)  # state continuation (tests/test_kernels.py)
    max_err, worst = 0.0, None
    for label, args, ch in cases:
        got, want = ssd.ssd_scan(*args, chunk=ch), ssd.ssd_scan_plain(*args)
        for g, w in zip(got, want):
            err = float((g - w).abs().max())
            if not torch.allclose(g, w, atol=SSD_TOL, rtol=SSD_TOL) or g.shape != w.shape:
                raise AssertionError(f"ssd_scan {label}: kernel differs from its plain "
                                     f"version (max abs err {err})")
            if err > max_err:
                max_err, worst = err, label
    x, dt, a, b, c, _ = cont
    y_full, h_full = ssd.ssd_scan(x, dt, a, b, c, chunk=32)
    y1, h1 = ssd.ssd_scan(x[:, :64], dt[:, :64], a, b[:, :64], c[:, :64], chunk=32)
    y2, h2 = ssd.ssd_scan(x[:, 64:], dt[:, 64:], a, b[:, 64:], c[:, 64:], h1, chunk=32)
    for g, w in ((y2, y_full[:, 64:]), (h2, h_full)):
        if not torch.allclose(g, w, atol=1e-4, rtol=1e-4):
            raise AssertionError("ssd_scan: state continuation differs from one scan")

    # G = C B^T alone, against its plain version, on every case's b and c.
    gram_err = 0.0
    for label, (_, _, _, b, c, _), ch in cases:
        got, want = ssd.chunk_gram(b, c, chunk=ch), ref.ssd_chunk_gram_ref(b, c, min(ch, b.shape[1]))
        err = float((got - want).abs().max())
        if got.shape != want.shape or not torch.allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL):
            raise AssertionError(f"ssd_chunk_gram {label}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        gram_err = max(gram_err, err)

    main = cases[0][1]
    nbytes = ssd_bytes(main)
    copies = [main] + [heads(bf16, nb, t, nh, p, n) for _ in range(max(1, (96 << 20) // nbytes))]
    ms, call_ms = _time_ms(lambda *a_: ssd.ssd_scan(*a_, chunk=chunk), copies, 20)
    plain_ms, plain_call_ms = _time_ms(ssd.ssd_scan_plain, copies, 3)
    flops = ssd_flops(nb, nh, t, chunk, n, p)
    tensor_flops = ssd_tensor_flops(nb, nh, t, chunk, n, p)
    byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    op_ms = 1e3 * flops / BF16_TENSOR_FLOP_PER_S
    scan_row = {
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:90", "launches": 0, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": None,
        "call_ms": call_ms, "plain_call_ms": plain_call_ms,
        "shape": [list(v.shape) if v is not None else None for v in main],
        "bytes_us": 1e3 * byte_ms, "ops_us": 1e3 * op_ms, "flops": flops, "bytes": nbytes,
        "bound_share": max(byte_ms, op_ms) / ms,
        # what the two kernels issue on the tensor cores (split halves and
        # padding included), its time at the dense bf16 rate, and its rate
        "tensor_flops": tensor_flops,
        "tensor_us": 1e6 * tensor_flops / BF16_TENSOR_FLOP_PER_S,
        "tensor_flop_per_s": tensor_flops / (ms * 1e-3),
        "cases": len(cases) + 1, "worst_case": worst, "tol": SSD_TOL,
    }

    # G alone at the serving shape: b, c in, the tiles out; the library call
    # is one batched matmul of the chunks (the whole q x q block, bf16 out).
    def gram_args():
        return heads(bf16, nb, t, 1, p, n)[3:5]

    gb, gc = gram_args()
    gram = ssd.chunk_gram(gb, gc, chunk=chunk)
    g_bytes = 2 * gb.numel() * gb.element_size() + 4 * gram.numel()
    g_flops = (t // chunk) * nb * chunk * (chunk + 1) * n
    gcopies = [(gb, gc)] + [gram_args() for _ in range(max(1, (96 << 20) // g_bytes))]
    g_ms, g_call_ms = _time_ms(lambda b_, c_: ssd.chunk_gram(b_, c_, chunk=chunk), gcopies, 50)
    g_plain_ms, _ = _time_ms(lambda b_, c_: ref.ssd_chunk_gram_ref(b_, c_, chunk), gcopies, 10)
    lib_ms, _ = _time_ms(lambda b_, c_: torch.matmul(c_.unflatten(1, (-1, chunk)),
                                                      b_.unflatten(1, (-1, chunk)).transpose(-1, -2)),
                         gcopies, 50)
    g_byte_ms = 1e3 * g_bytes / HBM_BYTES_PER_S
    g_op_ms = 1e3 * g_flops / BF16_TENSOR_FLOP_PER_S
    gram_row = {
        "name": "ssd_chunk_gram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:52", "launches": 0, "max_abs_err": gram_err,
        "ms": g_ms, "plain_ms": g_plain_ms, "bound_ms": max(g_byte_ms, g_op_ms),
        "bound_by": "bytes" if g_byte_ms >= g_op_ms else "operations", "library_ms": lib_ms,
        "call_ms": g_call_ms, "shape": [list(gb.shape), list(gc.shape)],
        "bytes_us": 1e3 * g_byte_ms, "ops_us": 1e3 * g_op_ms, "cases": len(cases),
    }
    return [scan_row, gram_row]


# ---------------------------------------------------- phases 2-4: datapath

def write_stream(arr, data, ops) -> None:
    for lba, n in ops:
        arr.write(lba, data[lba : lba + n])


def raid_end_to_end(scheme: str, device: str, geom: dict, seed: int, ph: Phase) -> None:
    from repro_torch.core.array import ZapRAIDArray

    cfg, zns = array_config(scheme, device, geom)
    ops = traffic(cfg.logical_blocks, seed)
    data = payload(cfg.logical_blocks, seed)
    arr = ZapRAIDArray(cfg, zns)
    t = time.perf_counter()
    write_stream(arr, data, ops)
    arr.flush()
    ph.info["writes"] = len(ops)
    ph.info["write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    check_read_all(arr, data, f"{scheme} read")
    ph.info["read_s"] = time.perf_counter() - t
    arr.fail_drive(1)
    t = time.perf_counter()
    check_read_all(arr, data, f"{scheme} degraded read")
    ph.info["degraded_read_s"] = time.perf_counter() - t
    t = time.perf_counter()
    arr.rebuild_drive(1)
    ph.info["rebuild_s"] = time.perf_counter() - t
    check_read_all(arr, data, f"{scheme} read after rebuild")
    if scheme == "raid6":
        arr.fail_drive(0)
        arr.fail_drive(2)
        t = time.perf_counter()
        check_read_all(arr, data, "raid6 read with two failed drives")
        ph.info["double_degraded_read_s"] = time.perf_counter() - t
    ph.info["stats"] = dataclasses.asdict(arr.stats)


def crash_recovery(device: str, geom: dict, seed: int, ph: Phase) -> None:
    """Ack a prefix of the stream (write + flush), arm a crash of half a
    Zone-Append group's block commits, go on with the stream's small writes
    until the device crashes inside a group commit, recover, read back."""
    from repro_torch.core.array import ZapRAIDArray
    from repro_torch.core.recovery import recover_array
    from repro_torch.core.zns import DeviceCrashed

    cfg, zns = array_config("raid5", device, geom)
    ops = traffic(cfg.logical_blocks, seed)
    data = payload(cfg.logical_blocks, seed)
    arr = ZapRAIDArray(cfg, zns)
    cut = len(ops) // 4
    write_stream(arr, data, ops[:cut])
    arr.flush()
    acked = ops[cut][0]  # LBAs [0, acked) are acknowledged
    in_group = []
    commit_group = arr._commit_built_group

    def traced(grp):
        in_group.append(True)
        commit_group(grp)
        in_group.pop()

    arr._commit_built_group = traced
    budget = cfg.group_size * cfg.n_drives * cfg.small_chunk_blocks // 2
    arr.arm_crash(budget)
    crashed = False
    try:
        for lba, n in ops[cut:]:
            if n < cfg.large_chunk_blocks:
                arr.write(lba, data[lba : lba + n])
        arr.flush()
    except DeviceCrashed:
        crashed = True
    if not crashed or not in_group:
        raise AssertionError(f"crash did not land mid-group (crashed={crashed})")
    t = time.perf_counter()
    arr2 = recover_array(arr.drives, cfg, zns)
    ph.info["recover_s"] = time.perf_counter() - t
    ph.info["acked_blocks"] = acked
    ph.info["budget_blocks"] = budget
    check_read_all(arr2, data[:acked], "read-back after crash recovery")


def card_vs_cpu(seed: int) -> dict:
    """A small workload through the card and through the CPU path: the drive
    images, L2P and stats must be equal."""
    import numpy as np
    from repro_torch.core.array import ZapRAIDArray, ZapRaidConfig
    from repro_torch.core.zns import ZnsConfig, drive_images

    def run(scheme, n_drives, device):
        cfg = ZapRaidConfig(scheme=scheme, n_drives=n_drives, group_size=8,
                            logical_blocks=256, device=device, append_order="rng")
        arr = ZapRAIDArray(cfg, ZnsConfig(n_zones=12, zone_cap_blocks=64, block_bytes=256))
        rng = np.random.default_rng(seed)
        for _ in range(200):
            n = int(rng.integers(1, 4))
            arr.write(int(rng.integers(0, 256 - n)),
                      rng.integers(0, 256, (n, 256), dtype=np.uint8))
        arr.flush()
        arr.fail_drive(1)
        reads = arr.read(0, 256)
        arr.rebuild_drive(1)
        return arr, reads

    out = {}
    for scheme, n_drives in [("raid5", 4), ("raid6", 5)]:
        a, ra = run(scheme, n_drives, "cuda")
        b, rb = run(scheme, n_drives, "cpu")
        for ia, ib in zip(drive_images(a.drives), drive_images(b.drives)):
            for key in ia:
                if not np.array_equal(ia[key], ib[key]):
                    raise AssertionError(f"{scheme}: drive image {key} differs")
        if not np.array_equal(ra, rb):
            raise AssertionError(f"{scheme}: degraded reads differ")
        if not np.array_equal(a.l2p.get_many(np.arange(256)), b.l2p.get_many(np.arange(256))):
            raise AssertionError(f"{scheme}: L2P differs")
        if dataclasses.asdict(a.stats) != dataclasses.asdict(b.stats):
            raise AssertionError(f"{scheme}: stats differ")
        out[scheme] = "equal"
    return out


# ------------------------------------------------------ phase 6: serving

def mamba2_model(seed: int, ph: Phase):
    """``mamba2-1.3b`` at full width on the card, random weights from
    ``seed``, warmed up (cuBLAS plans, the caching allocator) by one short
    serving run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build_model

    cfg = get_config("mamba2-1.3b")
    t = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    ph.info["init_s"] = time.perf_counter() - t
    rng = np.random.default_rng(seed + 1)
    warm = [rng.integers(0, cfg.vocab, (SERVE["prompt"],)) for _ in range(SERVE["batch"])]
    serve(model, warm, batch=SERVE["batch"], gen_len=2)
    ph.info.update({"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
                    "params": sum(w.numel() for w in model.parameters())})
    return model


def mamba2_serve(model, seed: int, ph: Phase):
    """Serve ``SERVE`` through the port's serve loop; check the logits are
    finite and of the right shape and the tokens in range.  Returns the
    serving stats."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import greedy, serve

    vocab = model.cfg.vocab
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, vocab, (SERVE["prompt"],)) for _ in range(SERVE["requests"])]
    finite = []

    def choose(logits):
        if logits.shape != (SERVE["batch"], 1, vocab):
            raise AssertionError(f"logits of shape {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return greedy(logits)

    torch.cuda.reset_peak_memory_stats()
    st = serve(model, queue, batch=SERVE["batch"], gen_len=SERVE["gen"], choose=choose)
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits while serving")
    outs = np.stack(st.outputs)
    if outs.shape != (SERVE["requests"], SERVE["gen"]) or outs.min() < 0 or outs.max() >= vocab:
        raise AssertionError(f"generated tokens of shape {outs.shape} out of range")
    ph.info.update({
        **SERVE, "requests_served": st.requests, "prefill_calls": st.prefill_calls,
        "prefill_tokens": st.prefill_tokens, "decode_tokens": st.decode_tokens,
        "prefill_s": st.prefill_s, "decode_s": st.decode_s,
        "prefill_tok_s": st.prefill_tok_s, "decode_tok_s": st.decode_tok_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })
    return st


def serve_profile(model, seed: int, ph: Phase) -> None:
    """Device time by kernel (``torch.profiler``) over one prefill call and
    one decode step at the serving shape, against the wall time of each;
    the difference is the share of the call the card sat idle."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(seed + 2)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (SERVE["batch"], SERVE["prompt"])))
    toks = toks.cuda()
    _, cache = model.prefill(toks)
    nxt = toks[:, -1:]
    for name, call in (("prefill", lambda: model.prefill(toks)),
                       ("decode_step", lambda: model.decode_step(cache, nxt))):
        call()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
        top = sorted(ev, key=lambda e: -e.self_device_time_total)[:10]
        ph.info[name] = {
            "wall_ms": wall_ms, "device_ms": dev_ms, "idle_share": 1 - dev_ms / wall_ms,
            "kernels": sum(e.count for e in ev),
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
        }


def decode_matches_prefill(seed: int, ph: Phase) -> None:
    """In f32 at full width: prefill(t) then k decode steps against
    prefill(t + i) for each step i."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dc.replace(get_config("mamba2-1.3b"), dtype="float32")
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed))
    b, t, k = DECODE_CHECK["batch"], DECODE_CHECK["t"], DECODE_CHECK["k"]
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (b, t + k))).cuda()
    logits, cache = model.prefill(toks[:, :t])
    errs = []
    for i in range(k):
        logits, cache = model.decode_step(cache, toks[:, t + i : t + i + 1])
        want, _ = model.prefill(toks[:, : t + i + 1])
        errs.append(float((logits - want).abs().max()))
        if not (torch.isfinite(logits).all()
                and torch.allclose(logits, want, atol=DECODE_TOL, rtol=DECODE_TOL)):
            raise AssertionError(f"decode step {i} differs from prefill({t + i + 1}): "
                                 f"max abs err {errs[-1]}")
    ph.info.update({"dtype": cfg.dtype, "batch": b, "t": t, "k": k, "tol": DECODE_TOL,
                    "max_abs_err": errs, "logit_abs_max": float(want.abs().max())})


# ---------------------------------------------------------------------- main

def main() -> int:
    src = ROOT / "src"
    csrc = src / "repro_torch" / "kernels" / "csrc"
    if not all((csrc / f).is_file() for f in ("codec.cu", "ssd_scan.cu")):
        return _die(f"no repro_torch package under {src}: run from a checkout")
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        return _die("torch.cuda.is_available() is false: this test needs a GPU")
    from repro_torch.kernels import CODEC_KERNELS, _build, launch_counts, reset_launch_counts

    def smi(query: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]

    gpu = smi("name,power.limit")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_ops_per_s = INT32_LANES_PER_SM_CLOCK * sms * max_sm_mhz * 1e6
    _emit({"torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0], "gpu": gpu, "sms": sms,
           "max_sm_mhz": max_sm_mhz, "int32_ops_per_s": int32_ops_per_s})

    t = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load()
    alu_per_load = alu_ops_per_row_load(lib)
    tensor_ops = tensor_core_instructions(lib)
    _emit({"phase": "build", "seconds": time.perf_counter() - t, "library": lib.name,
           "alu_ops_per_row_load": alu_per_load, "ssd_tensor_core_instructions": tensor_ops,
           "stripe_loads_before_first_combine": stripe_loads_first(lib)})

    with Phase("kernels") as ph:
        rates = link_rates()
        floor = launch_floor()
        batch_rows = kernel_checks(alu_per_load, int32_ops_per_s)
        stripe_rows = stripe_checks(int32_ops_per_s, alu_per_load, rates)
        rows = [batch_rows[0], stripe_rows[0], batch_rows[1], stripe_rows[1]]
        trips = codec_round_trips()
        ssd_rows = ssd_checks()
        ph.info.update(gpu=gpu, link=rates, launch_floor=floor, round_trips=trips)
        ph.info["kernels"] = [
            {k: r[k] for k in ("name", "shape", "ms", "call_ms", "plain_ms",
                               "plain_call_ms", "bytes_us", "ops_us", "bound_by",
                               "cases", "form", "device_operands") if k in r}
            for r in rows]
        for r in ssd_rows:
            ph.info[r["name"]] = {k: v for k, v in r.items()
                                  if k not in ("route", "source", "replaces", "launches")}

    reset_launch_counts()  # the main path's launches start here
    with Phase("raid5") as ph:
        raid_end_to_end("raid5", "cuda", FULL, SEED, ph)
    gc.collect()
    c = launch_counts()
    if not (c["parity_xor_batch"] and c["parity_xor"]):
        raise AssertionError(f"raid5 did not launch both xor_reduce forms: {c}")
    before = c
    with Phase("raid6") as ph:
        raid_end_to_end("raid6", "cuda", FULL, SEED, ph)
    gc.collect()
    c = launch_counts()
    for name in ("gf256_matmul_batch", "gf256_matmul"):
        if c[name] <= before[name]:
            raise AssertionError(f"raid6 did not launch {name}: {c}")
    with Phase("crash") as ph:
        crash_recovery("cuda", FULL, SEED, ph)
    gc.collect()
    main_path = launch_counts()  # read just after the datapath's phases
    idle = [k for k in CODEC_KERNELS if main_path[k] == 0]
    if idle:
        raise AssertionError(f"codec kernels never launched on the datapath: {idle}")

    with Phase("card_vs_cpu") as ph:
        ph.info["result"] = card_vs_cpu(SEED)
    gc.collect()

    with Phase("mamba2_setup") as ph:
        model = mamba2_model(SEED, ph)
    reset_launch_counts()  # the serving path's launches start here
    with Phase("mamba2_serve") as ph:
        st = mamba2_serve(model, SEED, ph)
    serving = launch_counts()  # read just after the serving path
    want = model.cfg.n_layers * st.prefill_calls
    for name in ("ssd_scan", "ssd_chunk_gram"):
        if serving[name] != want or want == 0:
            raise AssertionError(f"{name} launched {serving[name]} times while serving, "
                                 f"want {model.cfg.n_layers} per prefill call ({want})")
    with Phase("mamba2_profile") as ph:
        serve_profile(model, SEED, ph)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("mamba2_decode_check") as ph:
        decode_matches_prefill(SEED, ph)

    for r in rows:
        r["launches"] = main_path[r["name"]]
    for r in ssd_rows:
        r["launches"] = serving[r["name"]]
    rows += ssd_rows
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    _emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    print(gpu, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
