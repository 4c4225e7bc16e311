#!/usr/bin/env python3
"""Chip smoke test of ``repro_torch`` on one NVIDIA GPU: ZapRAID's datapath,
its timed pipeline, serving every model family (Mamba-2, dense, MoE, VLM,
the zamba2 hybrid, whisper), the block service, erasure-coded checkpoints
and optimizer state, and training (mamba2-1.3b at full width on the SSD
scan's forward and backward kernels, also on a device mesh whose sharded
state is checkpointed and erasure-coded, checkpointed restarts, every
family), the multi-pod dry run of every architecture, and the reference's
examples on the port.

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
   serving shapes of mamba2-1.3b (64 heads, n = 128) and zamba2-2.7b (80
   heads, n = 64) in bf16 and f32 with and without an initial state, at
   t < chunk, at the CPU tests' shapes, at q = n = p = 128 and on an
   unaligned view, and its C B^T kernel against its own; their SASS must
   hold tensor-core instructions; timed at both serving shapes beside
   their bounds (bytes over the memory rate, or FLOPs over the bf16
   tensor-core rate);
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
6. the timed pipeline -- ``HandlerPipeline.build_timed`` on phase 2's
   deployment with the Zone-Append order from the ZN540 device model,
   preconditioned with phase 2's fill: ``timed`` replays 20,000 requests of
   Exp#10's trace mix (``TIMED``) and reads every acknowledged block back;
   ``timed_degraded`` fails drive 1, rebuilds it under a scanner and a
   uniform reader (``TIMED_DEGRADED``) and reads everything back again.
   Each prints virtual latency percentiles, events fired, and host time per
   request.  ``timed_profile`` replays the first 2,000 requests again under
   ``torch.profiler`` for the card's busy share; ``timed_card_vs_cpu`` runs
   three of the reference's timed scenarios (Exp#10, rebuild under load, a
   degraded RAID-6 replay) on the card and on the CPU and requires every
   virtual-time output, the drive images, L2P and Stats to be equal;
7. serving, every model family the port serves, at full width with random
   weights from ``SEED``, through ``repro_torch.launch.serve.serve`` (8
   requests of 1,024 prompt tokens and 32 generated at batch 4, ``SERVE``):
   ``mamba2_*`` (mamba2-1.3b, 48 layers), ``dense_*`` (qwen2.5-3b, 36
   layers) and ``hybrid_*`` (zamba2-2.7b, 54 Mamba-2 layers and a shared
   attention block applied 9 times) each run ``_setup``, ``_serve``
   (prefill and decode tokens/s, peak device memory, finite logits; 48 or
   54 launches of each SSD kernel per prefill call, none for the dense
   model), ``_profile`` (device time by kernel and the card's idle share of
   one prefill call and one decode step) and ``_decode_check`` (in f32,
   ``prefill(t)`` plus k ``decode_step``s must give the last logits of
   ``prefill(t + i)`` at every step; t = 250 pads a ragged chunk, k = 3).
   ``moe_serve`` serves one batch of llama4-scout at full width, 2 of its
   48 layers, and reports the share of routed slots the capacity dropped;
   ``vlm`` runs paligemma-3b's prefill with a 256-patch stub prefix and 8
   decode steps, then serves it without one, as the reference does;
   ``encdec`` runs whisper-small's encoder over 1,500 stub frames, a
   416-token prefill and 31 decode steps, and ``encdec_decode_check`` its
   f32 decode check;
8. storage_sim -- the block service's scenarios at the reference's sizes
   (``STORAGE_SIM``): checkpoint traffic under serving with QoS and with
   FIFO dispatch, a closed-loop read sweep at four queue depths, and
   degraded reads behind a cold and a warm cache, each with the array's
   codec on the card and on the CPU; every output must be equal and each
   restore bit-identical.  Prints the virtual serving p99s, host seconds
   per run and device, and the kernels each card run launched;
9. ckpt -- the checkpoint engine at a real size (``CKPT``): the first four
   of mamba2-1.3b's layers (bf16 and f32 leaves, built on the card from
   ``SEED``) saved on RAID-5 (3+1), restored, restored with lane 1 failed,
   crash-remounted and restored again; one layer on RAID-6 (3+2) with lanes
   1 and 3 failed.  Every restore must equal the saved tensors bit for bit;
   prints bytes, save and restore MiB/s (host clock);
10. state_parity -- AdamW's m and v (f32, 11.57 GB) for every parameter of
   mamba2-1.3b, ZeRO-1 shards over four ranks (``PARITY``): ``encode_shards``
   with m = 1 and m = 2 on the card, ``reconstruct_shard`` of rank 2 (with
   m = 2 also from both parity rows), bit-exact, the smallest leaves and the
   first MiB of the largest held to the CPU's plain path; encode wall time
   (CUDA events) and peak device memory.  ``state_parity_kernels`` then
   holds ``stripe_xor`` k=4 and ``stripe_gf256`` (2,4) and (4,4) at the
   largest leaf (4 x 100.66 M int32 lanes) to their plain versions and times
   them beside their bounds;
11. training -- ``ssd_grad`` holds the SSD scan's
   backward kernel (``ssd_scan_bwd``) against autograd through the plain
   scan, all six gradients (``SSD_GRAD_TOL``), at mamba2-1.3b's and
   zamba2-2.7b's shapes in bf16 and f32 with and without h0 and the final
   state's gradient, t < chunk, an unaligned view, the rows layout and a
   ragged T through ``ssd_chunked``, each call twice and bit-equal; times
   it at mamba2's training shape beside its bound and plain version (both
   on CUDA events, the profiler's sum beside) and at zamba2-2.7b's
   (``hybrid_shape``), each with the FLOPs it issues on the tensor cores
   and its share of the bound, and checks that the SASS of its three
   product kernels holds tensor-core (HMMA) instructions.  ``mamba2_train``
   trains mamba2-1.3b at full width (``TRAIN``) through
   ``launch.train.run``: step wall time, trained tokens/s, peak memory,
   finite losses and gradient norms, the SSD kernels' launches per step
   (96 forward under remat, 48 backward); ``sharded_train`` trains the
   same run again with the parameters, AdamW state and batches as
   DTensors on ``make_host_mesh()``
   (the card's (1, 1) mesh, an NCCL group of one) under ``use_mesh``: its
   losses and final per-leaf norms must equal ``mamba2_train``'s
   (``RESTART_TOL``; it prints whether they are bit-equal), its step time,
   tokens/s and peak memory beside them; ``sharded_ckpt`` runs on that
   mesh before it is torn down: the trained DTensors of layers 0 and 1
   (parameters and AdamW's master, m and v, ~727 MB) through
   ``launch/train.py``'s RAID-5 engine, saved at step 4 and restored with
   lane 1 failed into the same DTensors (placements kept, global values
   bit-exact; save and restore MiB/s), and ``state_parity``'s ZeRO-1 shards
   of AdamW's m and v (11.57 GB) as DTensors placed as the trained m is,
   encoded with m = 1 and 2 (rows equal to the plain tensors') and rank 2
   rebuilt (DTensors, bit-exact), CUDA-event ms beside the plain phase's;
   it must launch ``xor_reduce``, ``stripe_xor`` and ``stripe_gf256``;
   ``dryrun`` runs the port's dry run
   (``launch/dryrun.py``) of every architecture at full width on the
   256-way production mesh and of the three FSDP ones on the 512-way one
   (``DRYRUN``), over worker processes, one line per cell (per-device
   parameter and state bytes, roofline terms, collectives, SSD custom-op
   calls, ``memory_analysis``), and fails unless every cell
   ``cell_supported`` allows reads "ok" and every other "skip";
   ``mamba2_grad_check`` holds the loss's gradients
   through the kernels to those through the plain scan (2 layers, f32,
   ``TRAIN_GRAD_TOL``); ``train_ckpt`` runs the reference's default
   training run (``TRAIN_CKPT``: RAID-5 checkpoints on the card's codec, a
   failed lane, a restart) and the same with a degraded restore, and the
   recomputed steps must repeat their losses; ``train_families`` takes one
   train step of every architecture at smoke size;
12. examples -- the reference's ten examples on the port
   (``examples/port_*.py``, ``EXAMPLES``), each through its ``main`` on the
   card and on the CPU at the reference's sizes: every byte and virtual-time
   output equal (a training run's losses within ``EXAMPLE_LOSS_TOL``), each
   run's wall time, launches and last line printed, its lines written to
   ``build/examples/``; ``port_degraded_restore`` must launch
   ``gf256_matmul`` (its RAID-6 decode) and ``stripe_xor``.

Each phase prints one JSON line.  The codec kernels' launch counts are
zeroed just before phase 2 and read just after phase 4 (``launches``), and
zeroed again just before ``timed`` and read just after ``timed_degraded``
(``timed_launches``); all of them are zeroed just before each serving run
of phase 7 and read just after it (``launches`` of the SSD rows for
mamba2-1.3b, ``hybrid_launches`` for zamba2-2.7b); the codec's are zeroed
again just before phase 8 and read just after phase 10's runs
(``ckpt_launches``), before its kernels are timed.  The run fails unless each of the four codec kernels
launched there.  All of them are zeroed again just before ``mamba2_train``
and read just after it (``train_launches``; ``launches`` of
``ssd_scan_bwd``), just before and after ``sharded_train``
(``sharded_train_launches``: 96 / 96 / 48 per step, as unsharded), just
before and after ``sharded_ckpt`` (``sharded_ckpt_launches``: those of its
calls on DTensors, its checks against plain tensors left out), and just
before and after ``train_ckpt``'s two runs (``train_ckpt_launches``).  The
``kernels`` line reports them all.
The last two lines are the card's name and power limit and the
``{"ok": true, "device": ...}`` result.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
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

# The timed pipeline on the same deployment: Exp#10's open-loop trace mix
# (benchmarks/run.py bench_trace) over the whole volume -- exponential
# inter-arrivals of mean gap_us (~25 k IOPS), write_frac writes, 1/2/3-block
# requests with probabilities 0.60/0.15/0.25, uniform LBAs -- then, with
# drive 1 failed and a rebuild starting rebuild_after_us later, the read load
# of bench_latency_qos's rebuild row: a sequential scanner and a uniform
# reader at scan_iops / read_iops, ops requests each.  The card's busy share
# is read over the first profile_requests of a second, identical replay.
TIMED = dict(requests=20_000, gap_us=40.0, write_frac=0.85, profile_requests=2_000)
TIMED_DEGRADED = dict(scan_iops=60_000, read_iops=30_000, ops=4_000,
                      rebuild_after_us=50.0)

# Serving at full width (src/repro_torch/configs/): requests, batch, prompt
# and generated tokens of mamba2-1.3b, qwen2.5-3b, zamba2-2.7b and
# paligemma-3b; the decode check's prompt t and steps k.
SERVE = dict(requests=8, batch=4, prompt=1024, gen=32)
DECODE_CHECK = dict(batch=2, t=250, k=3)
# llama4-scout's full width (16 experts of 8,192, top-1, a shared expert;
# 6.47 B parameters in two layers, 12.9 GB of bf16), its depth cut to
# ``layers`` of 48 to fit one card: one batch served.  paligemma-3b: a
# prefill with its 256-patch stub prefix, then decode_steps steps.
# whisper-small: one batch, prompt + gen = 448, the decoder's context in the
# published model, after the encoder over 1,500 stub frames.
MOE_SERVE = dict(SERVE, arch="llama4-scout-17b-a16e", layers=2, requests=4)
VLM = dict(SERVE, arch="paligemma-3b", decode_steps=8)
ENCDEC = dict(SERVE, arch="whisper-small", requests=4, prompt=416)
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
# sum in different orders through 24 to 54 layers (the reference's decode
# test holds 2e-2 at smoke size, tests/test_models.py).
DECODE_TOL = 2e-2

# The block service's scenarios at the reference's --quick sizes
# (benchmarks/run.py bench_service and bench_cache; src/repro_torch/service/
# scenario.py): closed-loop read sweeps at these queue depths of qd_ops reads
# each, and cache_ops degraded reads behind a cold and a warm cache.
STORAGE_SIM = dict(qds=(1, 4, 16, 32), qd_ops=96, cache_ops=600)
# The checkpoint engine at a real size: the first raid5_layers of
# mamba2-1.3b's 48 layers (~52 MB of bf16 and f32 each) on RAID-5 (3+1), one
# on RAID-6 (3+2), 4 KiB blocks, 64 zones of 4,096 blocks per lane.
CKPT = dict(raid5_layers=4, raid6_layers=1,
            geom=dict(zones=64, zone_cap_blocks=4096, logical_blocks=65536))
# State parity at a real optimizer-state size: AdamW's m and v (f32) for
# every parameter of mamba2-1.3b, ZeRO-1 shards over k ranks; the rank rebuilt,
# and how much of it is held to the CPU's plain path (the plain_leaves
# smallest leaves and the first plain_bytes of the largest).
PARITY = dict(k=4, lost=2, plain_leaves=8, plain_bytes=1 << 20)

# The SSD scan's backward kernel against autograd through the plain
# sequential scan, both in f32 arithmetic: max |kernel - plain| over the
# largest |plain| of each gradient.  In f32 they differ in summation order
# and chunked vs step-by-step decays (~3e-6 seen); in bf16 dx, db and dc
# come back rounded to bf16 on both sides (2^-8 relative each).
SSD_GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# Training mamba2-1.3b at full width through the entry point
# (launch/train.py): steps of global_batch x seq_len tokens, bf16 with remat
# as configured.  The gradient check: full width, ``layers`` layers, f32, a
# ragged seq_len, the loss's gradients through the kernels against those
# through the plain SSD scan, per leaf over its largest value (floor:
# GRAD_FLOOR of the largest of all); the forward kernel's f32 operands carry
# ~16 bits (SSD_TOL).
TRAIN = dict(arch="mamba2-1.3b", steps=4, global_batch=4, seq_len=1024, ckpt_every=5)
TRAIN_GRAD = dict(layers=2, batch=2, seq_len=250)
TRAIN_GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-7
# The reference's own default run of the training driver (smoke size, as
# the reference trains): a checkpoint every 5 steps, lane 1 failed after
# step 7, a restart after step 12 from step 10's checkpoint; the recomputed
# steps 11 and 12 must repeat the first pass's losses at the reference
# test's tolerance.
TRAIN_CKPT = ["--arch", "smollm-135m", "--steps", "20", "--ckpt-every", "5",
              "--fail-lane", "1", "--fail-at", "7", "--restart-at", "12"]
# In that run the save at step 10 first rebuilds lane 1 on a hot spare (the
# engine's writes need every lane), so the restore reads healthy lanes; the
# same run with the lane failed after step 11 restores degraded.
TRAIN_CKPT_RUNS = {"default": TRAIN_CKPT,
                   "degraded_restore": TRAIN_CKPT[:9] + ["11"] + TRAIN_CKPT[10:]}
RESTART_TOL = dict(rtol=1e-5, atol=1e-6)
# The checkpoint engine on sharded_train's trained DTensors: the first
# ``layers`` of mamba2-1.3b's 48 layers, parameters (bf16) and AdamW's
# master, m and v (f32), ~727 MB, saved at ``step`` on launch/train.py's
# engine (RAID-5, 4 lanes) with zones sized for it, lane ``fail`` failed
# for the restore.
SHARDED_CKPT = dict(layers=2, step=4, fail=1,
                    geom=dict(zones=64, zone_cap_blocks=4096, logical_blocks=1 << 18))
# The dry run (launch/dryrun.py) of every architecture at full width on the
# 256-way production mesh, and of ``multi`` on the 512-way one (the three
# FSDP configurations, which exist to be sharded), over ``workers`` processes.
DRYRUN = dict(multi=("qwen1.5-110b", "grok-1-314b", "llama4-scout-17b-a16e"), workers=8)
# One train step of every architecture at smoke size on the card.
FAMILY_STEP = dict(global_batch=2, seq_len=16)
# The reference's ten examples on the port (examples/port_*.py), each run on
# the card and on the CPU at the reference's sizes; a training run's losses
# agree between the two within the serving card tests' tolerance.
EXAMPLES = ("quickstart", "trace_replay", "degraded_restore", "train_e2e", "serve",
            "ckpt_under_serving", "warm_cache_degraded", "trace_and_metrics",
            "degraded_writes", "scrub_repair")
EXAMPLE_LOSS_TOL = dict(rtol=2e-4, atol=0.0)


def _die(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------- setup

def array_config(scheme: str, device: str, geom: dict, append_order: str = "rng"):
    from repro_torch.core.array import ZapRaidConfig
    from repro_torch.core.zns import ZnsConfig

    cfg = ZapRaidConfig(
        scheme=scheme, n_drives=4, group_size=geom["group"],
        logical_blocks=geom["logical_blocks"], hybrid=True, n_small=1,
        n_large=3, small_chunk_blocks=2, large_chunk_blocks=4,
        append_order=append_order, device=device,
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

def _sass(library: Path) -> str:
    """The library's SASS (``cuobjdump -sass``, the toolkit's beside nvcc)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout


def alu_ops_per_row_load(library: Path) -> dict[str, float]:
    """ALU-pipe instructions per 16-byte row load in each kernel's main loop,
    from the library's SASS (``cuobjdump -sass``).

    The main loop is the backward branch whose span holds the most 128-bit
    global loads.  A thread runs it once per row it loads, so its ALU
    instructions over its loads, times the row loads of a launch, count the
    launch's ALU work inside that loop."""
    import re

    sass = _sass(library)
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

    sass = _sass(library)
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


def stripe_alu_ops(library: Path) -> dict[str, int]:
    """ALU-pipe instructions in the body of each compile-time, 128-bit
    instance of the single-stripe kernels, keyed as ``STRIPE_INSTANCES``.
    The body has no loop: a thread runs it once for its 16 bytes of every
    row, so the count times the threads of a launch (n / 4) is the launch's
    ALU work (every ALU instruction of the body counted once)."""
    import re

    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)[^;]*;")
    out = {}
    for body in _sass(library).split("Function : ")[1:]:
        kernel = re.search(r"(stripe_xor|stripe_gf256)_kernelILi(\d+)E(?:Li(\d+)E)?Lb1E",
                           body.split(None, 1)[0])
        if kernel is None or kernel[2] == "0":
            continue
        key = f"{kernel[1]}<k={kernel[2]}" + (f",m={kernel[3]}>" if kernel[3] else ">")
        out[key] = sum(op.split(".")[0] in ALU_OPCODES for op in instr.findall(body))
    return out


# torch.profiler has kept no kernel event at all of a short window on the
# H100's machine (a two-call window of a plain version, late in the run; the
# 2,000-request window of timed_profile): an empty window is profiled again,
# up to this many times in all.
PROFILE_WINDOWS = 3


def _profiled_device_us(run) -> float:
    """The summed device time (µs) of the GPU kernels and memsets that
    ``run()`` queues, from ``torch.profiler``; an empty window is profiled
    again (``PROFILE_WINDOWS``), noted on stderr; raises if none holds any."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for window in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages())
        if dev_us > 0:
            return dev_us
        print(f"chip_smoke: profiler window {window + 1} of {PROFILE_WINDOWS} held no "
              "device time", file=sys.stderr, flush=True)
    raise RuntimeError("torch.profiler recorded no device time for the timed calls")


def _event_ms(fn, args_list, iters: int) -> float:
    """CUDA-event ms per call, from the first of ``iters`` calls cycling
    through ``args_list`` to the last, after two warm-up calls; it includes
    the host's launch overhead whenever the host cannot keep the card busy."""
    import torch

    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_ms(fn, args_list, iters: int) -> tuple[float, float]:
    """(device ms, call ms) per call, over ``iters`` calls cycling through
    ``args_list`` (distinct copies whose total exceeds the 50 MB L2, so
    inputs come from device memory).

    Device ms is the summed time of the GPU kernels (and memsets) the calls
    ran, from ``torch.profiler`` (``_profiled_device_us``).  Call ms is
    CUDA-event time (``_event_ms``)."""

    def run():
        for i in range(iters):
            fn(*args_list[i % len(args_list)])

    call_ms = _event_ms(fn, args_list, iters)
    return _profiled_device_us(run) / 1e3 / iters, call_ms


def _time_host_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``, a launch that returns once
    its result is in host memory: device ms is the kernel's time from
    ``torch.profiler`` (the link's crossings included); call ms is host-clock
    time per call, launch to return."""
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    call_ms = 1e3 * (time.perf_counter() - t0) / iters

    def run():
        for _ in range(iters):
            fn()

    return _profiled_device_us(run) / 1e3 / iters, call_ms


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


def tensor_core_instructions(library: Path) -> dict[str, int]:
    """HMMA/HGMMA instructions in the SASS of each SSD kernel instance
    (``cuobjdump -sass``); raises if one has none."""
    import re

    out = {}
    for body in _sass(library).split("Function : ")[1:]:
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
    both at mamba2-1.3b's serving shape, and at zamba2-2.7b's
    (``hybrid_shape``).  Returns the ``ssd_scan`` and ``ssd_chunk_gram``
    rows."""
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
    hyb = get_config("zamba2-2.7b")  # the hybrid's: 80 heads of P=64, N=64
    zh, zp, zn = hyb.ssm_nheads, hyb.ssm_head_dim, hyb.ssm_state
    if hyb.ssm_chunk != chunk:
        raise AssertionError("the two serving shapes share one chunk length")

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
    ] + [  # zamba2-2.7b's prefill scan at the serving shape: n = 64, 640 blocks
        (f"zamba2 {dt_}{' h0' if h0 else ''}", heads(d, nb, t, zh, zp, zn, h0=h0), chunk)
        for dt_, d in (("bf16", bf16), ("f32", f32)) for h0 in (False, True)
    ]
    cont = rows(f32, 2, 128, 4, 8)  # state continuation (tests/test_kernels.py)
    max_err, worst, hyb_err = 0.0, None, 0.0
    for label, args, ch in cases:
        got, want = ssd.ssd_scan(*args, chunk=ch), ssd.ssd_scan_plain(*args)
        for g, w in zip(got, want):
            err = float((g - w).abs().max())
            if not torch.allclose(g, w, atol=SSD_TOL, rtol=SSD_TOL) or g.shape != w.shape:
                raise AssertionError(f"ssd_scan {label}: kernel differs from its plain "
                                     f"version (max abs err {err})")
            if err > max_err:
                max_err, worst = err, label
            if label.startswith("zamba2"):
                hyb_err = max(hyb_err, err)
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

    def timing(nh, p, n):
        """Both kernels timed at (nb, t) with nh heads of p and state n, in
        bf16, beside their plain versions, bounds and (for G) the library
        call: (scan numbers, G numbers)."""
        main = heads(bf16, nb, t, nh, p, n)
        nbytes = ssd.ssd_bytes(main)
        copies = [main] + [heads(bf16, nb, t, nh, p, n)
                           for _ in range(max(1, (96 << 20) // nbytes))]
        ms, call_ms = _time_ms(lambda *a_: ssd.ssd_scan(*a_, chunk=chunk), copies, 20)
        plain_ms, plain_call_ms = _time_ms(ssd.ssd_scan_plain, copies, 3)
        flops = ssd.ssd_flops(nb, nh, t, chunk, n, p)
        tensor_flops = ssd.ssd_tensor_flops(nb, nh, t, chunk, n, p)
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        op_ms = 1e3 * flops / BF16_TENSOR_FLOP_PER_S
        scan = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": None,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "shape": [list(v.shape) if v is not None else None for v in main],
            "bytes_us": 1e3 * byte_ms, "ops_us": 1e3 * op_ms, "flops": flops,
            "bytes": nbytes, "bound_share": max(byte_ms, op_ms) / ms,
            # what the two kernels issue on the tensor cores (split halves and
            # padding included), its time at the dense bf16 rate, and its rate
            "tensor_flops": tensor_flops,
            "tensor_us": 1e6 * tensor_flops / BF16_TENSOR_FLOP_PER_S,
            "tensor_flop_per_s": tensor_flops / (ms * 1e-3),
        }
        del copies

        # G alone: b, c in, the tiles out; the library call is one batched
        # matmul of the chunks (the whole q x q block, bf16 out).
        def gram_args():
            return heads(bf16, nb, t, 1, p, n)[3:5]

        gb, gc_ = gram_args()
        gram = ssd.chunk_gram(gb, gc_, chunk=chunk)
        g_bytes = 2 * gb.numel() * gb.element_size() + 4 * gram.numel()
        g_flops = (t // chunk) * nb * chunk * (chunk + 1) * n
        gcopies = [(gb, gc_)] + [gram_args() for _ in range(max(1, (96 << 20) // g_bytes))]
        g_ms, g_call_ms = _time_ms(lambda b_, c_: ssd.chunk_gram(b_, c_, chunk=chunk),
                                   gcopies, 50)
        g_plain_ms, _ = _time_ms(lambda b_, c_: ref.ssd_chunk_gram_ref(b_, c_, chunk),
                                 gcopies, 10)
        lib_ms, _ = _time_ms(lambda b_, c_: torch.matmul(
            c_.unflatten(1, (-1, chunk)), b_.unflatten(1, (-1, chunk)).transpose(-1, -2)),
            gcopies, 50)
        g_byte_ms = 1e3 * g_bytes / HBM_BYTES_PER_S
        g_op_ms = 1e3 * g_flops / BF16_TENSOR_FLOP_PER_S
        gram_t = {
            "ms": g_ms, "plain_ms": g_plain_ms, "bound_ms": max(g_byte_ms, g_op_ms),
            "bound_by": "bytes" if g_byte_ms >= g_op_ms else "operations",
            "library_ms": lib_ms, "call_ms": g_call_ms, "shape": [list(gb.shape), list(gc_.shape)],
            "bytes_us": 1e3 * g_byte_ms, "ops_us": 1e3 * g_op_ms,
        }
        return scan, gram_t

    scan_main, gram_main = timing(nh, p, n)
    scan_hyb, gram_hyb = timing(zh, zp, zn)
    scan_row = {
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:90", "launches": 0, "max_abs_err": max_err,
        **scan_main, "cases": len(cases) + 1, "worst_case": worst, "tol": SSD_TOL,
        "hybrid_shape": {**scan_hyb, "max_abs_err": hyb_err},
    }
    gram_row = {
        "name": "ssd_chunk_gram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:52", "launches": 0, "max_abs_err": gram_err,
        **gram_main, "cases": len(cases), "hybrid_shape": gram_hyb,
    }
    return [scan_row, gram_row]


def bwd_tensor_core_instructions(library: Path) -> dict[str, int]:
    """HMMA/HGMMA instructions in the SASS of each instance of the
    backward's three product kernels (the state pass, the per-chunk
    gradients, db and dc); raises if one has none, as
    ``tensor_core_instructions`` does for the forward."""
    import re

    out = {}
    for body in _sass(library).split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        kernel = re.search(
            r"(ssd_bwd_dstate_kernel|ssd_bwd_chunk_kernel|ssd_bwd_dbc_kernel)I(\w+?)Lb([01])E",
            name)
        if kernel is None:
            continue
        key = f"{kernel[1]}<{'bf16' if 'bfloat16' in kernel[2] else 'f32'}," \
              f"{'async' if kernel[3] == '1' else 'scalar'}>"
        out[key] = len(re.findall(r"\bH(?:G)?MMA\.", body))
    if len(out) != 9 or not all(out.values()):
        raise RuntimeError(f"SSD backward kernels without tensor-core instructions in their "
                           f"SASS: {out}")
    return out


def ssd_grad_checks(library: Path) -> dict:
    """Hold ``ssd_scan_bwd`` against autograd through the plain scan on the
    card: all six gradients at mamba2-1.3b's and zamba2-2.7b's shapes in bf16
    and f32, with and without h0 and the final state's gradient, t < chunk,
    an unaligned view, the rows layout (a, b, c per row), and a ragged T
    through ``ssd_chunked`` (the model's call, padding and slice included);
    each twice, bit-equal.  Times it at mamba2's training shape beside its
    bound and plain version, and at zamba2's (``hybrid_shape``).  Returns
    the kernel's row."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.mamba2 import ssd_chunked

    rng = np.random.default_rng(13)
    cfg, hyb = get_config("mamba2-1.3b"), get_config("zamba2-2.7b")
    nb, t, chunk = TRAIN["global_batch"], TRAIN["seq_len"], cfg.ssm_chunk
    bf16, f32 = torch.bfloat16, torch.float32

    def heads(dtype, nb, t, nh, p, n, h0=False, dh=False, skew=0):
        """(x, dt, a, b, c, h0, dy, dh): x, b, c strided views of one conv
        output as ``mamba_apply`` gives them; dy f32."""
        wide = nh * p + 2 * n
        conv = torch.from_numpy(rng.standard_normal(nb * t * wide + skew).astype(np.float32))
        conv = conv.to("cuda", dtype)[skew:].view(nb, t, wide)
        f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).cuda()  # noqa: E731
        dt = torch.from_numpy(rng.uniform(0.01, 0.2, (nb, t, nh)).astype(np.float32)).cuda()
        a = -torch.from_numpy(rng.uniform(0.5, 2.0, (nh,)).astype(np.float32)).cuda()
        return (conv[..., : nh * p].reshape(nb, t, nh, p), dt, a,
                conv[..., nh * p : nh * p + n], conv[..., nh * p + n :],
                f(nb, nh, n, p) if h0 else None, f(nb, t, nh, p), f(nb, nh, n, p) if dh else None)

    def rows(dtype, bh, t, p, n, h0=False):
        """(x, dt, a, b, c, h0, dy, dh) in the rows layout: a and b, c per row."""
        f = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).cuda()  # noqa: E731
        dt = torch.from_numpy(rng.uniform(0.01, 0.2, (bh, t)).astype(np.float32)).cuda()
        a = -torch.from_numpy(rng.uniform(0.5, 2.0, (bh,)).astype(np.float32)).cuda()
        return (f(bh, t, p).to(dtype), dt, a, f(bh, t, n).to(dtype), f(bh, t, n).to(dtype),
                f(bh, n, p) if h0 else None, f(bh, t, p), f(bh, n, p))

    main = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state)
    zam = (hyb.ssm_nheads, hyb.ssm_head_dim, hyb.ssm_state)
    cases = [
        ("mamba2 bf16", bf16, heads(bf16, nb, t, *main), chunk),
        ("mamba2 bf16 h0 dh", bf16, heads(bf16, nb, t, *main, h0=True, dh=True), chunk),
        ("mamba2 f32", f32, heads(f32, nb, t, *main), chunk),
        ("mamba2 f32 h0 dh", f32, heads(f32, nb, t, *main, h0=True, dh=True), chunk),
        ("zamba2 bf16 dh", bf16, heads(bf16, nb, t, *zam, dh=True), chunk),
        ("zamba2 f32 h0 dh", f32, heads(f32, nb, t, *zam, h0=True, dh=True), chunk),
        ("t<chunk bf16 h0 dh", bf16, heads(bf16, 2, 100, 8, *main[1:], h0=True, dh=True), chunk),
        ("t<chunk f32", f32, heads(f32, 2, 64, 8, *main[1:]), chunk),
        ("unaligned bf16 h0 dh", bf16, heads(bf16, 2, 256, 8, *main[1:], True, True, skew=1),
         chunk),
    ] + [  # the Pallas kernel's rows layout, at the CPU tests' shapes
        (f"rows t={tt} chunk={ch} {dt_}", d, rows(d, 3, tt, 8, 16, h0=h0), ch)
        for tt, ch, h0 in [(64, 16, True), (256, 64, False)]
        for dt_, d in (("f32", f32), ("bf16", bf16))
    ]
    names = ("dx", "ddt", "da", "db", "dc", "dh0")
    worst, max_rel, max_abs = None, 0.0, 0.0

    def hold(label, dtype, got, want, again=None):
        nonlocal worst, max_rel, max_abs
        for name, g, w, *g2 in zip(names, got, want, *([again] if again else [])):
            if w is None:
                continue
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"ssd_scan_bwd {label} {name}: {g.dtype} {tuple(g.shape)} "
                                     f"against {w.dtype} {tuple(w.shape)}")
            if g2 and not torch.equal(g, g2[0]):
                raise AssertionError(f"ssd_scan_bwd {label} {name}: two calls differ")
            err = float((g.float() - w.float()).abs().max())
            rel = err / max(float(w.float().abs().max()), 1e-30)
            if not rel <= SSD_GRAD_TOL[str(dtype).removeprefix("torch.")]:
                raise AssertionError(f"ssd_scan_bwd {label} {name}: kernel differs from "
                                     f"autograd through the plain scan ({rel} of the largest)")
            max_abs = max(max_abs, err)
            if rel > max_rel:
                max_rel, worst = rel, f"{label} {name}"

    for label, dtype, args, ch in cases:
        got = ssd.ssd_scan_bwd(*args, chunk=ch)
        again = ssd.ssd_scan_bwd(*args, chunk=ch)
        hold(label, dtype, got, ssd.ssd_scan_bwd_plain(*args, chunk=ch), again)
        del got, again
    # a ragged T through the model's ssd_chunked: dt = 0 padding, the slice back
    for dtype in (bf16, f32):
        x, dt, a, b, c, h0, dy, dh = heads(dtype, 2, 250, 8, *main[1:], h0=True, dh=True)
        grads = []
        for dev in ("cuda", "cpu"):
            ins = [v.detach().to(dev).requires_grad_() for v in (x, dt, a, b, c, h0)]
            y, h = ssd_chunked(*ins, chunk=chunk)
            ((y.float() * dy.to(dev)).sum() + (h * dh.to(dev)).sum()).backward()
            grads.append([v.grad.to("cuda") for v in ins])
        hold(f"ssd_chunked t=250 {dtype}", dtype, *grads)

    def timing(shape, plain: bool) -> dict:
        """The kernel at (nb, t) with ``shape`` = (heads, p, n), bf16, no h0
        and no final-state gradient (as the loss gives it), on two copies in
        turn.  Its time is the CUDA-event time of 10 calls back to back: the
        host queues a call's six kernels in tens of µs while the card takes
        hundreds, so the events time the card.  The profiler's sum is printed
        beside it (it has dropped kernel events of a window on the card's
        machine).  The plain version on CUDA events alone: profiling its
        ~10^5 small kernels per call has cost the profiler events of later
        windows."""
        timed = heads(bf16, nb, t, *shape)
        copies = []
        for args in (timed, heads(bf16, nb, t, *shape)):
            copies.append((*args, ssd.ssd_scan_states(*args[:6], chunk=chunk)[2]))
        profiler_ms, ms = _time_ms(
            lambda *a: ssd.ssd_scan_bwd(*a[:8], chunk=chunk, hprev=a[8]), copies, 10)
        plain_ms = _event_ms(lambda *a: ssd.ssd_scan_bwd_plain(*a[:8], chunk=chunk), copies,
                             2) if plain else None
        nh_, p_, n_ = shape
        flops = ssd.ssd_bwd_flops(nb, nh_, t, chunk, n_, p_)
        groups = ssd._head_groups(nb * (t // chunk), nh_, "cuda")[0]
        tensor_flops = ssd.ssd_bwd_tensor_flops(nb, nh_, t, chunk, n_, p_, groups)
        nbytes = ssd.ssd_bwd_bytes(timed)
        byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        op_ms = 1e3 * flops / BF16_TENSOR_FLOP_PER_S
        return {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations", "library_ms": None,
            "ms_from": "CUDA events", "profiler_ms": profiler_ms,
            "plain_ms_from": "CUDA events",
            "shape": [list(v.shape) if v is not None else None for v in timed],
            "bytes": nbytes, "flops": flops, "bytes_us": 1e3 * byte_ms, "ops_us": 1e3 * op_ms,
            "bound_share": max(byte_ms, op_ms) / ms,
            # what the kernels issue on the tensor cores (split halves and
            # padding included), its time at the dense bf16 rate, and its rate
            "tensor_flops": tensor_flops,
            "tensor_us": 1e6 * tensor_flops / BF16_TENSOR_FLOP_PER_S,
            "tensor_flop_per_s": tensor_flops / (ms * 1e-3),
        }

    return {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/mamba2.py:71", "launches": 0,
        "max_abs_err": max_abs, "max_rel_err": max_rel, "worst_case": worst,
        "tol": SSD_GRAD_TOL, "cases": len(cases) + 2,
        **timing(main, plain=True), "hybrid_shape": timing(zam, plain=False),
        "tensor_core_instructions": bwd_tensor_core_instructions(library),
    }


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


# ------------------------------------------------- phase 6: timed pipeline

def trace_requests(logical_blocks: int, n: int, seed: int):
    """Exp#10's request mix (``benchmarks/run.py`` bench_trace) over
    ``logical_blocks``: ``n`` open-loop requests, ``TIMED``'s arrival rate
    and write share, 1-3 blocks at uniform LBAs."""
    import numpy as np
    from repro_torch.sim import Request

    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for _ in range(n):
        t += float(rng.exponential(TIMED["gap_us"]))
        r = rng.random()
        nb = 1 if r < 0.60 else (2 if r < 0.75 else 3)
        lba = int(rng.integers(0, logical_blocks - nb))
        op = "W" if rng.random() < TIMED["write_frac"] else "R"
        reqs.append(Request(t, "trace", op, lba, nb))
    return reqs


def timed_pipeline(device: str, geom: dict, seed: int):
    """``HandlerPipeline.build_timed`` on the hybrid deployment with the
    Zone-Append order taken from the device model, preconditioned with phase
    2's fill.  Returns the pipeline, the volume's image and a payload source
    that keeps the image up to date with every write it makes."""
    import numpy as np
    from repro_torch.core.handlers import HandlerPipeline

    cfg, zns = array_config("raid5", device, geom, append_order="timed")
    pipe = HandlerPipeline.build_timed(cfg, zns, seed=seed)
    want = payload(cfg.logical_blocks, seed)
    pipe.precondition((lba, want[lba : lba + n])
                      for lba, n in traffic(cfg.logical_blocks, seed))
    rng = np.random.default_rng(seed + 2)

    def payload_fn(r):
        blk = rng.integers(0, 256, (r.n_blocks, BLOCK_BYTES), dtype=np.uint8)
        want[r.lba : r.lba + r.n_blocks] = blk  # requests dispatch in this order
        return blk

    return pipe, want, payload_fn


def _latency(rec, op: str) -> dict:
    p = rec.percentiles(op=op)
    return {k: p[k] for k in ("n", "p50", "p99", "p999", "mean", "max")}


def timed_replay(device: str, geom: dict, seed: int, ph: Phase,
                 n_requests: int = TIMED["requests"]):
    """Replay Exp#10's mix on the timed pipeline, then read back every
    acknowledged block.  Returns the pipeline and the volume's image."""
    pipe, want, payload_fn = timed_pipeline(device, geom, seed)
    reqs = trace_requests(pipe.array.cfg.logical_blocks, n_requests, seed + 3)
    t, c = time.perf_counter(), time.process_time()
    rec = pipe.replay(reqs, payload_fn)
    wall, cpu = time.perf_counter() - t, time.process_time() - c
    check_read_all(pipe.array, want, "timed read-back")
    eng = pipe.engine
    ph.info.update({
        "requests": n_requests, "write_us": _latency(rec, "W"), "read_us": _latency(rec, "R"),
        "throughput_mib_s": rec.throughput_mib_s(BLOCK_BYTES, "W"),
        "virtual_us": rec.span_us(), "events_fired": eng.events_fired,
        "host_s": wall, "host_cpu_s": cpu, "host_us_per_request": 1e6 * wall / n_requests,
        "encode_sync_us": {"count": rec.note_counts["encode_sync_us"],
                           "sum": rec.notes["encode_sync_us"]},
        "group_barrier_wait_us": {"count": rec.note_counts["group_barrier_wait_us"],
                                  "sum": rec.notes["group_barrier_wait_us"]},
        "stage_means_us": rec.stage_means(), "counters": dict(pipe.counters),
        "readback": "byte-exact",
    })
    return pipe, want


def timed_degraded(pipe, want, seed: int, ph: Phase, n_ops: int = TIMED_DEGRADED["ops"]) -> None:
    """On the pipeline ``timed_replay`` left: fail drive 1, start its rebuild
    ``rebuild_after_us`` later, replay the rebuild-under-load read load, then
    read back every acknowledged block.  The read-back before it ran outside
    the measured timeline, so the drives start idle (``precondition(())``)."""
    from repro_torch.sim import TenantSpec, multi_tenant

    pipe.precondition(())
    t0 = pipe.engine.now
    pipe.array.fail_drive(1)
    pipe.schedule_rebuild(1, at=t0 + TIMED_DEGRADED["rebuild_after_us"])
    logical = pipe.array.cfg.logical_blocks
    load = [dataclasses.replace(r, t_us=r.t_us + t0) for r in multi_tenant([
        TenantSpec(name="scanner", kind="seq", n_ops=n_ops,
                   rate_iops=TIMED_DEGRADED["scan_iops"], read_frac=1.0, seed=seed + 31),
        TenantSpec(name="reader", kind="uniform", n_ops=n_ops,
                   rate_iops=TIMED_DEGRADED["read_iops"], read_frac=1.0, seed=seed + 32),
    ], logical_blocks=logical)]
    events0 = pipe.engine.events_fired
    t = time.perf_counter()
    rec = pipe.replay(load)
    wall = time.perf_counter() - t
    check_read_all(pipe.array, want, "read-back after the timed rebuild")
    ph.info.update({
        "reads": 2 * n_ops, "read_us": _latency(rec, "R"),
        "rebuild_device_us": rec.notes["rebuild_device_us"],
        "virtual_us": pipe.engine.now - t0, "events_fired": pipe.engine.events_fired - events0,
        "host_s": wall, "host_us_per_request": 1e6 * wall / (2 * n_ops),
        "degraded_reads": pipe.array.stats.degraded_reads, "readback": "byte-exact",
    })


def timed_busy_share(geom: dict, seed: int, ph: Phase,
                     n_requests: int = TIMED["profile_requests"]) -> None:
    """The card's busy share of the timed path: the first ``n_requests`` of
    ``timed_replay``'s stream on a second pipeline built the same way, under
    ``torch.profiler``; kernel device time (and copies apart) over wall time.
    A window in which the profiler kept no kernel is replayed on a fresh
    pipeline, up to ``PROFILE_WINDOWS`` in all; raises if none held one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts

    for window in range(PROFILE_WINDOWS):
        # a fresh pipeline per window: the replay advances the pipeline's state
        pipe, _, payload_fn = timed_pipeline("cuda", geom, seed)
        reqs = trace_requests(pipe.array.cfg.logical_blocks, TIMED["requests"],
                              seed + 3)[:n_requests]
        torch.cuda.synchronize()
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.replay(reqs, payload_fn)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        after = launch_counts()
        if any(e.self_device_time_total > 0 and not e.key.startswith(("Memcpy", "Memset"))
               for e in prof.key_averages()):
            break
        print(f"chip_smoke: timed_profile window {window + 1} of {PROFILE_WINDOWS} held no "
              "kernel", file=sys.stderr, flush=True)
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    copies = [e for e in ev if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in ev if e not in copies]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    copy_ms = sum(e.self_device_time_total for e in copies) / 1e3
    ph.info.update({
        "requests": n_requests, "profile_windows": window + 1, "wall_ms": wall_ms,
        "kernel_ms": kernel_ms,
        "copy_ms": copy_ms, "busy_share": kernel_ms / wall_ms,
        "busy_share_with_copies": (kernel_ms + copy_ms) / wall_ms,
        "kernels": sum(e.count for e in kernels),
        # what the wrappers launched in the window, to hold the count above to
        "launches_in_window": {k: after[k] - before[k] for k in after if after[k] > before[k]},
        "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]],
    })
    if not kernels:
        raise AssertionError("the profiler saw no kernel of the timed path")


# The three scenarios timed_card_vs_cpu runs on both devices: the reference's
# timed benchmarks at their own geometry (256-byte blocks, 64-block zones).

def scenario_exp10(device: str):
    """``benchmarks/run.py`` bench_trace: RAID-5 hybrid (3+1), G=8, 20 zones,
    600 requests of Exp#10's mix."""
    import numpy as np
    from repro_torch.core.array import ZapRaidConfig
    from repro_torch.core.handlers import HandlerPipeline
    from repro_torch.core.zns import ZnsConfig
    from repro_torch.sim import Request

    rng = np.random.default_rng(5)
    cfg = ZapRaidConfig(scheme="raid5", n_drives=4, hybrid=True, n_small=1, n_large=3,
                        group_size=8, small_chunk_blocks=1, large_chunk_blocks=2,
                        logical_blocks=256, gc_free_segments_low=1, device=device)
    pipe = HandlerPipeline.build_timed(
        cfg, ZnsConfig(n_zones=20, zone_cap_blocks=64, block_bytes=256), seed=5)
    pipe.precondition((lba, rng.integers(0, 256, (1, 256), dtype=np.uint8))
                      for lba in range(256))
    reqs, t = [], 0.0
    for _ in range(600):
        t += float(rng.exponential(40.0))
        r = rng.random()
        n = 1 if r < 0.60 else (2 if r < 0.75 else 3)
        lba = int(rng.integers(0, 256 - n))
        reqs.append(Request(t, "trace", "W" if rng.random() < 0.85 else "R", lba, n))
    pipe.replay(reqs)
    return pipe


def scenario_qos_rebuild(device: str):
    """``benchmarks/run.py`` bench_latency_qos, recovery under load: RAID-5
    (3+1), G=8, 16 zones, drive 1 failed, its rebuild at 50 us under a
    sequential scanner (60 k IOPS) and a uniform reader (30 k IOPS), 800
    reads each."""
    import numpy as np
    from repro_torch.core.array import ZapRaidConfig
    from repro_torch.core.handlers import HandlerPipeline
    from repro_torch.core.zns import ZnsConfig
    from repro_torch.sim import TenantSpec, multi_tenant

    rng = np.random.default_rng(11)
    cfg = ZapRaidConfig(scheme="raid5", n_drives=4, group_size=8, chunk_blocks=1,
                        logical_blocks=256, gc_free_segments_low=1, device=device)
    pipe = HandlerPipeline.build_timed(
        cfg, ZnsConfig(n_zones=16, zone_cap_blocks=64, block_bytes=256), seed=11)
    pipe.precondition((lba, rng.integers(0, 256, (1, 256), dtype=np.uint8))
                      for lba in range(256))
    pipe.array.fail_drive(1)
    pipe.schedule_rebuild(1, at=50.0)
    pipe.replay(multi_tenant([
        TenantSpec(name="scanner", kind="seq", n_ops=800, rate_iops=60_000,
                   read_frac=1.0, seed=31),
        TenantSpec(name="reader", kind="uniform", n_ops=800, rate_iops=30_000,
                   read_frac=1.0, seed=32),
    ], logical_blocks=256))
    return pipe


def scenario_raid6_degraded(device: str):
    """RAID-6 (2+2) hybrid with Exp#10's geometry and drive 1 failed: 600
    requests, half reads, at 40 k IOPS -- Zone-Append groups and Zone-Write
    stripes encode, and degraded reads decode, in GF(256)."""
    import numpy as np
    from repro_torch.core.array import ZapRaidConfig
    from repro_torch.core.handlers import HandlerPipeline
    from repro_torch.core.zns import ZnsConfig
    from repro_torch.sim import TenantSpec, synthetic

    rng = np.random.default_rng(7)
    cfg = ZapRaidConfig(scheme="raid6", n_drives=4, hybrid=True, n_small=1, n_large=3,
                        group_size=8, small_chunk_blocks=1, large_chunk_blocks=2,
                        logical_blocks=256, gc_free_segments_low=1, device=device)
    pipe = HandlerPipeline.build_timed(
        cfg, ZnsConfig(n_zones=20, zone_cap_blocks=64, block_bytes=256), seed=7)
    pipe.precondition((lba, rng.integers(0, 256, (2, 256), dtype=np.uint8))
                      for lba in range(0, 256, 2))
    pipe.array.fail_drive(1)
    pipe.replay(synthetic(TenantSpec(name="mix", kind="uniform", n_ops=600,
                                     rate_iops=40_000, read_frac=0.5, n_blocks=2,
                                     seed=8), 256))
    return pipe


TIMED_SCENARIOS = {"exp10": scenario_exp10, "qos_rebuild": scenario_qos_rebuild,
                   "raid6_degraded": scenario_raid6_degraded}


def timed_outputs(pipe) -> dict:
    """Everything a timed run produces, but the sum of ``encode_sync_us``
    (the host wall time of the group encodes; its count stays): samples,
    percentiles, stage sums and counts, notes, stage counters, the virtual
    clock, events fired, the drives' bookings and images, L2P and Stats."""
    import numpy as np
    from repro_torch.core.zns import drive_images

    rec, arr = pipe.recorder, pipe.array
    tenants = sorted({s.tenant for s in rec.samples})
    return {
        "samples": [dataclasses.astuple(s) for s in rec.samples],
        "percentiles": {f"{t}/{op}": rec.percentiles(op=op, tenant=t)
                        for t in (None, *tenants) for op in (None, "R", "W")},
        "stage_sums": dict(rec.stage_sums), "stage_counts": dict(rec.stage_counts),
        "tenant_stage_sums": dict(rec.tenant_stage_sums),
        "tenant_stage_counts": dict(rec.tenant_stage_counts),
        "notes": {k: v for k, v in rec.notes.items() if k != "encode_sync_us"},
        "note_counts": dict(rec.note_counts), "counters": dict(pipe.counters),
        "now": pipe.engine.now, "events_fired": pipe.engine.events_fired,
        "io_watermark": pipe.engine.io_watermark,
        "bookings": [(d.t_zone_free, d.channels, d.za_slots, d.chunk_done, d.busy_us)
                     for d in arr.drives],
        "images": drive_images(arr.drives),
        "l2p": arr.l2p.get_many(np.arange(arr.cfg.logical_blocks)),
        "stats": dataclasses.asdict(arr.stats),
    }


def _same(a, b) -> bool:
    """Equality of nested containers of numbers and arrays; NaN == NaN."""
    import math

    import numpy as np

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def output_differences(a: dict, b: dict) -> list[str]:
    """The keys of two ``timed_outputs`` that differ."""
    return [k for k in a if not _same(a[k], b.get(k))] + [k for k in b if k not in a]


def timed_card_vs_cpu(seed: int, device: str = "cuda") -> dict:
    """Each of ``TIMED_SCENARIOS`` on ``device`` and on the CPU: every output
    but the host-clock sum must be equal."""
    out = {}
    for name, scenario in TIMED_SCENARIOS.items():
        a, b = scenario(device), scenario("cpu")
        oa, ob = timed_outputs(a), timed_outputs(b)
        bad = output_differences(oa, ob)
        if bad:
            raise AssertionError(f"timed {name}: {device} and cpu differ in {bad}")
        out[name] = {"result": "equal", "samples": len(oa["samples"]),
                     "events_fired": oa["events_fired"], "virtual_us": oa["now"],
                     "encode_groups": oa["note_counts"].get("encode_sync_us", 0)}
    return out


# ------------------------------------------------------ phase 7: serving

def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def model_config(arch: str, shrink=None, **overrides):
    """``arch``'s configuration at full width; ``shrink`` (e.g. ``smoke``,
    for a rehearsal on the CPU) cuts it, ``overrides`` replace fields."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cfg = shrink(cfg) if shrink else cfg
    return dataclasses.replace(cfg, **overrides)


def stub_inputs(cfg, rng, batch: int, device) -> dict:
    """What a family's prefill takes beside the tokens, from ``rng``: a
    VLM's patch embeddings (batch, vis_prefix_len, vis_embed_dim), an
    encoder-decoder's frame embeddings (batch, enc_len, d_model); N(0, 0.1)."""
    import numpy as np
    import torch

    if cfg.family == "vlm":
        name, shape = "vis_embeds", (batch, cfg.vis_prefix_len, cfg.vis_embed_dim)
    elif cfg.family == "encdec":
        name, shape = "frames", (batch, cfg.enc_len, cfg.d_model)
    else:
        return {}
    return {name: torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))
            .to(device)}


def model_setup(arch: str, seed: int, ph: Phase, device: str = "cuda", shrink=None,
                sizes: dict = SERVE, **overrides):
    """``arch`` on ``device``, random weights from ``seed``, warmed up
    (cuBLAS plans, the caching allocator) by one short serving run of
    ``sizes``' batch and prompt length -- for an encoder-decoder, which
    cannot be served from tokens, a prefill with stub frames and a decode
    step."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import grow_cache, serve
    from repro_torch.models.model import build_model

    cfg = model_config(arch, shrink, **overrides)
    t = time.perf_counter()
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    _sync(device)
    ph.info["init_s"] = time.perf_counter() - t
    rng = np.random.default_rng(seed + 1)
    warm = [rng.integers(0, cfg.vocab, (sizes["prompt"],)) for _ in range(sizes["batch"])]
    if cfg.family == "encdec":
        toks = torch.from_numpy(np.stack(warm)).to(device)
        _, cache = model.prefill(toks, **stub_inputs(cfg, rng, sizes["batch"], device))
        model.decode_step(grow_cache(cache, 1), toks[:, -1:])
    else:
        serve(model, warm, batch=sizes["batch"], gen_len=2)
    ph.info.update({"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
                    "dtype": cfg.dtype, "params": sum(w.numel() for w in model.parameters())})
    return model


def serve_phase(model, seed: int, ph: Phase, sizes: dict = SERVE):
    """Serve ``sizes`` through the port's serve loop; check the logits are
    finite and of the right shape and the tokens in range.  Returns the
    serving stats."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import greedy, serve

    vocab, dev = model.cfg.vocab, model.device
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, vocab, (sizes["prompt"],)) for _ in range(sizes["requests"])]
    finite = []

    def choose(logits):
        if logits.shape != (sizes["batch"], 1, vocab):
            raise AssertionError(f"logits of shape {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return greedy(logits)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = serve(model, queue, batch=sizes["batch"], gen_len=sizes["gen"], choose=choose)
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits while serving")
    outs = np.stack(st.outputs)
    if outs.shape != (sizes["requests"], sizes["gen"]) or outs.min() < 0 or outs.max() >= vocab:
        raise AssertionError(f"generated tokens of shape {outs.shape} out of range")
    ph.info.update({
        **sizes, "requests_served": st.requests, "prefill_calls": st.prefill_calls,
        "prefill_tokens": st.prefill_tokens, "decode_tokens": st.decode_tokens,
        "prefill_s": st.prefill_s, "decode_s": st.decode_s,
        "prefill_tok_s": st.prefill_tok_s, "decode_tok_s": st.decode_tok_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
    })
    return st


def serve_profile(model, seed: int, ph: Phase, sizes: dict = SERVE) -> None:
    """Device time by kernel (``torch.profiler``) over one prefill call and
    one decode step at the serving shape, against the wall time of each;
    the difference is the share of the call the card sat idle.  A model on
    the CPU (a rehearsal) records the wall times only."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import grow_cache
    from torch.profiler import ProfilerActivity, profile

    dev = model.device
    rng = np.random.default_rng(seed + 2)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (sizes["batch"], sizes["prompt"])))
    toks = toks.to(dev)
    _, cache = model.prefill(toks)
    grow_cache(cache, 2)  # room for the warm-up step and the profiled one
    nxt = toks[:, -1:]
    for name, call in (("prefill", lambda: model.prefill(toks)),
                       ("decode_step", lambda: model.decode_step(cache, nxt))):
        call()  # warm
        _sync(dev)
        if dev.type != "cuda":
            t0 = time.perf_counter()
            call()
            ph.info[name] = {"wall_ms": 1e3 * (time.perf_counter() - t0)}
            continue
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


def decode_matches_prefill(arch: str, seed: int, ph: Phase, device: str = "cuda",
                           shrink=None, sizes: dict = DECODE_CHECK) -> None:
    """In f32 at full width: prefill(t) then k decode steps against
    prefill(t + i) for each step i (an encoder-decoder with the same stub
    frames on both sides)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config(arch, shrink, dtype="float32")
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    b, t, k = sizes["batch"], sizes["t"], sizes["k"]
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, t + k))).to(device)
    kw = stub_inputs(cfg, rng, b, device)
    logits, cache = model.prefill(toks[:, :t], **kw)
    grow_cache(cache, k)
    errs = []
    for i in range(k):
        logits, cache = model.decode_step(cache, toks[:, t + i : t + i + 1])
        want, _ = model.prefill(toks[:, : t + i + 1], **kw)
        errs.append(float((logits - want).abs().max()))
        if not (torch.isfinite(logits).all()
                and torch.allclose(logits, want, atol=DECODE_TOL, rtol=DECODE_TOL)):
            raise AssertionError(f"{arch}: decode step {i} differs from prefill({t + i + 1}): "
                                 f"max abs err {errs[-1]}")
    ph.info.update({"arch": arch, "dtype": cfg.dtype, "batch": b, "t": t, "k": k,
                    "tol": DECODE_TOL, "max_abs_err": errs,
                    "logit_abs_max": float(want.abs().max())})


SSD_KERNELS = ("ssd_scan", "ssd_chunk_gram")


def serving_path(tag: str, arch: str, seed: int) -> dict:
    """Phases ``<tag>_setup``, ``<tag>_serve``, ``<tag>_profile`` and
    ``<tag>_decode_check`` of ``arch`` at full width on the card.  The
    launch counts are zeroed just before the serving run and read just
    after it: a Mamba-2 family must have launched each SSD kernel once per
    layer and prefill call, every other family none; returns them."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts

    with Phase(f"{tag}_setup") as ph:
        model = model_setup(arch, seed, ph)
    reset_launch_counts()  # this serving path's launches start here
    with Phase(f"{tag}_serve") as ph:
        st = serve_phase(model, seed, ph)
    counts = launch_counts()  # read just after it
    ssm = model.cfg.family in ("ssm", "hybrid")
    want = model.cfg.n_layers * st.prefill_calls if ssm else 0
    for name, n in counts.items():
        if n != (want if name in SSD_KERNELS else 0) or (ssm and want == 0):
            raise AssertionError(f"{arch}: {name} launched {n} times while serving, want "
                                 f"{want if name in SSD_KERNELS else 0}: {counts}")
    with Phase(f"{tag}_profile") as ph:
        serve_profile(model, seed, ph)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with Phase(f"{tag}_decode_check") as ph:
        decode_matches_prefill(arch, seed, ph)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def moe_serve(seed: int, ph: Phase, device: str = "cuda", shrink=None,
              sizes: dict = MOE_SERVE) -> None:
    """llama4-scout at full width, its first ``layers`` layers: one batch of
    ``sizes`` served, finite logits; the share of routed slots the capacity
    dropped, over the prefill calls and over the decode steps (counted by
    wrapping ``layers.moe_dispatch``, on the device, read once at the end)."""
    import torch
    from repro_torch.models import layers as L

    model = model_setup(sizes["arch"], seed, ph, device, shrink, sizes=sizes,
                        n_layers=sizes["layers"])
    ph.info["reduced"] = f"{sizes['layers']} of {model_config(sizes['arch'], shrink).n_layers} layers"
    kept = {"prefill": [], "decode": []}
    real = L.moe_dispatch

    def counted(router, x, cfg):
        dsp = real(router, x, cfg)
        kept["prefill" if x.shape[1] > 1 else "decode"].append((dsp.keep.numel(), dsp.keep.sum()))
        return dsp

    L.moe_dispatch = counted
    try:
        serve_phase(model, seed, ph, sizes)
    finally:
        L.moe_dispatch = real
    for what, calls in kept.items():
        routed = sum(n for n, _ in calls)
        n_kept = int(torch.stack([k for _, k in calls]).sum()) if calls else 0
        ph.info[f"{what}_routed_slots"] = routed
        ph.info[f"{what}_dropped_share"] = 1 - n_kept / routed if routed else None
    ph.info["capacity_factor"] = model.cfg.capacity_factor


def vlm_phase(seed: int, ph: Phase, device: str = "cuda", shrink=None,
              sizes: dict = VLM) -> None:
    """paligemma-3b at full width: one prefill of ``sizes``' batch with the
    stub vision prefix, then ``decode_steps`` greedy steps, finite logits;
    then served as the reference serves it, without a prefix."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import greedy, grow_cache

    model = model_setup(sizes["arch"], seed, ph, device, shrink, sizes=sizes)
    cfg = model.cfg
    rng = np.random.default_rng(seed + 3)
    b, steps = sizes["batch"], sizes["decode_steps"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, sizes["prompt"]))).to(device)
    kw = stub_inputs(cfg, rng, b, device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks, **kw)
    _sync(device)
    t1 = time.perf_counter()
    grow_cache(cache, steps)
    finite = [torch.isfinite(logits).all()]
    for _ in range(steps):
        logits, cache = model.decode_step(cache, greedy(logits))
        finite.append(torch.isfinite(logits).all())
    _sync(device)
    t2 = time.perf_counter()
    if not bool(torch.stack(finite).all()) or logits.shape != (b, 1, cfg.vocab):
        raise AssertionError("paligemma with a vision prefix: non-finite or misshapen logits")
    if cache["len"] != cfg.vis_prefix_len + sizes["prompt"] + steps:
        raise AssertionError(f"cache len {cache['len']} does not count the prefix")
    del cache
    ph.info["with_prefix"] = {
        "vis_embeds": list(kw["vis_embeds"].shape), "prefill_s": t1 - t0,
        "prefill_tok_s": b * (cfg.vis_prefix_len + sizes["prompt"]) / (t1 - t0),
        "decode_steps": steps, "decode_tok_s": b * steps / (t2 - t1)}
    serve_phase(model, seed, ph, sizes)


def encdec_phase(seed: int, ph: Phase, device: str = "cuda", shrink=None,
                 sizes: dict = ENCDEC) -> None:
    """whisper-small at full width: prefill ``sizes``' batch of prompts with
    stub frames (batch, enc_len, d_model), then ``gen - 1`` greedy decode
    steps; finite logits, tokens/s, peak memory."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import greedy, grow_cache

    model = model_setup(sizes["arch"], seed, ph, device, shrink, sizes=sizes)
    cfg = model.cfg
    rng = np.random.default_rng(seed + 4)
    b = sizes["batch"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, sizes["prompt"]))).to(device)
    kw = stub_inputs(cfg, rng, b, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(toks, **kw)
    _sync(device)
    t1 = time.perf_counter()
    grow_cache(cache, sizes["gen"])
    finite = [torch.isfinite(logits).all()]
    for _ in range(sizes["gen"] - 1):
        logits, cache = model.decode_step(cache, greedy(logits))
        finite.append(torch.isfinite(logits).all())
    _sync(device)
    t2 = time.perf_counter()
    if not bool(torch.stack(finite).all()) or logits.shape != (b, 1, cfg.vocab):
        raise AssertionError("whisper: non-finite or misshapen logits")
    ph.info.update({
        **sizes, "frames": list(kw["frames"].shape), "prefill_s": t1 - t0,
        "prefill_tok_s": b * sizes["prompt"] / (t1 - t0), "decode_steps": sizes["gen"] - 1,
        "decode_tok_s": b * (sizes["gen"] - 1) / (t2 - t1),
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else None})


# ------------------------------- phases 8-10: block service, checkpoints, state parity

def storage_sim_runs(n_ops: dict | None = None) -> dict:
    """The block service's scenarios at the reference's sizes (its
    ``benchmarks/run.py --quick`` ``bench_service`` and ``bench_cache``
    rows), each a function of the codec's device."""
    from repro_torch.service.scenario import (
        checkpoint_under_serving, degraded_read_cache, read_qd_sweep,
    )

    n = {**STORAGE_SIM, **(n_ops or {})}
    return {
        "ckpt_vs_serve_qos": lambda dev: checkpoint_under_serving(policy="qos", device=dev),
        "ckpt_vs_serve_fifo": lambda dev: checkpoint_under_serving(policy="fifo", device=dev),
        "qd_sweep": lambda dev: read_qd_sweep(qds=n["qds"], n_ops=n["qd_ops"], device=dev),
        "degraded_cold": lambda dev: degraded_read_cache(warm=False, n_ops=n["cache_ops"],
                                                         device=dev),
        "degraded_warm": lambda dev: degraded_read_cache(warm=True, n_ops=n["cache_ops"],
                                                         device=dev),
    }


def storage_sim(ph: Phase, device: str = "cuda", n_ops: dict | None = None) -> None:
    """Each of ``storage_sim_runs`` on ``device`` and on the CPU: every
    output must be equal (percentiles, summaries, save latencies) and each
    checkpoint restore bit-identical.  Records the virtual serving p99s, the
    host seconds of each run and the kernels each run on ``device``
    launched."""
    from repro_torch.kernels import launch_counts

    for name, run in storage_sim_runs(n_ops).items():
        before = launch_counts()
        t = time.perf_counter()
        got = run(device)
        host_dev = time.perf_counter() - t
        after = launch_counts()
        t = time.perf_counter()
        want = run("cpu")
        host_cpu = time.perf_counter() - t
        if not _same(got, want):
            raise AssertionError(f"storage_sim {name}: {device} and cpu differ")
        info = {"result": "equal", "host_s": {device: host_dev, "cpu": host_cpu},
                "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}}
        if name.startswith("ckpt_vs_serve"):
            if got["restore_ok"] is not True:
                raise AssertionError(f"storage_sim {name}: restore not bit-identical")
            info.update({k: got[k] for k in ("serve_p50_us", "serve_p99_us", "serve_n",
                                             "ckpt_save_mean_us", "ckpt_save_max_us",
                                             "restore_ok")})
        elif name == "qd_sweep":
            info["rows"] = got
        else:
            info.update({k: got[k] for k in ("p50_us", "p99_us", "n", "hit_rate",
                                             "cache_bypasses")})
        ph.info[name] = info


def _bits_equal(a, b) -> bool:
    """Two tensors of one dtype and shape with equal bytes."""
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def _tree_bits_equal(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        got[k].device == want[k].device and _bits_equal(got[k], want[k]) for k in want)


def mamba2_weights(seed: int, device: str = "cuda", cfg=None):
    """``mamba2-1.3b``'s parameters, built by the port's ``build_model`` on
    ``device`` from ``seed``: {name: tensor} (the layer leaves stacked over
    layers, ``layers.block.w_z`` of (48, 2048, 4096) and so on)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = cfg or get_config("mamba2-1.3b")
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    return {name: p.detach() for name, p in model.named_parameters()}


def ckpt_round_trip(weights: dict, scheme: str, layers: int, fail: tuple[int, ...],
                    device: str, geom: dict) -> dict:
    """A ``CheckpointEngine`` on ``device`` saves the first ``layers``
    layers of ``weights`` (``[:layers]`` of each stacked leaf), restores
    them, fails the lanes ``fail``, restores degraded, crashes and remounts,
    and restores again; every restore must equal the saved leaves bit for
    bit.  Returns the sizes and host times."""
    import torch
    from repro_torch.checkpoint.zapraid_ckpt import CheckpointConfig, CheckpointEngine

    state = {k: w[:layers] for k, w in weights.items() if k.startswith("layers.")}
    nbytes = sum(w.numel() * w.element_size() for w in state.values())
    n_lanes = {"raid5": 4, "raid6": 5}[scheme]
    cfg = CheckpointConfig(n_lanes=n_lanes, scheme=scheme, block_bytes=BLOCK_BYTES,
                           zone_cap_blocks=geom["zone_cap_blocks"], n_zones=geom["zones"],
                           device=device)
    eng = CheckpointEngine(cfg, logical_blocks=geom["logical_blocks"])
    out = {"scheme": scheme, "lanes": n_lanes, "layers": layers, "leaves": len(state),
           "bytes": nbytes, "dtypes": sorted({str(w.dtype) for w in state.values()}),
           "failed_lanes": list(fail)}

    def timed(what, fn):
        if device == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        out[f"{what}_s"] = time.perf_counter() - t
        return res

    def restore(what, engine):
        got = timed(what, lambda: engine.restore(1, state))
        if not _tree_bits_equal(got, state):
            raise AssertionError(f"ckpt {scheme}: {what} differs from the saved state")
        out[f"{what}_mib_s"] = nbytes / 2**20 / out[f"{what}_s"]

    timed("save", lambda: eng.save(1, state))
    out["save_mib_s"] = nbytes / 2**20 / out["save_s"]
    out["save_stats"] = eng.stats()
    restore("restore", eng)
    for lane in fail:
        eng.fail_lane(lane)
    restore("degraded_restore", eng)
    out["degraded_reads"] = eng.array.stats.degraded_reads
    eng = timed("remount", eng.crash_and_remount)
    restore("remount_restore", eng)
    out.update({"remount_degraded_reads": eng.array.stats.degraded_reads,
                "restores": "bit-exact"})
    return out


def ckpt_phase(weights: dict, ph: Phase, device: str = "cuda", geom: dict | None = None,
               layers: tuple[int, int] = (CKPT["raid5_layers"], CKPT["raid6_layers"])) -> None:
    """``ckpt_round_trip`` on RAID-5 (3+1, lane 1 failed) and RAID-6 (3+2,
    lanes 1 and 3 failed)."""
    geom = geom or CKPT["geom"]
    ph.info["raid5"] = ckpt_round_trip(weights, "raid5", layers[0], (1,), device, geom)
    ph.info["raid6"] = ckpt_round_trip(weights, "raid6", layers[1], (1, 3), device, geom)


def zero1_shards(state: dict, k: int) -> list[dict]:
    """ZeRO-1 style rank shards of ``state`` ({name: tensor}): each leaf
    flattened, padded to a multiple of k elements, cut in k equal views."""
    import torch.nn.functional as F

    shards = [{} for _ in range(k)]
    for name, leaf in state.items():
        flat = leaf.reshape(-1)
        pad = (-flat.numel()) % k
        if pad:
            flat = F.pad(flat, (0, pad))
        for r, part in enumerate(flat.view(k, -1).unbind(0)):
            shards[r][name] = part
    return shards


def optimizer_state(shapes: dict, seed: int, device: str) -> dict:
    """AdamW's first and second moments, f32, for parameters of ``shapes``
    ({name: shape}), drawn on ``device`` from ``seed``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "m": {k: torch.randn(s, generator=g, device=device) for k, s in shapes.items()},
        "v": {k: torch.rand(s, generator=g, device=device) for k, s in shapes.items()},
    }


def _wall_ms(fn, cuda: bool):
    """(fn(), its wall time in ms): CUDA events on the card, else the host
    clock."""
    import torch

    if not cuda:
        t = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _parity_matches_plain(parity: list, ranks: list, names: set, largest: str, m: int) -> None:
    """The ``names`` leaves of ``parity`` equal the CPU's plain path on the
    same shards (of the largest leaf, its first ``PARITY["plain_bytes"]``)."""
    import torch
    from repro_torch.checkpoint.state_parity import encode_shards

    head = PARITY["plain_bytes"] // 4
    cpu = [{s: {n: (r[s][n][:head] if n == largest else r[s][n]).cpu() for n in names}
            for s in r} for r in ranks]
    for got, want in zip(parity, encode_shards(cpu, m=m)):
        for s, leaves in want.items():
            for n, w in leaves.items():
                if not torch.equal(got[s][n][: w.numel()].cpu(), w):
                    raise AssertionError(f"state_parity m={m}: {s}/{n} differs from the "
                                         "plain path")


def state_parity_phase(shapes: dict, seed: int, ph: Phase, device: str = "cuda") -> list:
    """``encode_shards`` (m = 1 and 2) over the ZeRO-1 shards of AdamW's
    state for parameters of ``shapes`` across ``PARITY["k"]`` ranks, then
    ``reconstruct_shard`` of a lost rank, on ``device``: with m = 2 also
    with both parity rows standing in for two lost ranks.  Every rebuilt
    leaf must equal the lost one bit for bit; the smallest leaves and the
    first MiB of the largest are held to the CPU's plain path.  Each encode
    runs twice, the first result dropped: its wall time includes the caching
    allocator's first reservations, the second's does not.  Returns the k
    rank shards of the largest leaf of m (for ``state_parity_kernels``)."""
    import torch
    from repro_torch.checkpoint.state_parity import encode_shards, reconstruct_shard

    k, lost = PARITY["k"], PARITY["lost"]
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        ph.info["mem_at_start_bytes"] = torch.cuda.memory_allocated()
    opt = optimizer_state(shapes, seed, device)
    ranks = [{"m": a, "v": b} for a, b in zip(zero1_shards(opt["m"], k),
                                               zero1_shards(opt["v"], k))]
    shard_bytes = {n: t.numel() * 4 for n, t in ranks[0]["m"].items()}
    largest = max(shard_bytes, key=shard_bytes.get)
    names = {*sorted(shard_bytes, key=shard_bytes.get)[: PARITY["plain_leaves"]], largest}
    ph.info.update({"k": k, "lost_rank": lost, "params": sum(t.numel() for t in opt["m"].values()),
                    "state_bytes": 2 * 4 * sum(t.numel() for t in opt["m"].values()),
                    "leaves_per_rank": 2 * len(shard_bytes), "largest_leaf": largest,
                    "largest_shard_bytes": shard_bytes[largest]})
    del opt

    def rebuilt(survivors, parity, what):
        rec, ms = _wall_ms(lambda: reconstruct_shard(lost, survivors, parity, k), cuda)
        if not all(_tree_bits_equal(rec[s], ranks[lost][s]) for s in ("m", "v")):
            raise AssertionError(f"state_parity: rank {lost} rebuilt wrong from {what}")
        return ms

    for m in (1, 2):
        first_ms = _wall_ms(lambda: encode_shards(ranks, m=m), cuda)[1]
        parity, ms = _wall_ms(lambda: encode_shards(ranks, m=m), cuda)
        info = {"encode_wall_ms": ms, "first_encode_wall_ms": first_ms,
                "parity_bytes": sum(p.numel() for tree in parity
                                    for leaves in tree.values() for p in leaves.values()),
                "reconstruct_wall_ms": rebuilt({r: ranks[r] for r in range(k) if r != lost},
                                               parity, f"{k - 1} ranks and parity row 0")}
        if m == 2:  # two ranks lost: both parity rows stand in
            info["two_lost_wall_ms"] = rebuilt(
                {r: ranks[r] for r in range(k) if r not in (1, lost)}, parity,
                f"{k - 2} ranks and both parity rows")
        _parity_matches_plain(parity, ranks, names, largest, m)
        info.update({"rebuilt": "bit-exact", "plain_checked": {
            "leaves": 2 * (len(names) - 1),
            "largest_head_bytes": min(PARITY["plain_bytes"], shard_bytes[largest])}})
        ph.info[f"m{m}"] = info
        del parity
    if cuda:
        ph.info["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return [r["m"][largest] for r in ranks]


def state_parity_kernels(lanes: list, int32_ops_per_s: float,
                         stripe_alu: dict[str, int]) -> list[dict]:
    """The single-stripe kernels at the largest state-parity leaf: the k
    rank shards of it stacked as (k, n) int32 on the card, ``stripe_xor``
    (m = 1 encode), ``stripe_gf256`` (2, k) (m = 2 encode) and (k, k) (a
    decode with parity row 0 standing in for the lost rank), each against
    its plain version on the same input and timed beside its bound: bytes
    (k rows read once, m rows written once) over the memory rate, or the ALU
    instructions of its compiled instance (``stripe_alu_ops``) over the
    INT32 rate.

    ``ms`` is the median of CUDA-event pairs around single launches queued
    back to back (a launch takes ~1 ms here, its host cost a few µs, so the
    stream never idles between them).  ``torch.profiler``'s per-kernel mean
    is printed beside it with the number of kernel events it kept: it has
    dropped events on this card, which lowers a mean taken over the calls
    (``_time_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops, ref

    def launch_ms(fn, args, iters=20):
        fn(*args)
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for start, end in pairs:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize()
        times = sorted(start.elapsed_time(end) for start, end in pairs)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.self_device_time_total > 0 and "stripe" in e.key]
        kept = sum(e.count for e in kern)
        prof_ms = sum(e.self_device_time_total for e in kern) / 1e3 / kept if kept else None
        return times[iters // 2], {"ms_per_kernel": prof_ms, "kernels": kept, "launched": iters}

    k = len(lanes)
    data = torch.stack([t.view(torch.int32) for t in lanes])
    n = data.shape[1]
    roles = tuple(r for r in range(k) if r != PARITY["lost"]) + (k,)
    cases = [
        ("parity_xor", "stripe_xor", 1, ops.xor_parity, (data,), ref.parity_xor_ref, (data,)),
        ("gf256_matmul", "stripe_gf256 encode", 2, lambda d: ops.rs_encode(d, 2), (data,),
         ref.gf256_matmul_ref, (ops.rs_parity_coeff(k, 2, "cuda"), data)),
        ("gf256_matmul", "stripe_gf256 decode", k, lambda d: ops.rs_decode(d, roles, k, 2),
         (data,), ref.gf256_matmul_ref, (ops.rs_decode_coeff(k, 2, roles, "cuda"), data)),
    ]
    rows = []
    for name, label, m, fn, args, plain, plain_args in cases:
        got, want = fn(*args), plain(*plain_args)
        if not torch.equal(got.view(m, n), want.view(m, n)):
            raise AssertionError(f"{label} at the largest state-parity leaf differs "
                                 "from its plain version")
        del got, want
        ms, profiler = launch_ms(fn, args)
        _, call_ms = _time_ms(fn, [args], 20)
        plain_ms, _ = _time_ms(plain, [plain_args], 2)
        byte_ms = 1e3 * 4 * (k + m) * n / HBM_BYTES_PER_S
        instance = f"stripe_xor<k={k}>" if m == 1 else f"stripe_gf256<k={k},m={m}>"
        op_ms = 1e3 * stripe_alu[instance] * -(-n // 4) / int32_ops_per_s
        rows.append({"name": name, "kernel": label, "instance": instance,
                     "alu_per_thread": stripe_alu[instance], "shape": [[m, k], [k, n]],
                     "ms": ms, "call_ms": call_ms, "profiler": profiler, "plain_ms": plain_ms,
                     "bound_ms": max(byte_ms, op_ms),
                     "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                     "bytes_us": 1e3 * byte_ms, "ops_us": 1e3 * op_ms,
                     "library_ms": None, "max_abs_err": 0})
    return rows


# ------------------------------------------------------ phases 11-13: training

def _train_argv(spec: dict) -> list[str]:
    return ["--arch", spec["arch"], "--no-smoke", "--steps", str(spec["steps"]),
            "--global-batch", str(spec["global_batch"]), "--seq-len", str(spec["seq_len"]),
            "--ckpt-every", str(spec["ckpt_every"])]


def mamba2_train(ph: Phase, device: str = "cuda", spec: dict = TRAIN, argv=None) -> dict:
    """mamba2-1.3b at full width trained through ``launch.train.run``: step
    wall time, trained tokens/s, peak device memory, finite losses and
    gradient norms, the SSD kernels' launches per step (zeroed just before
    the run, read just after: under remat each layer's forward scan runs
    twice, once in the backward's recompute).  Returns the launch counts
    since they were last zeroed, which the caller does just before."""
    import math
    import statistics

    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import train

    argv = argv or _train_argv(spec)
    rep = {}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = train.run(argv + ["--device", device], report=rep)
    counts = launch_counts()  # read just after it (zeroed by the caller just before)
    steps = spec["steps"]
    if len(losses) != steps or not all(map(math.isfinite, losses + rep["grad_norm"])):
        raise AssertionError(f"training: losses {losses}, grad norms {rep['grad_norm']}")
    from repro_torch.configs import get_config

    cfg = get_config(spec["arch"])
    fwd = (2 if cfg.remat else 1) * cfg.n_layers * steps
    want = {"ssd_scan": fwd, "ssd_chunk_gram": fwd, "ssd_scan_bwd": cfg.n_layers * steps}
    for name, n in counts.items():
        if device == "cuda" and n != want.get(name, 0):
            raise AssertionError(f"training launched {name} {n} times, want "
                                 f"{want.get(name, 0)}: {counts}")
    steady = rep["step_s"][1:]
    step_s = statistics.median(steady)
    ph.info.update({
        "arch": cfg.name, "params": rep["params"], "dtype": cfg.dtype, "remat": cfg.remat,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "steps": steps,
        "tokens_per_step": rep["tokens_per_step"], "losses": losses,
        "grad_norms": rep["grad_norm"], "step_ms": [1e3 * s for s in rep["step_s"]],
        "steady_step_ms": 1e3 * step_s, "trained_tok_s": rep["tokens_per_step"] / step_s,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else None,
        "launches_per_step": {k: v / steps for k, v in counts.items() if v},
        "leaf_norms": rep.get("leaf_norms"),
    })
    return counts


def sharded_train(ph: Phase, want: dict, device: str = "cuda", spec: dict = TRAIN,
                  shrink=None) -> tuple[dict, dict]:
    """``mamba2_train``'s run on a device mesh: the same model (seed 0),
    AdamW and batches, the parameters, AdamW state and each batch distributed
    as DTensors by ``param_specs``, ``state_specs`` and ``batch_specs`` on
    ``make_host_mesh()`` (on one card the (1, 1) mesh of an NCCL group of
    one), the port's train step under ``use_mesh``.  Its losses and the
    final parameters' per-leaf norms must equal ``want``'s (``mamba2_train``'s
    report) within ``RESTART_TOL``; whether they are bit-equal is printed.
    Returns the kernel launches since they were last zeroed, which the
    caller does just before, and the trained state on its mesh ({``mesh``,
    ``params``, ``opt``}) for ``sharded_ckpt``; the caller tears the process
    group down after (``end_mesh``), or this does if it fails."""
    import math
    import statistics

    import numpy as np
    import torch
    from repro_torch.checkpoint import _tree
    from repro_torch.data.pipeline import DataConfig, batch_for_step, batch_specs
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import leaf_norms
    from repro_torch.optim import adamw
    from repro_torch.train import steps as steps_mod

    cfg = model_config(spec["arch"], shrink)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(device_type=device)
    try:
        opt_cfg = adamw.AdamWConfig(warmup_steps=10)  # launch/train.py's
        model, step = steps_mod.make_train_step(cfg, opt_cfg, device=device)
        params = steps_mod.params_of(model)
        pspecs = sh.param_specs(params, model.axes(), mesh, fsdp=cfg.fsdp)
        opt = steps_mod.init_opt_state(model, params, opt_cfg)
        dparams = sh.distribute(params, mesh, pspecs)
        dopt = sh.distribute(opt, mesh, adamw.state_specs(pspecs, params, mesh))
        del params, opt
        dc = DataConfig(spec["global_batch"], spec["seq_len"], cfg.vocab)
        bspecs = batch_specs(dc, cfg, mesh)
        losses, step_s, gnorms = [], [], []
        with sh.use_mesh(mesh):
            for i in range(spec["steps"]):
                batch = sh.distribute(batch_for_step(dc, cfg, i, device=device), mesh, bspecs)
                t0 = time.perf_counter()
                dparams, dopt, m = step(dparams, dopt, batch)
                losses.append(float(m["loss"].full_tensor()))
                step_s.append(time.perf_counter() - t0)
                gnorms.append(float(m["grad_norm"].full_tensor()))
        counts = launch_counts()  # read just after the run
        norms = leaf_norms(dparams)
        placements = sorted({str(tuple(p.placements)) for p in _tree.leaves(dparams)})
    except BaseException:
        end_mesh()
        raise
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"sharded training: losses {losses}, grad norms {gnorms}")
    if not np.allclose(losses, want["losses"], **RESTART_TOL):
        raise AssertionError(f"sharded losses {losses} differ from the unsharded run's "
                             f"{want['losses']}")
    names = sorted(want["leaf_norms"])
    if sorted(norms) != names or not np.allclose([norms[k] for k in names],
                                                 [want["leaf_norms"][k] for k in names],
                                                 **RESTART_TOL):
        raise AssertionError("the sharded run's final parameters differ from the unsharded "
                             "run's (per-leaf norms)")
    fwd = (2 if cfg.remat else 1) * cfg.n_layers * spec["steps"]
    expect = {"ssd_scan": fwd, "ssd_chunk_gram": fwd, "ssd_scan_bwd": cfg.n_layers * spec["steps"]}
    for name, n in counts.items():
        if cuda and n != expect.get(name, 0):
            raise AssertionError(f"sharded training launched {name} {n} times, want "
                                 f"{expect.get(name, 0)}: {counts}")
    steady = statistics.median(step_s[1:] or step_s)
    tokens = spec["global_batch"] * spec["seq_len"]
    ph.info.update({
        "arch": cfg.name, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "placements": placements, "steps": spec["steps"], "losses": losses,
        "losses_bit_equal": losses == list(want["losses"]),
        "leaf_norms_bit_equal": all(norms[k] == want["leaf_norms"][k] for k in names),
        "step_ms": [1e3 * s for s in step_s], "steady_step_ms": 1e3 * steady,
        "trained_tok_s": tokens / steady,
        "unsharded_steady_step_ms": want.get("steady_step_ms"),
        "unsharded_tok_s": want.get("trained_tok_s"),
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "unsharded_peak_mem_bytes": want.get("peak_mem_bytes"),
        "launches_per_step": {k: v / spec["steps"] for k, v in counts.items() if v},
    })
    return counts, {"mesh": mesh, "params": dparams, "opt": dopt}


def end_mesh() -> None:
    """Tear down the process group of ``sharded_train``'s mesh."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def layer_slice(tree: dict, n: int) -> dict:
    """The ``layers`` subtree of a parameter-shaped tree, each leaf (stacked
    over the layers) cut to its first ``n`` layers: DTensors stay DTensors."""
    def cut(node):
        return {k: cut(v) for k, v in node.items()} if isinstance(node, dict) else node[:n]

    return {"layers": cut(tree["layers"])}


def sharded_ckpt(ph: Phase, trained: dict, shapes: dict, plain: dict, device: str = "cuda",
                 spec: dict = SHARDED_CKPT, seed: int = SEED) -> dict:
    """The checkpoint engine and the state parity on ``sharded_train``'s
    trained DTensors, on its mesh.

    ``ckpt``: the first ``spec["layers"]`` layers of the parameters and of
    AdamW's master, m and v, and AdamW's step, as the DTensors stand,
    saved at step ``spec["step"]`` on ``launch/train.py``'s engine (RAID-5,
    4 lanes, zones of ``spec["geom"]``), lane ``spec["fail"]`` failed, and
    restored degraded into the same DTensors: every restored leaf must be a
    DTensor with the saved leaf's mesh and placements and a global value
    equal bit for bit; save and restore MiB/s on the host clock.

    ``state_parity``: the ``state_parity`` phase's ZeRO-1 rank shards of
    AdamW's m and v for parameters of ``shapes`` (from ``seed``), each
    placed as a DTensor on the mesh -- a rank's 1-d cut of a leaf split over
    the mesh dims the trained m leaf is split over (``adamw.state_specs``'s
    placements), replicated over the others.  ``encode_shards`` with m = 1
    and 2 (each run twice, the first dropped, as there) must give parity
    rows equal to those of the same plain tensors, and rank
    ``PARITY["lost"]``'s rebuild must be DTensors placed as its shards with
    their global values bit-exact; CUDA-event wall ms beside the plain
    phase's (``plain``, that phase's info).  Returns the kernel launches of
    the calls on DTensors alone (the save, the restore, the encodes and the
    rebuilds); the checks against plain tensors run outside that count."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.checkpoint import _tree
    from repro_torch.checkpoint.state_parity import encode_shards, reconstruct_shard
    from repro_torch.checkpoint.zapraid_ckpt import CheckpointConfig, CheckpointEngine
    from repro_torch.kernels import launch_counts
    from repro_torch.models import convert

    cuda = device == "cuda"
    mesh, dparams, dopt = trained["mesh"], trained["params"], trained["opt"]
    launched = dict.fromkeys(launch_counts(), 0)

    def counted(fn):
        """``fn()``, its kernel launches added to ``launched``."""
        before = launch_counts()
        out = fn()
        for k, v in launch_counts().items():
            launched[k] += v - before[k]
        return out

    def same_dtensors(got, want, what):
        for (name, w), g in zip(_tree.flatten_with_path(want)[0], _tree.leaves(got)):
            if not (isinstance(g, DTensor) and g.device_mesh == w.device_mesh
                    and g.placements == w.placements
                    and _bits_equal(g.full_tensor(), w.full_tensor())):
                raise AssertionError(f"sharded_ckpt: {what}: {name} differs from the saved "
                                     "DTensor")

    n = spec["layers"]
    state = {"params": layer_slice(dparams, n),
             "opt": {"step": dopt["step"], **{k: layer_slice(dopt[k], n)
                                             for k in ("master", "m", "v")}}}
    leaves = _tree.leaves(state)
    nbytes = sum(_tree.leaf_meta(leaf)[2] for leaf in leaves)
    geom = spec["geom"]
    eng = CheckpointEngine(CheckpointConfig(n_lanes=4, scheme="raid5", group_size=8,
                                            block_bytes=BLOCK_BYTES,
                                            zone_cap_blocks=geom["zone_cap_blocks"],
                                            n_zones=geom["zones"], device=device),
                           logical_blocks=geom["logical_blocks"])
    _sync(device)
    t = time.perf_counter()
    counted(lambda: eng.save(spec["step"], state))
    _sync(device)
    save_s = time.perf_counter() - t
    save_stats = eng.stats()
    eng.fail_lane(spec["fail"])
    t = time.perf_counter()
    got = counted(lambda: eng.restore(spec["step"], state))
    _sync(device)
    restore_s = time.perf_counter() - t
    same_dtensors(got, state, f"restore with lane {spec['fail']} failed")
    del got
    ph.info["ckpt"] = {
        "layers": n, "leaves": len(leaves), "bytes": nbytes, "step": spec["step"],
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "placements": sorted({str(tuple(leaf.placements)) for leaf in leaves}),
        "save_s": save_s, "save_mib_s": nbytes / 2**20 / save_s,
        "failed_lane": spec["fail"], "degraded_restore_s": restore_s,
        "degraded_restore_mib_s": nbytes / 2**20 / restore_s,
        "degraded_reads": eng.array.stats.degraded_reads, "save_stats": save_stats,
        "stats": eng.stats(), "restored": "DTensors, placements kept, bit-exact"}
    del eng, state, leaves

    k, lost = PARITY["k"], PARITY["lost"]
    split = {path.replace("/", "."):  # by the names of ``shapes``
             [Shard(0) if isinstance(p, Shard) else Replicate() for p in leaf.placements]
             for path, leaf in convert._flatten(dopt["m"]).items()}
    opt = optimizer_state(shapes, seed, device)
    plain_ranks = [{"m": a, "v": b} for a, b in zip(zero1_shards(opt["m"], k),
                                                     zero1_shards(opt["v"], k))]
    del opt
    ranks = [{s: {name: distribute_tensor(t, mesh, split[name], src_data_rank=None)
                  for name, t in tree.items()} for s, tree in r.items()} for r in plain_ranks]
    info = {"k": k, "lost_rank": lost,
            "placements": sorted({str(tuple(p)) for p in split.values()}),
            "leaves_per_rank": sum(len(tree) for tree in ranks[0].values())}
    for m in (1, 2):
        first_ms = _wall_ms(lambda: counted(lambda: encode_shards(ranks, m=m)), cuda)[1]
        parity, ms = _wall_ms(lambda: counted(lambda: encode_shards(ranks, m=m)), cuda)
        for s, tree in plain_ranks[0].items():  # leaf by leaf: one leaf's rows at a time
            for name in tree:
                want = encode_shards([{name: r[s][name]} for r in plain_ranks], m=m)
                for j, row in enumerate(want):
                    g = parity[j][s][name]
                    if isinstance(g, DTensor) or not torch.equal(g, row[name]):
                        raise AssertionError(f"sharded state parity m={m}: row {j} {s}/{name} "
                                             "differs from the plain tensors' row")
                del want
        rec, rebuild_ms = _wall_ms(lambda: counted(lambda: reconstruct_shard(
            lost, {r: ranks[r] for r in range(k) if r != lost}, parity, k)), cuda)
        for s in ("m", "v"):
            same_dtensors(rec[s], ranks[lost][s], f"rank {lost} rebuilt with m={m}")
        del rec, parity
        info[f"m{m}"] = {"encode_wall_ms": ms, "first_encode_wall_ms": first_ms,
                         "reconstruct_wall_ms": rebuild_ms,
                         "plain_encode_wall_ms": plain[f"m{m}"]["encode_wall_ms"],
                         "plain_reconstruct_wall_ms": plain[f"m{m}"]["reconstruct_wall_ms"],
                         "parity": "equal to the plain tensors'", "rebuilt": "bit-exact"}
    if cuda:
        info["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    ph.info["state_parity"] = info
    return launched


def dryrun_phase(ph: Phase, out: Path, device: str = "cuda", workers: int | None = None,
                 multi: tuple = DRYRUN["multi"], archs=None, shapes=None) -> list[dict]:
    """Every architecture in configs/ at full width through the port's dry
    run (``launch/dryrun.py``'s ``run_cell``) on the 256-way production mesh,
    and the ``multi`` archs on the 512-way one, the cells spread over worker
    processes (each a fake process group of its own).  Prints one line per
    cell; fails unless every cell ``cell_supported`` allows reads "ok" and
    every other "skip"."""
    import os

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES, cell_supported

    archs = archs or ARCHS
    shapes = shapes or list(SHAPES)
    tasks = [(a, s, False) for a in archs for s in shapes]
    tasks += [(a, s, True) for a in multi for s in shapes]
    # the costliest first: deep models, long sequences, training
    cost = {"train_4k": 3, "prefill_32k": 4, "decode_32k": 1, "long_500k": 1}
    tasks.sort(key=lambda t: -get_config(t[0]).n_layers * cost[t[1]])
    workers = workers or min(DRYRUN["workers"], os.cpu_count() or 1)
    results = dryrun.run_cells(tasks, out, workers=workers, force=True, device=device)
    bad = []
    for r in results:
        ok, _ = cell_supported(get_config(r["arch"]), r["shape"])
        roof = r.get("roofline", {})
        _emit({"dryrun_cell": f"{r['arch']} {r['shape']} {r['mesh']}", "status": r["status"],
               "cell_s": r["cell_s"], "param_dev_bytes": r.get("param_dev_bytes"),
               "state_dev_bytes": r.get("state_dev_bytes"),
               "compute_s": roof.get("compute_s"), "memory_s": roof.get("memory_s"),
               "collective_s": roof.get("collective_s"), "dominant": r.get("dominant"),
               "collectives": {k: [v["count"], v["bytes"]]
                               for k, v in roof.get("collectives", {}).items()},
               "ssd_calls": r.get("ssd_calls"), "n_ops": r.get("n_ops"),
               "memory_analysis": r.get("memory_analysis"),
               "hbm_bytes": roof.get("hbm_bytes"),
               **({"error": r["error"]} if r["status"] == "fail" else {})})
        if r["status"] != ("ok" if ok else "skip"):
            bad.append((r["arch"], r["shape"], r["mesh"], r["status"], r.get("error")))
    ph.info.update({"cells": len(results), "workers": workers,
                    "ok": sum(r["status"] == "ok" for r in results),
                    "skip": sum(r["status"] == "skip" for r in results),
                    "multi_archs": list(multi)})
    if bad:
        raise AssertionError(f"dry-run cells not as cell_supported says: {bad}")
    return results


@contextlib.contextmanager
def _plain_ssd():
    """A context in which the models' SSD scan is the plain version (autograd
    through the sequential scan) on every device: the oracle of the
    gradient check."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    real = ops.ssd_chunk_scan
    ops.ssd_chunk_scan = lambda x, dt, a, b, c, h0=None, *, chunk: \
        ssd.ssd_scan_plain(x, dt, a, b, c, h0)
    try:
        yield
    finally:
        ops.ssd_chunk_scan = real


def mamba2_grad_check(ph: Phase, device: str = "cuda", shrink=None,
                      spec: dict = TRAIN_GRAD, seed: int = SEED) -> None:
    """mamba2-1.3b at full width, ``spec["layers"]`` layers, f32: the loss
    and its gradients through the SSD kernels against the same through the
    plain scan, on the same weights and batch (a ragged length)."""
    import numpy as np
    import torch
    from repro_torch.checkpoint import _tree
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models.model import build_model
    from repro_torch.train.steps import params_of, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config(TRAIN["arch"], shrink, n_layers=spec["layers"], dtype="float32")
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(seed))
    params = params_of(model)
    batch = batch_for_step(DataConfig(spec["batch"], spec["seq_len"], cfg.vocab), cfg, 0,
                           device=device)
    loss, grads = value_and_grad(model, params, batch)
    with _plain_ssd():
        want_loss, want = value_and_grad(model, params, batch)
    flat_g, flat_w = _tree.flatten_with_path(grads)[0], _tree.leaves(want)
    top = max(float(w.abs().max()) for w in flat_w)
    worst, worst_rel = None, 0.0
    for (name, g), w in zip(flat_g, flat_w):
        scale = max(float(w.abs().max()), GRAD_FLOOR * top / TRAIN_GRAD_TOL, 1e-30)
        rel = float((g - w).abs().max()) / scale
        if not rel <= TRAIN_GRAD_TOL:
            raise AssertionError(f"gradient {name} through the kernels differs from the plain "
                                 f"scan's: {rel} of its scale")
        if rel > worst_rel:
            worst, worst_rel = name, rel
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    if not (np.isfinite(float(loss)) and loss_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"loss {float(loss)} against the plain scan's {float(want_loss)}")
    ph.info.update({"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
                    "batch": spec["batch"], "seq_len": spec["seq_len"], "tol": TRAIN_GRAD_TOL,
                    "loss": float(loss), "loss_rel_err": loss_rel, "leaves": len(flat_w),
                    "worst_leaf": worst, "worst_rel_err": worst_rel})


def train_ckpt(ph: Phase, device: str = "cuda", runs=TRAIN_CKPT_RUNS) -> dict:
    """The reference's default training run on the card, then the same with
    the lane failed after the step-10 save: checkpoints every 5 steps
    through a RAID-5 engine whose codec runs here, a restart after step 12
    from step 10's checkpoint.  In the first run the save at step 10
    rebuilds lane 1 on a hot spare first (decoding its chunks on the card)
    and the restore reads four healthy lanes; in the second the restore
    itself reads degraded.  The recomputed steps must repeat the first
    pass's losses.  Returns the kernel launches since they were last zeroed,
    which the caller does just before the two runs."""
    import numpy as np
    from repro_torch.kernels import CODEC_KERNELS, launch_counts
    from repro_torch.launch import train

    for tag, argv in runs.items():
        args = train.parse_args(argv)
        before = launch_counts()
        rep = {}
        losses = train.run(list(argv) + ["--device", device], report=rep)
        after = launch_counts()
        last = args.restart_at // args.ckpt_every * args.ckpt_every  # the checkpoint restored
        first = losses[last : args.restart_at]
        again = losses[args.restart_at : 2 * args.restart_at - last]
        if len(losses) != args.steps + args.restart_at - last or \
                not np.allclose(again, first, **RESTART_TOL):
            raise AssertionError(f"{tag}: the restart did not recompute the same losses: "
                                 f"{first} then {again}")
        degraded = args.fail_at > last
        if degraded and rep["engine"]["degraded_reads"] == 0:
            raise AssertionError(f"{tag}: the restore did not read degraded: {rep['engine']}")
        codec = {k: after[k] - before[k] for k in CODEC_KERNELS}
        if device == "cuda" and not any(codec.values()):
            raise AssertionError(f"{tag}: no codec kernel launched: {codec}")
        ph.info[tag] = {"argv": list(argv), "losses": losses, "recomputed": again,
                        "engine": rep["engine"], "codec_launches": codec,
                        "step_ms_median": 1e3 * sorted(rep["step_s"])[len(rep["step_s"]) // 2]}
    return launch_counts()  # read just after the two runs


def train_families(ph: Phase, device: str = "cuda") -> None:
    """One train step of every architecture at smoke size: a finite loss and
    gradient norm, and parameters that changed."""
    import math

    import torch
    from repro_torch.checkpoint import _tree
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models.config import smoke
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps

    out = {}
    for arch in ARCHS:
        t = time.perf_counter()
        cfg = smoke(get_config(arch))
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
        model, step = steps.make_train_step(
            cfg, opt_cfg, device=device,
            generator=torch.Generator(device=device).manual_seed(SEED))
        params = steps.params_of(model)
        opt = steps.init_opt_state(model, params, opt_cfg)
        batch = batch_for_step(DataConfig(FAMILY_STEP["global_batch"], FAMILY_STEP["seq_len"],
                                          cfg.vocab), cfg, 0, device=device)
        new, _, m = step(params, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        changed = any(not torch.equal(a, b)
                      for a, b in zip(_tree.leaves(new), _tree.leaves(params)))
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0 and changed):
            raise AssertionError(f"{arch}: loss {loss}, grad norm {gnorm}, changed {changed}")
        out[arch] = {"family": cfg.family, "loss": loss, "grad_norm": gnorm,
                     "seconds": time.perf_counter() - t}
    ph.info["archs"] = out


# ------------------------------------------------------------ the examples

def example_main(name: str):
    """``main`` of ``examples/port_<name>.py``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"port_{name}",
                                                  ROOT / "examples" / f"port_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _example_differences(name: str, got: dict, want: dict) -> list[str]:
    """The keys of an example's outputs on the card (``got``) that differ
    from the CPU's (``want``): all of them equal, but a training run's
    losses, which agree within ``EXAMPLE_LOSS_TOL``."""
    import numpy as np

    bad = [k for k in want if k != "losses" and not _same(got.get(k), want[k])]
    bad += [k for k in got if k not in want]
    if "losses" in want and not (len(got["losses"]) == len(want["losses"]) and np.allclose(
            got["losses"], want["losses"], **EXAMPLE_LOSS_TOL)):
        bad.append("losses")
    return bad


def examples_phase(ph: Phase, device: str = "cuda", out: Path = ROOT / "build" / "examples",
                   names: tuple = EXAMPLES) -> None:
    """Each of ``examples/port_*.py`` (``names``) through its ``main`` on
    ``device`` and on the CPU, at the reference's sizes: every output of the
    card's run must equal the CPU's (``_example_differences``).  Prints each
    run's wall time, its kernel launches and its last line (each run's lines
    go to ``out/<name>_<device>.txt``).  ``port_degraded_restore`` must launch
    ``gf256_matmul`` (its RAID-6 decode) and ``stripe_xor`` on the card."""
    import contextlib
    import io

    from repro_torch.kernels import launch_counts

    out.mkdir(parents=True, exist_ok=True)
    info = {}
    for name in names:
        main = example_main(name)
        row = {}
        for dev in dict.fromkeys((device, "cpu")):
            argv = ["--device", dev]
            if name in ("trace_and_metrics", "scrub_repair"):
                argv += ["--out", str(out / dev)]
            before = launch_counts()
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = main(argv)
            _sync(dev)
            wall = time.perf_counter() - t
            after = launch_counts()
            (out / f"{name}_{dev}.txt").write_text(buf.getvalue())
            row[dev] = {"res": res, "wall_s": wall,
                        "launches": {k: after[k] - before[k] for k in after
                                     if after[k] > before[k]},
                        "last_line": buf.getvalue().strip().splitlines()[-1]}
        bad = _example_differences(name, row[device]["res"], row["cpu"]["res"])
        if bad:
            raise AssertionError(f"port_{name}: {device} and cpu differ in {bad}")
        info[name] = {"wall_s": row[device]["wall_s"], "cpu_wall_s": row["cpu"]["wall_s"],
                      "launches": row[device]["launches"], "outputs": "equal",
                      "last_line": row[device]["last_line"]}
    if device == "cuda":
        launched = info["degraded_restore"]["launches"]
        for kernel in ("gf256_matmul_batch", "parity_xor"):
            if not launched.get(kernel):
                raise AssertionError(f"port_degraded_restore did not launch {kernel}: "
                                     f"{launched}")
    ph.info["examples"] = info


# ---------------------------------------------------------------------- main

def main() -> int:
    src = ROOT / "src"
    csrc = src / "repro_torch" / "kernels" / "csrc"
    if not all((csrc / f).is_file() for f in ("codec.cu", "ssd_scan.cu", "ssd_scan_bwd.cu")):
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
    stripe_alu = stripe_alu_ops(lib)
    _emit({"phase": "build", "seconds": time.perf_counter() - t, "library": lib.name,
           "alu_ops_per_row_load": alu_per_load, "ssd_tensor_core_instructions": tensor_ops,
           "stripe_loads_before_first_combine": stripe_loads_first(lib),
           "stripe_alu_ops_per_thread": stripe_alu})

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

    reset_launch_counts()  # the timed path's launches start here
    with Phase("timed") as ph:
        pipe, want = timed_replay("cuda", FULL, SEED, ph)
    c = launch_counts()
    if not (c["parity_xor_batch"] and c["parity_xor"]):
        raise AssertionError(f"the timed replay did not launch xor_reduce and stripe_xor: {c}")
    with Phase("timed_degraded") as ph:
        timed_degraded(pipe, want, SEED, ph)
    timed_path = launch_counts()  # read just after the timed path
    del pipe, want
    gc.collect()
    with Phase("timed_profile") as ph:
        timed_busy_share(FULL, SEED, ph)
    gc.collect()
    with Phase("timed_card_vs_cpu") as ph:
        ph.info["result"] = timed_card_vs_cpu(SEED)
    gc.collect()

    serving = {tag: serving_path(tag, arch, SEED)
               for tag, arch in (("mamba2", "mamba2-1.3b"), ("dense", "qwen2.5-3b"),
                                 ("hybrid", "zamba2-2.7b"))}
    for name, fn in (("moe_serve", moe_serve), ("vlm", vlm_phase), ("encdec", encdec_phase)):
        with Phase(name) as ph:
            fn(SEED, ph)
        gc.collect()
        torch.cuda.empty_cache()
    with Phase("encdec_decode_check") as ph:
        decode_matches_prefill(ENCDEC["arch"], SEED, ph)
    gc.collect()
    torch.cuda.empty_cache()

    reset_launch_counts()  # the block service's and the checkpoints' launches start here
    with Phase("storage_sim") as ph:
        storage_sim(ph)
    with Phase("ckpt") as ph:
        weights = mamba2_weights(SEED)
        ckpt_phase(weights, ph)
    shapes = {k: w.shape for k, w in weights.items()}
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("state_parity") as ph:
        largest = state_parity_phase(shapes, SEED, ph)
    plain_parity = ph.info
    ckpt_path = launch_counts()  # read just after the three phases
    idle = [k for k in CODEC_KERNELS if ckpt_path[k] == 0]
    if idle:
        raise AssertionError(f"codec kernels never launched by the block service, the "
                             f"checkpoints and the state parity: {idle}")
    gc.collect()
    with Phase("state_parity_kernels") as ph:
        ph.info["kernels"] = state_parity_kernels(largest, int32_ops_per_s, stripe_alu)
    del largest
    gc.collect()
    torch.cuda.empty_cache()

    with Phase("ssd_grad") as ph:
        grad_row = ssd_grad_checks(lib)
        ph.info.update({k: v for k, v in grad_row.items()
                        if k not in ("route", "source", "replaces", "launches")})
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()  # the training run's launches start here
    with Phase("mamba2_train") as ph:
        train_path = mamba2_train(ph)
    unsharded = ph.info
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()  # the sharded training run's launches start here
    try:
        with Phase("sharded_train") as ph:
            sharded_path, trained = sharded_train(ph, unsharded)
        gc.collect()
        torch.cuda.empty_cache()
        reset_launch_counts()  # the sharded checkpoint's launches start here
        with Phase("sharded_ckpt") as ph:  # counts its DTensor calls' launches alone
            sharded_ckpt_path = sharded_ckpt(ph, trained, shapes, plain_parity)
        idle = [k for k in ("parity_xor_batch", "parity_xor", "gf256_matmul")
                if sharded_ckpt_path[k] == 0]
        if idle:
            raise AssertionError(f"sharded_ckpt never launched {idle}: {sharded_ckpt_path}")
        del trained
    finally:
        end_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("dryrun") as ph:
        dryrun_phase(ph, ROOT / "build" / "dryrun_smoke")
    with Phase("mamba2_grad_check") as ph:
        mamba2_grad_check(ph)
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()  # the checkpointed training runs' launches start here
    with Phase("train_ckpt") as ph:
        train_ckpt_path = train_ckpt(ph)
    gc.collect()
    with Phase("train_families") as ph:
        train_families(ph)
    gc.collect()
    torch.cuda.empty_cache()
    with Phase("examples") as ph:
        examples_phase(ph)

    for r in rows:
        r["launches"] = main_path[r["name"]]
    for r in ssd_rows:
        r["launches"] = serving["mamba2"][r["name"]]
    grad_row["launches"] = train_path["ssd_scan_bwd"]
    rows += ssd_rows + [grad_row]
    for r in rows:
        r["timed_launches"] = timed_path[r["name"]]
        r["ckpt_launches"] = ckpt_path[r["name"]]
        r["hybrid_launches"] = serving["hybrid"][r["name"]]
        r["train_launches"] = train_path[r["name"]]
        r["train_ckpt_launches"] = train_ckpt_path[r["name"]]
        r["sharded_train_launches"] = sharded_path[r["name"]]
        r["sharded_ckpt_launches"] = sharded_ckpt_path[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "timed_launches",
            "ckpt_launches", "hybrid_launches", "train_launches", "train_ckpt_launches",
            "sharded_train_launches", "sharded_ckpt_launches")
    _emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    print(gpu, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
