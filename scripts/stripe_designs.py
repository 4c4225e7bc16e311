#!/usr/bin/env python3
"""Time two designs of the single-stripe codec round trip on one GPU.

* mapped -- the port's design (``StripeCodec.encode_np`` / ``decode_np``):
  the single-stripe kernel reads and writes pinned host memory that the
  card maps, and its C entry synchronises the stream;
* copies -- the same pinned buffers copied to device memory with
  ``cudaMemcpyAsync``, the same kernel there, the result copied back and
  one stream sync, all in one C call (``scripts/stripe_copies.cu``, which
  reaches the kernels through the port library's C entries);
* mapped, write-combined input -- the mapped design with its input buffer
  allocated write-combined (the host only writes it).

and, to take the mapped round trip apart: the C call alone (no staging
copies), the staging copies alone and the mapped kernel's device time
(``torch.profiler``) -- also against the rows crossing the link: XOR of
k = 1..9 rows and GF of (2, k) and (k, k), k = 2..9, at 4,096 lanes (k = 9:
the runtime instance).

Every variant stages the stripe the same way (a numpy copy into the input
buffer, a copy of the output out), on a side stream, at the datapath's
Zone-Write shapes: RAID-5 (3+1) XOR and RAID-6 (2+2) GF encode and decode of
16 KiB chunks.  Each is timed on the host's clock over ``ITERS`` calls, in
the order mapped, copies, write-combined, write-combined, copies, mapped,
and checked against the plain version.  Prints one JSON line with the card
and its power limit.  Run from the root of a checkout::

    python3 scripts/stripe_designs.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ITERS = 2000
LANES = 4096  # one 16 KiB chunk per row


def build_designs() -> ctypes.CDLL:
    """``stripe_copies.cu`` built and linked against the port's library."""
    from repro_torch.kernels import _build

    kernels = _build.build()
    out = ROOT / "build" / "stripe_designs" / "libdesigns.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(ROOT / "scripts" / "stripe_copies.cu"), str(kernels)], check=True)
    lib = ctypes.CDLL(str(out))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.design_copies.argtypes = [vp, i, i, vp, vp, vp, vp, ll, vp]
    lib.design_host_alloc_wc.argtypes = [ctypes.c_ulonglong, ctypes.POINTER(vp)]
    lib.design_host_free.argtypes = [vp]
    return lib


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("stripe_designs: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import gf
    from repro_torch.kernels import _build, ref

    designs = build_designs()
    lib = _build.load()
    stream = torch.cuda.Stream().cuda_stream
    rng = np.random.default_rng(3)

    def per_call_us(fn) -> float:
        for _ in range(100):
            fn()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        return 1e6 * (time.perf_counter() - t0) / ITERS

    def device_us(fn, iters: int) -> float:
        for _ in range(50):
            fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
        return sum(e.self_device_time_total for e in prof.key_averages()) / iters

    def stripe(cptr, m, k, src, dst):
        """The port's single-stripe launch on device addresses, synchronised."""
        err = (lib.codec_stripe_xor(src, dst, k, LANES, 1, stream, 1) if not cptr else
               lib.codec_stripe_gf256(cptr, m, k, src, dst, LANES, 1, stream, 1))
        if err:
            raise RuntimeError(f"stripe launch failed: {err}")

    shapes = {  # name -> (rows in, coefficients or None)
        "raid5_xor": (3, None),
        "raid6_encode": (2, gf.rs_parity_matrix(2, 2)),
        "raid6_decode": (2, gf.rs_decode_matrix(2, 2, (2, 3))),
    }
    out = {}
    wc_buffers = []
    for name, (k, mat) in shapes.items():
        m = 1 if mat is None else mat.shape[0]
        coeff = None if mat is None else torch.from_numpy(mat.astype(np.int32))
        cptr = 0 if coeff is None else coeff.data_ptr()
        data = rng.integers(-2**31, 2**31, (k, LANES), dtype=np.int64).astype(np.int32)
        d = torch.from_numpy(data)
        want = (ref.parity_xor_ref(d)[None] if coeff is None
                else ref.gf256_matmul_ref(coeff, d)).numpy()
        pin_in = torch.empty((k, LANES), dtype=torch.int32, pin_memory=True)
        pin_out = torch.empty((m, LANES), dtype=torch.int32, pin_memory=True)
        scratch_in = torch.empty((k, LANES), dtype=torch.int32, device="cuda")
        scratch_out = torch.empty((m, LANES), dtype=torch.int32, device="cuda")
        wc = ctypes.c_void_p()
        if designs.design_host_alloc_wc(4 * k * LANES, ctypes.byref(wc)):
            raise RuntimeError("cudaHostAlloc failed")
        wc_buffers.append(wc.value)
        wc_in = np.ctypeslib.as_array(
            (ctypes.c_int32 * (k * LANES)).from_address(wc.value)).reshape(k, LANES)
        in_np, out_np = pin_in.numpy(), pin_out.numpy()
        dev_in, dev_out = (_build.host_device_pointer(t) for t in (pin_in, pin_out))
        dev_wc = ctypes.c_void_p()
        if lib.codec_host_device_pointer(wc, ctypes.byref(dev_wc)):
            raise RuntimeError("cudaHostGetDevicePointer failed")

        def mapped(src_np=in_np, src_dev=dev_in):
            np.copyto(src_np, data)
            stripe(cptr, m, k, src_dev, dev_out)
            return out_np.copy()

        def copies():
            np.copyto(in_np, data)
            err = designs.design_copies(cptr or None, m, k, pin_in.data_ptr(),
                                        pin_out.data_ptr(), scratch_in.data_ptr(),
                                        scratch_out.data_ptr(), LANES, stream)
            if err:
                raise RuntimeError(f"copy design failed: {err}")
            return out_np.copy()

        def mapped_wc():
            return mapped(wc_in, dev_wc.value)

        def staging():
            np.copyto(in_np, data)
            return out_np.copy()

        variants = {"mapped": mapped, "copies": copies, "mapped_wc_input": mapped_wc}
        times = {v: [] for v in variants}
        for v in ("mapped", "copies", "mapped_wc_input", "mapped_wc_input", "copies", "mapped"):
            fn = variants[v]
            if not np.array_equal(fn(), want):
                raise AssertionError(f"{name} {v}: wrong result")
            times[v].append(per_call_us(fn))
        out[name] = {
            "rows_in": k, "rows_out": m, "lanes": LANES,
            **{f"{v}_us": t for v, t in times.items()},
            "call_only_us": per_call_us(lambda: stripe(cptr, m, k, dev_in, dev_out)),
            "staging_only_us": per_call_us(staging),
            "kernel_device_us": device_us(lambda: stripe(cptr, m, k, dev_in, dev_out), ITERS)}

    big_in = torch.empty((9, LANES), dtype=torch.int32, pin_memory=True).random_()
    big_out = torch.empty((9, LANES), dtype=torch.int32, pin_memory=True)
    src, dst = (_build.host_device_pointer(t) for t in (big_in, big_out))
    sweep = {}
    for k in range(1, 10):
        sweep[f"xor k={k}"] = device_us(lambda k=k: stripe(0, 1, k, src, dst), ITERS // 2)
        if k < 2:
            continue
        for label, mat in (("2", gf.rs_parity_matrix(k, 2)),
                           ("k", gf.rs_decode_matrix(k, 2, tuple(range(2, k + 2))))):
            c = torch.from_numpy(mat.astype(np.int32))
            sweep[f"gf m={label} k={k}"] = device_us(
                lambda c=c, m=mat.shape[0], k=k: stripe(c.data_ptr(), m, k, src, dst),
                ITERS // 2)
    out["kernel_device_us_by_rows"] = sweep
    for host in wc_buffers:
        designs.design_host_free(host)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"gpu": gpu, "iters": ITERS, "round_trip_us": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
