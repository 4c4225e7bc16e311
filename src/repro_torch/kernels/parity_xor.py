"""XOR parity over k data chunks: the wrappers of ``xor_reduce`` and
``stripe_xor``.

RAID-4/5 parity, the single-erasure decode (degraded read, rebuild, GC) and
the parity-protected OOB metadata are one XOR-reduce over the k rows of a
stripe.  The device of the tensor picks the path: a CPU tensor runs the plain
version in ``ref.py``; a CUDA tensor launches a kernel from ``csrc/codec.cu``
or raises -- ``xor_reduce`` for a stripe group (memory-bound, bound
4*S*(k+1)*n bytes), ``stripe_xor`` for one stripe.

:func:`parity_xor_host` is the host-operand form of the single stripe: its
operands lie in pinned host memory, which ``stripe_xor`` reads and writes in
place across the host link, and it returns once the result is there.
``StripeCodec``'s per-stripe path calls :func:`stripe_launch` with the
addresses of its staging buffers, resolved once.

``LAUNCHES`` counts kernel launches per entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"parity_xor_batch": 0, "parity_xor": 0}
_stripe_fn = None


def parity_xor_batch(data: torch.Tensor) -> torch.Tensor:
    """XOR-reduce a whole stripe group: (S, k, n) int32 -> (S, n) int32."""
    if _build.check_operand(data, 3, "parity_xor_batch") == "cpu":
        return ref.parity_xor_batch_ref(data)
    s, k, n = data.shape
    out = torch.empty((s, n), dtype=torch.int32, device=data.device)
    if out.numel():
        vec = int(n % 4 == 0 and _build.aligned16(data, out))
        _build.launch("codec_xor_reduce", data.data_ptr(), out.data_ptr(), s, k, n, vec)
        LAUNCHES["parity_xor_batch"] += 1
    return out


def stripe_launch(src: int, dst: int, k: int, n: int, vec: bool, stream: int,
                  sync: bool) -> None:
    """Launch ``stripe_xor`` on device addresses: (k, n) int32 at ``src`` ->
    (n,) at ``dst`` (device memory, or pinned host memory the card maps), on
    ``stream``; with ``sync``, return once the stream has finished.  ``vec``:
    n % 4 == 0 and both addresses 16-byte aligned."""
    global _stripe_fn
    if _stripe_fn is None:
        _stripe_fn = _build.load().codec_stripe_xor
    err = _stripe_fn(src, dst, k, n, int(vec), stream, int(sync))
    if err != 0:
        raise RuntimeError(f"stripe_xor: CUDA launch failed with error {err}")
    LAUNCHES["parity_xor"] += 1


def parity_xor(data: torch.Tensor) -> torch.Tensor:
    """XOR-reduce one stripe: (k, n) int32 -> (n,) int32, on the current
    stream (asynchronous on a CUDA tensor)."""
    if _build.check_operand(data, 2, "parity_xor") == "cpu":
        return ref.parity_xor_ref(data)
    k, n = data.shape
    out = torch.empty((n,), dtype=torch.int32, device=data.device)
    if n:
        stripe_launch(data.data_ptr(), out.data_ptr(), k, n,
                      n % 4 == 0 and _build.aligned16(data, out),
                      torch.cuda.current_stream(data.device).cuda_stream, False)
    return out


def parity_xor_host(data: torch.Tensor, out: torch.Tensor, stream: int | None = None) -> None:
    """XOR-reduce one stripe in pinned host memory: (k, n) int32 -> ``out``
    (n,) int32, in one launch of ``stripe_xor`` that reads ``data`` and writes
    ``out`` across the host link, on ``stream`` (a ``cudaStream_t`` handle;
    the current stream if None).  Returns once ``out`` holds the result."""
    _build.check_host_operand(data, 2, "parity_xor_host")
    _build.check_host_operand(out, 1, "parity_xor_host out")
    k, n = data.shape
    if out.shape[0] != n:
        raise ValueError(f"parity_xor_host: out {tuple(out.shape)} for data {tuple(data.shape)}")
    if n:
        src, dst = _build.host_device_pointer(data), _build.host_device_pointer(out)
        stripe_launch(src, dst, k, n, n % 4 == 0 and src % 16 == 0 and dst % 16 == 0,
                      torch.cuda.current_stream().cuda_stream if stream is None else stream,
                      True)
