"""GF(256) matrix multiply for Reed-Solomon: the wrappers of ``gf256_matmul``
and ``stripe_gf256``.

Computes P = M (*) D where M is an (m, k) GF(256) coefficient matrix and D is
(S, k, n) data with 4 GF bytes packed per int32 lane (polynomial 0x11d).  Used
for RAID-6 encode (M = the parity rows of the systematic generator, m = 2)
and decode (M = the inverse of the surviving rows, m = k).

The device of the data picks the path: a CPU tensor runs the plain version in
``ref.py``; a CUDA tensor launches a kernel from ``csrc/codec.cu`` (the SWAR
double-and-add of ``core/gf.py`` in uint32) or raises -- ``gf256_matmul`` for
a stripe group (bound 4*S*(k+m)*n bytes, or its ALU work), ``stripe_gf256``
for one stripe.

The single-stripe kernel takes its coefficients by value, in the launch's
parameters (at most ``MAX_STRIPE_COEFFS`` = m*k of them), so they are read on
the host: pass them as a CPU tensor (a CUDA one is copied back first, which
waits for the card).  :func:`gf256_matmul_host` is the host-operand form:
data and output in pinned host memory, read and written in place across the
host link; it returns once the result is there.  ``StripeCodec``'s
per-stripe path calls :func:`stripe_launch` with the addresses of its staging
buffers, resolved once.

``LAUNCHES`` counts kernel launches per entry point.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"gf256_matmul_batch": 0, "gf256_matmul": 0}

# the batched kernel stages the (m, k) coefficients in dynamic shared memory,
# which a launch may size up to 48 KiB without opting in
_MAX_COEFFS = 48 * 1024 // 4
# the single-stripe kernel's by-value coefficient bytes (kMaxStripeCoeffs)
MAX_STRIPE_COEFFS = 1024
_stripe_fn = None


def _check(coeff: torch.Tensor, data: torch.Tensor, ndim: int, entry: str) -> str:
    _build.check_operand(coeff, 2, entry + " coeff")
    path = _build.check_operand(data, ndim, entry)
    if coeff.shape[1] != data.shape[-2]:
        raise ValueError(f"{entry}: coeff {tuple(coeff.shape)} vs data "
                         f"{tuple(data.shape)}")
    return path


def gf256_matmul_batch(coeff: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(m, k) GF coeffs x (S, k, n) packed int32 -> (S, m, n) packed int32."""
    if _check(coeff, data, 3, "gf256_matmul_batch") == "cpu":
        return ref.gf256_matmul_batch_ref(coeff, data)
    m, k = coeff.shape
    s, _, n = data.shape
    if coeff.device != data.device:
        raise ValueError(f"gf256_matmul_batch: coeff on {coeff.device}, data on {data.device}")
    if m * k > _MAX_COEFFS:
        raise ValueError(f"gf256_matmul_batch: {m}x{k} coefficients exceed shared memory")
    out = torch.empty((s, m, n), dtype=torch.int32, device=data.device)
    if out.numel():
        vec = int(n % 4 == 0 and _build.aligned16(data, out))
        _build.launch("codec_gf256_matmul", coeff.data_ptr(), data.data_ptr(),
                      out.data_ptr(), m, k, s, n, vec)
        LAUNCHES["gf256_matmul_batch"] += 1
    return out


def stripe_launch(coeff: int, m: int, k: int, src: int, dst: int, n: int, vec: bool,
                  stream: int, sync: bool) -> None:
    """Launch ``stripe_gf256``: (m, k) int32 coefficients at HOST address
    ``coeff`` (m*k <= ``MAX_STRIPE_COEFFS``) x (k, n) int32 at device address
    ``src`` -> (m, n) at ``dst`` (device memory, or pinned host memory the
    card maps), on ``stream``; with ``sync``, return once the stream has
    finished.  ``vec``: n % 4 == 0 and both addresses 16-byte aligned."""
    global _stripe_fn
    if m * k > MAX_STRIPE_COEFFS:
        raise ValueError(f"stripe_gf256: {m}x{k} coefficients exceed the "
                         f"{MAX_STRIPE_COEFFS} a launch takes by value")
    if _stripe_fn is None:
        _stripe_fn = _build.load().codec_stripe_gf256
    err = _stripe_fn(coeff, m, k, src, dst, n, int(vec), stream, int(sync))
    if err != 0:
        raise RuntimeError(f"stripe_gf256: CUDA launch failed with error {err}")
    LAUNCHES["gf256_matmul"] += 1


def gf256_matmul(coeff: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(m, k) GF coeffs x (k, n) packed int32 -> (m, n) packed int32, on the
    current stream (asynchronous on a CUDA tensor with CPU coefficients)."""
    if _check(coeff, data, 2, "gf256_matmul") == "cpu":
        return ref.gf256_matmul_ref(coeff, data)
    c = coeff.to("cpu").contiguous()
    (m, k), n = c.shape, data.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=data.device)
    if out.numel():
        stripe_launch(c.data_ptr(), m, k, data.data_ptr(), out.data_ptr(), n,
                      n % 4 == 0 and _build.aligned16(data, out),
                      torch.cuda.current_stream(data.device).cuda_stream, False)
    return out


def gf256_matmul_host(coeff: torch.Tensor, data: torch.Tensor, out: torch.Tensor,
                      stream: int | None = None) -> None:
    """(m, k) GF coeffs x (k, n) packed int32 in pinned host memory -> ``out``
    (m, n), in one launch of ``stripe_gf256`` that reads ``data`` and writes
    ``out`` across the host link, on ``stream`` (a ``cudaStream_t`` handle;
    the current stream if None).  Returns once ``out`` holds the result."""
    _build.check_operand(coeff, 2, "gf256_matmul_host coeff")
    _build.check_host_operand(data, 2, "gf256_matmul_host")
    _build.check_host_operand(out, 2, "gf256_matmul_host out")
    c = coeff.to("cpu").contiguous()
    (m, k), n = c.shape, data.shape[1]
    if data.shape[0] != k or out.shape != (m, n):
        raise ValueError(f"gf256_matmul_host: coeff {tuple(c.shape)}, data "
                         f"{tuple(data.shape)}, out {tuple(out.shape)}")
    if out.numel():
        src, dst = _build.host_device_pointer(data), _build.host_device_pointer(out)
        stripe_launch(c.data_ptr(), m, k, src, dst, n,
                      n % 4 == 0 and src % 16 == 0 and dst % 16 == 0,
                      torch.cuda.current_stream().cuda_stream if stream is None else stream,
                      True)
