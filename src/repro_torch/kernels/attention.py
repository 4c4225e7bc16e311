"""Causal GQA attention for prefill: the wrapper of ``csrc/attention.cu``.

One launch computes what ``models/layers.py blocked_causal_attention``
computes, at its precision: f32 scores of bf16 operands on the tensor cores,
a mask of -1e30 (causal, and with ``attn_chunk`` > 0 llama4's local chunks),
the softmax in f32 of the scores times ``scale`` (head_dim ** -0.5 unless
given), the weights rounded to bf16 before P V, P V summed in f32 and the
output rounded once to bf16.  The kernel's design, and why it
rounds the unnormalised weights (one pass), are in its source.

It replaces no Pallas kernel: the JAX package's attention is ``jnp`` code,
whose counterpart is the blocked function, and that stays the plain version:
``models/layers.py prefill_attention`` runs it where :func:`takes` refuses
the operands (CPU tensors, float32 models, DTensors and training, which
records a graph; this kernel has no backward), and this wrapper otherwise.
The wrapper raises for what the kernel does not take, a head dim without an
instance among it, and launches through the operator
``repro_torch::causal_attention``.

Operands: q (B, T, H, hd) and k, v (B, S, KV, hd), bf16 on one CUDA device,
H a multiple of KV, hd one of ``HEAD_DIMS``, each with a contiguous last
dimension, other strides multiples of 8 elements and 16-byte aligned data.
The output (B, T, H, hd) bf16 is new (``torch.empty``).  Query row i sits at
position ``q_offset + i``.

``LAUNCHES`` counts kernel launches: one per call with work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, route

HEAD_DIMS = (16, 64, 80, 128, 256)
LAUNCHES = {"causal_attention": 0}


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a prefill's q, k, v go to the kernel: ``route.forward_only``."""
    return route.forward_only((q, k, v))


def attention_flops(b: int, t: int, h: int, hd: int) -> int:
    """FLOPs of causal Q K^T and P V over T queries and keys: 2 x 2 x hd per
    visible (query, key) pair, T (T + 1) / 2 pairs per (batch row, head); at
    zamba2-2.7b's prefill (8, 4,096, 32, 80), 687.3 GFLOP."""
    return 2 * hd * t * (t + 1) * b * h


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
           attn_chunk: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"causal_attention: want q (B,T,H,hd) and k, v (B,S,KV,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"causal_attention: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same batch and head dim, H a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"causal_attention: the CUDA kernel takes a head dim of {HEAD_DIMS}, "
                         f"got {hd}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise TypeError(f"causal_attention: q, k, v must be bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q_offset < 0 or attn_chunk < 0:
        raise ValueError(f"causal_attention: need q_offset >= 0 and attn_chunk >= 0, got "
                         f"{q_offset}, {attn_chunk}")
    if any(x.device.type != "cuda" for x in (q, k, v)) or len({q.device, k.device, v.device}) > 1:
        raise ValueError(f"causal_attention: the kernel takes CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}; the plain version is "
                         "models.layers.blocked_causal_attention")


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: int = 0, attn_chunk: int = 0,
                     scale: float | None = None) -> torch.Tensor:
    """Exact causal GQA attention on the card: q (B,T,H,hd), k, v
    (B,S,KV,hd) bf16 -> (B,T,H,hd) bf16, in one launch on the current
    stream.  Query row i sees keys j <= i + q_offset (and, with
    ``attn_chunk`` > 0, only keys of its own chunk); the scores are scaled
    by ``scale``, head_dim ** -0.5 by default."""
    _check(q, k, v, q_offset, attn_chunk)
    return causal_attention_op(q, k, v, q_offset, attn_chunk,
                               q.shape[3] ** -0.5 if scale is None else scale)


# The launch as an operator of its own (``repro_torch::causal_attention``),
# as the SSD scan's: a profiler puts the kernel's device time under it, and
# so under the span of the layer that called it, and fake tensors trace it
# through its shape function.  It has no autograd rule: :func:`takes` sends a
# graph that autograd records to the blocked function.

@torch.library.custom_op("repro_torch::causal_attention", mutates_args=())
def causal_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
                        attn_chunk: int, scale: float) -> torch.Tensor:
    """:func:`causal_attention` on checked operands."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(x.stride(d) % 8 for d in range(3)) or x.data_ptr() % 16:
            raise ValueError(f"causal_attention: {name} needs a contiguous head dim, strides "
                             f"that are multiples of 8 and 16-byte aligned data, got strides "
                             f"{x.stride()}")
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, t, h, hd), dtype=torch.bfloat16, device=q.device)
    if out.numel() == 0 or s == 0:
        return out.zero_() if s == 0 else out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    _build.launch("causal_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), b, t, s, h, kvh, hd, q_offset, attn_chunk,
                  ctypes.c_float(scale), strides)
    LAUNCHES["causal_attention"] += 1
    return out


@causal_attention_op.register_fake
def _(q, k, v, q_offset, attn_chunk, scale):
    return q.new_empty(q.shape)
