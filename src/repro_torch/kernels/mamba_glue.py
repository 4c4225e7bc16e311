"""The Mamba-2 block's prefill glue: the wrapper of ``csrc/mamba_glue.cu``.

Two launches take the elementwise work around the SSD scan off the plain
torch chain of ``models/mamba2.py mamba_apply``:

* :func:`mamba_conv` -- the depthwise causal conv of [x | B | C] plus its
  bias, then SiLU, read from the three projections' outputs where they lie
  (no concatenation), written as one (B, T, d_inner + 2 N) bf16 tensor whose
  slices the scan takes as views; and the conv tail (B, W - 1, d_inner + 2 N),
  the last W - 1 input rows (zeros in front where T < W - 1), as a tensor of
  its own, equal bit for bit to the plain path's;
* :func:`mamba_gate_norm` -- rmsnorm((y + D x) silu(z)) scale from the scan's
  f32 output as it wrote it, in f32 with ``models/layers.py rmsnorm``'s cast
  order at the end.

Each rounds once where the plain chain rounds to bf16 at every step, so its
result is at least as close to the f32 computation.  What bounds them (their
bytes) and their design are in the source.  Beside each wrapper is its plain
torch version at the kernel's precision (:func:`mamba_conv_plain`,
:func:`mamba_gate_norm_plain`), which the tests and ``chip_smoke.py`` hold
the kernels to.

They replace no Pallas kernel: the JAX package's glue is ``jnp`` code, whose
plain counterpart is ``mamba_apply``'s own chain, and that stays the path of
decode and of every prefill block that :func:`takes` refuses: CPU tensors,
float32 models, DTensors and training (these kernels have no backward).
The route never looks at shapes: the checked wrappers :func:`mamba_conv` and
:func:`mamba_gate_norm` raise for a shape the kernels do not take, with
:func:`conv_refusal`'s or :func:`norm_refusal`'s reason, so a bf16 prefill on
the card never runs the slow chain unnoticed.  The launches are the operators
``repro_torch::mamba_conv`` and ``repro_torch::mamba_gate_norm``, so a
profiler puts their device time under the block's span.

``LAUNCHES`` counts kernel launches: one of each per fused block.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, route

WIDTHS = (4,)           # conv widths with an instance
MAX_INNER = 8192        # d_inner limit of the norm's one block a row
LAUNCHES = {"mamba_conv": 0, "mamba_gate_norm": 0}


def _rows_ok(x: torch.Tensor) -> bool:
    """Whether x's dims after the first two are contiguous, with 16-byte
    aligned data and batch and time strides."""
    per16 = 16 // x.element_size()
    inner = x.shape[2:].numel()
    dense = all(x.stride(d) == x.shape[d + 1:].numel() for d in range(2, x.ndim))
    return (dense and inner % per16 == 0 and x.data_ptr() % 16 == 0
            and x.stride(0) % per16 == 0 and x.stride(1) % per16 == 0)


def takes(xs, bb, cc, z, dt, a, conv_w, conv_b, d_skip, norm) -> bool:
    """Whether a prefill block's glue goes to the kernels:
    ``route.forward_only`` of its projections xs, bb, cc and z, of dt and A,
    which the scan between the two kernels reads, and of the four weights
    the kernels read."""
    return route.forward_only((xs, bb, cc, z), (dt, a, conv_w, conv_b, d_skip, norm))


def _on_card(*tensors: torch.Tensor) -> bool:
    return all(v.device.type == "cuda" for v in tensors) and \
        len({v.device for v in tensors}) == 1


def conv_refusal(xs, bb, cc, conv_w, conv_b) -> str | None:
    """Why :func:`mamba_conv` cannot take these operands, or None if it can:
    xs (B, T, d_inner), bb and cc (B, T, N), conv_w (W, C) and conv_b (C,)
    with C = d_inner + 2 N, all bf16 on one CUDA device; d_inner and N
    multiples of 8, W one of ``WIDTHS``, 1 <= T; rows of contiguous channels
    with 16-byte aligned data and strides."""
    if xs.ndim != 3 or bb.ndim != 3 or cc.shape != bb.shape or bb.shape[:2] != xs.shape[:2]:
        return f"want x (B,T,d_inner), b and c (B,T,N), got {tuple(xs.shape)}, " \
               f"{tuple(bb.shape)}, {tuple(cc.shape)}"
    nb, t, di = xs.shape
    n = bb.shape[2]
    ch = di + 2 * n
    if conv_w.ndim != 2 or conv_w.shape[1] != ch or conv_b.shape != (ch,):
        return f"conv_w {tuple(conv_w.shape)} and conv_b {tuple(conv_b.shape)} do not fit " \
               f"{ch} channels"
    if di % 8 or n % 8 or conv_w.shape[0] not in WIDTHS:
        return f"the conv takes d_inner and N in multiples of 8 and a width of {WIDTHS}, " \
               f"got {di}, {n}, {conv_w.shape[0]}"
    if not 1 <= t <= 65535 * 64 or nb > 65535:
        return f"the conv takes 1 <= T <= {65535 * 64} and B <= 65535, got T {t}, B {nb}"
    ops = (xs, bb, cc, conv_w, conv_b)
    if any(v.dtype != torch.bfloat16 for v in ops):
        return f"the conv takes bfloat16 operands, got {[v.dtype for v in ops]}"
    if not _on_card(*ops):
        return "the kernels take CUDA tensors on one device; the plain version is " \
               "models.mamba2.mamba_apply's own chain"
    if not (all(_rows_ok(v) for v in (xs, bb, cc))
            and all(v.is_contiguous() and v.data_ptr() % 16 == 0 for v in (conv_w, conv_b))):
        return "the conv takes rows of contiguous channels with 16-byte aligned data and strides"
    return None


def norm_refusal(x, z, d_skip, norm, y=None) -> str | None:
    """Why :func:`mamba_gate_norm` cannot take these operands, or None if it
    can: x (B, T, H, P) and z (B, T, d_inner = H P) bf16, d_skip (H,) f32,
    norm (d_inner,) bf16 and, where given, y (B, T', H, P) f32 with T' >= T,
    on one CUDA device; d_inner and P multiples of 8, d_inner at most
    ``MAX_INNER``; rows of contiguous channels with 16-byte aligned data and
    strides."""
    if x.ndim != 4 or z.shape != (*x.shape[:2], x.shape[2] * x.shape[3]):
        return f"want x (B,T,H,P) and z (B,T,H*P), got {tuple(x.shape)}, {tuple(z.shape)}"
    nb, t, h, p = x.shape
    if d_skip.shape != (h,) or norm.shape != (h * p,):
        return f"d_skip {tuple(d_skip.shape)} and norm {tuple(norm.shape)} do not fit " \
               f"{h} heads of {p}"
    if y is not None and (y.ndim != 4 or y.shape[0] != nb or y.shape[1] < t
                          or y.shape[2:] != x.shape[2:] or y.dtype != torch.float32):
        return f"want y (B,T',H,P) f32 with T' >= T, got {tuple(y.shape)} {y.dtype}"
    if p % 8 or h * p > MAX_INNER or t < 1:
        return f"the norm takes a head dim in multiples of 8, d_inner <= {MAX_INNER} and " \
               f"T >= 1, got {p}, {h * p}, {t}"
    ops = (x, z, norm)
    if any(v.dtype != torch.bfloat16 for v in ops) or d_skip.dtype != torch.float32:
        return f"the norm takes bfloat16 x, z and norm and a float32 d_skip, got " \
               f"{[v.dtype for v in ops]}, {d_skip.dtype}"
    if not _on_card(*ops, d_skip, *(() if y is None else (y,))):
        return "the kernels take CUDA tensors on one device; the plain version is " \
               "models.mamba2.mamba_apply's own chain"
    if not (all(_rows_ok(v) for v in (x, z, *(() if y is None else (y,))))
            and all(v.is_contiguous() and v.data_ptr() % 16 == 0 for v in (d_skip, norm))):
        return "the norm takes rows of contiguous channels with 16-byte aligned data and strides"
    return None


def mamba_conv(xs, bb, cc, conv_w, conv_b) -> tuple[torch.Tensor, torch.Tensor]:
    """silu(causal_conv([xs | bb | cc]) + conv_b) as (B, T, C) bf16, and the
    conv tail (B, W - 1, C) bf16, in one launch on the current stream."""
    conv_w, conv_b = aligned(conv_w), aligned(conv_b)
    _require(conv_refusal(xs, bb, cc, conv_w, conv_b))
    return mamba_conv_op(xs, bb, cc, conv_w, conv_b)


def mamba_gate_norm(y, x, z, d_skip, norm, eps: float) -> torch.Tensor:
    """rmsnorm((y + D x) silu(z)) * norm as (B, T, d_inner) bf16, in one
    launch on the current stream: y (B, T', H, P) f32 with T' >= T (the
    scan's padded output), x (B, T, H, P) and z (B, T, d_inner) bf16."""
    d_skip, norm = aligned(d_skip), aligned(norm)
    _require(norm_refusal(x, z, d_skip, norm, y))
    return mamba_gate_norm_op(y, x, z, d_skip, norm, eps)


def mamba_conv_plain(xs, bb, cc, conv_w, conv_b) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_conv` in plain torch, at the kernel's precision: the
    taps summed in f32 in the plain chain's order, the bias, the SiLU in
    f32 and one rounding to bf16; the tail copied from the padded input."""
    x = torch.cat([xs, bb, cc], -1)
    width, t = conv_w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    acc = xp[:, :t].float() * conv_w[0].float()
    for j in range(1, width):
        acc = acc + xp[:, j:j + t].float() * conv_w[j].float()
    return F.silu(acc + conv_b.float()).to(torch.bfloat16), xp[:, t:].clone()


def mamba_gate_norm_plain(y, x, z, d_skip, norm, eps: float) -> torch.Tensor:
    """:func:`mamba_gate_norm` in plain torch, at the kernel's precision:
    f32 up to the normalised value, rounded to bf16, then scaled."""
    nb, t, h, p = x.shape
    v = (y[:, :t] + d_skip.reshape(h, 1) * x.float()).reshape(nb, t, h * p) * F.silu(z.float())
    var = torch.mean(v * v, dim=-1, keepdim=True)
    return (v * torch.rsqrt(var + eps)).to(torch.bfloat16) * norm


def aligned(w: torch.Tensor) -> torch.Tensor:
    """A parameter vector as the kernels read it: ``w`` itself if contiguous
    and 16-byte aligned, else a copy that is.  A layer's slice of a packed
    or stacked leaf may start off that alignment; a copy of a few KB costs
    far less than the plain chain."""
    if w.is_contiguous() and w.data_ptr() % 16 == 0:
        return w
    return w.clone(memory_format=torch.contiguous_format)


def _require(reason: str | None) -> None:
    if reason is not None:
        raise ValueError(f"mamba_glue: {reason}")


# The launches as operators of their own, as the SSD scan's and attention's:
# a profiler puts the kernels' device time under them, and so under the
# span of the block that called them, and fake tensors trace them through
# their shape functions.  They have no autograd rule: :func:`takes` sends a
# graph that autograd records to the plain chain.

@torch.library.custom_op("repro_torch::mamba_conv", mutates_args=())
def mamba_conv_op(xs: torch.Tensor, bb: torch.Tensor, cc: torch.Tensor, conv_w: torch.Tensor,
                  conv_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_conv` on checked operands."""
    nb, t, di = xs.shape
    n, width = bb.shape[2], conv_w.shape[0]
    ch = di + 2 * n
    out = torch.empty((nb, t, ch), dtype=torch.bfloat16, device=xs.device)
    tail = torch.empty((nb, width - 1, ch), dtype=torch.bfloat16, device=xs.device)
    strides = (ctypes.c_longlong * 6)(xs.stride(0), xs.stride(1), bb.stride(0), bb.stride(1),
                                      cc.stride(0), cc.stride(1))
    _build.launch("mamba_conv", xs.data_ptr(), bb.data_ptr(), cc.data_ptr(), conv_w.data_ptr(),
                  conv_b.data_ptr(), out.data_ptr(), tail.data_ptr(), nb, t, di, n, width,
                  strides)
    LAUNCHES["mamba_conv"] += 1
    return out, tail


@mamba_conv_op.register_fake
def _(xs, bb, cc, conv_w, conv_b):
    nb, t, di = xs.shape
    ch = di + 2 * bb.shape[2]
    return xs.new_empty((nb, t, ch)), xs.new_empty((nb, conv_w.shape[0] - 1, ch))


@torch.library.custom_op("repro_torch::mamba_gate_norm", mutates_args=())
def mamba_gate_norm_op(y: torch.Tensor, x: torch.Tensor, z: torch.Tensor, d_skip: torch.Tensor,
                       norm: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`mamba_gate_norm` on checked operands."""
    nb, t, h, p = x.shape
    out = torch.empty((nb, t, h * p), dtype=torch.bfloat16, device=x.device)
    strides = (ctypes.c_longlong * 6)(y.stride(0), y.stride(1), x.stride(0), x.stride(1),
                                      z.stride(0), z.stride(1))
    _build.launch("mamba_gate_norm", y.data_ptr(), x.data_ptr(), z.data_ptr(), d_skip.data_ptr(),
                  norm.data_ptr(), out.data_ptr(), nb, t, h * p, p, ctypes.c_float(eps), strides)
    LAUNCHES["mamba_gate_norm"] += 1
    return out


@mamba_gate_norm_op.register_fake
def _(y, x, z, d_skip, norm, eps):
    nb, t, h, p = x.shape
    return z.new_empty((nb, t, h * p))
