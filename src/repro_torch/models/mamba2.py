"""Mamba-2 (SSD) block on torch tensors.

The counterpart of the JAX package's ``models/mamba2.py``, with one change
of route: ``ssd_chunked`` keeps the reference's signature and padding but
hands the scan to ``kernels.ops.ssd_chunk_scan``, so prefill on the card runs
the hand-written CUDA SSD kernel (a CPU tensor runs its plain sequential
version).  It is differentiable end to end: the scan is the operator
``repro_torch::ssd_scan``, whose backward is the CUDA kernel ``ssd_scan_bwd``
on the card, and the dt = 0 padding of a ragged T and the slice back to T
pass their gradients through.  On DTensors (a device mesh) the scan and the
causal conv run on each rank's shards (``local_map``).  Decode is the
single-step recurrence in plain torch, as in the reference.  B/C
projections are shared across heads (ngroups=1).

Block structure (Mamba-2 paper):
  in-proj -> [z | x | B | C | dt] -> causal conv(x,B,C) -> silu
          -> SSD(x, dt, A, B, C) + D*x -> gated RMSNorm(z) -> out-proj

Weights keep the reference's (in, out) layout: a projection is ``x @ w``.
"""
from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of, merge_heads, normal_init, rmsnorm, split_heads
from repro_torch.obs import spans


def init_mamba_block(generator: torch.Generator, cfg: ModelConfig, *,
                     device: torch.device | str | None = None,
                     lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    """One block's parameters, each with the leading dims ``lead`` (the
    model passes ``(n_layers,)`` to draw the stacked layers at once)."""
    d, di = cfg.d_model, cfg.d_inner
    h, n, cw = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_conv
    dt = dtype_of(cfg)
    dev = device or generator.device
    sc = d ** -0.5

    def nrm(shape, scale, dtype):
        return normal_init(generator, (*lead, *shape), scale, dtype, dev)

    def full(shape, value, dtype):
        return torch.full((*lead, *shape), value, dtype=dtype, device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev))
    return {
        "w_z": nrm((d, di), sc, dt),
        "w_x": nrm((d, di), sc, dt),
        "w_b": nrm((d, n), sc, dt),
        "w_c": nrm((d, n), sc, dt),
        "w_dt": nrm((d, h), sc, torch.float32),
        "dt_bias": full((h,), 0.0, torch.float32),
        "a_log": a_log.expand(*lead, h).clone(),
        "d_skip": full((h,), 1.0, torch.float32),
        "conv_w": nrm((cw, di + 2 * n), 0.2, dt),
        "conv_b": full((di + 2 * n,), 0.0, dt),
        "norm": full((di,), 1.0, dt),
        "w_out": nrm((di, d), di ** -0.5, dt),
    }


def mamba_block_axes() -> dict:
    """The logical axes of :func:`init_mamba_block`'s leaves (the reference's)."""
    return {
        "w_z": ("embed", "ssm_inner"), "w_x": ("embed", "ssm_inner"),
        "w_b": ("embed", None), "w_c": ("embed", None), "w_dt": ("embed", "ssm_heads"),
        "dt_bias": ("ssm_heads",), "a_log": ("ssm_heads",), "d_skip": ("ssm_heads",),
        "conv_w": (None, "ssm_conv_ch"), "conv_b": ("ssm_conv_ch",),
        "norm": ("ssm_inner",), "w_out": ("ssm_inner", "embed"),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, summed tap by tap in float32.
    x: (B,T,C), w: (W,C).  On DTensors it runs on each rank's batch rows
    and channels (``local_map``): the taps slice time, which no rank
    splits, and channels never mix."""
    mesh = _dtensor_mesh(x)
    if mesh is not None:
        return _conv_per_shard(mesh, x.shape)(x, w, b)
    width, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, :t, :].float() * w[0].float()
    for j in range(1, width):  # static tiny loop (W=4)
        out = out + xp[:, j : j + t, :].float() * w[j].float()
    return (out + b.float()).to(x.dtype)


def ssd_chunked(x, dt, a, b, c, h0=None, *, chunk: int):
    """Chunked SSD scan.

    x: (B,T,H,P) values; dt: (B,T,H) (>0); a: (H,) (<0);
    b, c: (B,T,N) shared across heads.  Returns (y (B,T,H,P) in x's dtype,
    h (B,H,N,P) float32).  A ragged T is padded with dt=0 steps, which are
    exact identities (decay exp(0)=1, no input)."""
    out_dtype = x.dtype
    t = x.shape[1]
    q = min(chunk, t)
    pad = (-t) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    args = (x, dt.float(), a.float(), b, c) + (() if h0 is None else (h0.float().contiguous(),))

    def scan(*operands):
        return ops.ssd_chunk_scan(*operands, chunk=q)

    mesh = _dtensor_mesh(x)
    if mesh is not None:
        scan = _per_shard(scan, mesh, tuple(x.shape), h0 is not None)
    y, h_final = scan(*args)
    return y[:, :t].to(out_dtype), h_final


def _dtensor_mesh(x):
    """The device mesh of a DTensor, None for a plain tensor."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return x.device_mesh if dtensor is not None and isinstance(x, dtensor.DTensor) else None


def _conv_per_shard(mesh, x_shape):
    """:func:`causal_conv` by ``local_map``: x (B, T, C) over the data axes
    by batch rows where they divide and over "model" by channels where they
    divide, w (W, C) and b (C,) by channels alike (their gradients partial
    over the split data axes)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    nb, _, ch = x_shape
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data = [a for a in ("pod", "data") if a in sizes]
    batch_split = nb % math.prod(sizes[a] for a in data) == 0
    px, pw, pb, gw = [], [], [], []
    for dim in mesh.mesh_dim_names:
        if dim in data and batch_split:
            px.append(Shard(0))
            pw.append(Replicate())
            pb.append(Replicate())
            gw.append(Partial())
        elif dim == "model" and ch % sizes[dim] == 0:
            px.append(Shard(2))
            pw.append(Shard(1))
            pb.append(Shard(0))
            gw.append(Shard(1))
        else:
            for pl in (px, pw, pb, gw):
                pl.append(Replicate())
    gb = [Shard(0) if p == Shard(1) else p for p in gw]
    return local_map(causal_conv, out_placements=px, in_placements=(px, pw, pb),
                     in_grad_placements=(px, gw, gb), device_mesh=mesh,
                     redistribute_inputs=True)


class _DenseGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient dense: the plain
    scan's gradients of the head layout come out of permutes, and a
    DTensor's views of a shard's gradient need dense strides."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _per_shard(scan, mesh, x_shape, with_h0: bool):
    """``scan`` on each rank's shards (``local_map``): batch rows over the
    data axes and heads over "model" where they divide, b and c replicated
    over "model" (shared by the heads), ``a`` over the data axes.  An input
    replicated over a mesh dim whose work is split there gets a partial
    (summed) gradient; the outputs come back sharded alike."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    nb, _, nh, _ = x_shape
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data = [a for a in ("pod", "data") if a in sizes]
    batch_split = nb % math.prod(sizes[a] for a in data) == 0
    names = ("x", "dt", "a", "b", "c", "h0", "y", "h")
    place: dict = {k: [] for k in names}
    grad: dict = {k: [] for k in names[:6]}
    for dim in mesh.mesh_dim_names:
        if dim in data and batch_split:
            dims = dict(x=0, dt=0, a=None, b=0, c=0, h0=0, y=0, h=0)
        elif dim == "model" and nh % sizes[dim] == 0:
            dims = dict(x=2, dt=2, a=0, b=None, c=None, h0=1, y=2, h=1)
        else:
            dims = dict.fromkeys(names)
        split = any(d is not None for d in dims.values())
        for k in names:
            place[k].append(Replicate() if dims[k] is None else Shard(dims[k]))
            if k in grad:
                grad[k].append(Shard(dims[k]) if dims[k] is not None
                               else Partial() if split else Replicate())
    ins = names[:6] if with_h0 else names[:5]

    def local(*operands):
        return scan(*(_DenseGrad.apply(v) for v in operands))

    return local_map(local, out_placements=(place["y"], place["h"]),
                     in_placements=tuple(place[k] for k in ins),
                     in_grad_placements=tuple(grad[k] for k in ins),
                     device_mesh=mesh, redistribute_inputs=True)


def mamba_apply(p, x, cfg: ModelConfig, *, state=None):
    """Mamba-2 block.  Prefill: state=None.  Decode: state is
    (conv_state (B,W-1,C), ssd_state (B,H,N,P)) and x is (B,1,D).
    Returns (out, (conv_state, ssd_state))."""
    with spans.span(spans.MAMBA):
        b_sz, t, _ = x.shape
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
        pdim = cfg.ssm_head_dim
        z = x @ p["w_z"]
        xs = x @ p["w_x"]
        bb = x @ p["w_b"]
        cc = x @ p["w_c"]
        dt = F.softplus(x.float() @ p["w_dt"] + p["dt_bias"])
        a = -torch.exp(p["a_log"])

        conv_in = torch.cat([xs, bb.to(xs.dtype), cc.to(xs.dtype)], -1)
        if state is None:
            conv_out = causal_conv(conv_in, p["conv_w"], p["conv_b"])
        else:
            conv_state, ssd_state = state
            window = torch.cat([conv_state, conv_in], dim=1)  # (B,W,C)
            conv_out = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float())
            conv_out = (conv_out[:, None, :] + p["conv_b"].float()).to(conv_in.dtype)
            new_conv_state = window[:, 1:, :]
        conv_out = F.silu(conv_out)
        xs2 = split_heads(conv_out[..., :di], h, pdim)  # a strided view
        bb2 = conv_out[..., di : di + n]
        cc2 = conv_out[..., di + n :]

        if state is None:
            y, final_state = ssd_chunked(xs2, dt, a, bb2, cc2, chunk=cfg.ssm_chunk)
        else:
            decay = torch.exp(dt[:, 0, :] * a)  # (B,H)
            upd = torch.einsum("bn,bh,bhv->bhnv", bb2[:, 0].float(), dt[:, 0, :],
                               xs2[:, 0].float())
            final_state = decay[:, :, None, None] * ssd_state + upd
            y = torch.einsum("bn,bhnv->bhv", cc2[:, 0].float(), final_state)
            y = y[:, None].to(x.dtype).reshape(b_sz, 1, h, pdim)

        y = y + xs2 * p["d_skip"].to(y.dtype).reshape(1, 1, h, 1)
        y = merge_heads(y)
        y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
        out = y @ p["w_out"]
        if state is None:
            # prefill returns the final SSD state and the conv tail for decode
            w1 = cfg.ssm_conv - 1
            tail = conv_in[:, -w1:, :] if t >= w1 else F.pad(conv_in, (0, 0, w1 - t, 0))
            return out, (tail, final_state)
        return out, (new_conv_state, final_state)
