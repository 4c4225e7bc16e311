"""Mamba-2 (SSD) block on torch tensors.

The counterpart of the JAX package's ``models/mamba2.py``, with one change
of route: ``ssd_chunked`` keeps the reference's signature and padding but
hands the scan to ``kernels.ops.ssd_chunk_scan``, so prefill on the card runs
the hand-written CUDA SSD kernel (a CPU tensor runs its plain sequential
version).  It is differentiable end to end: under autograd the scan runs as
``SSDScanFn``, whose backward is the CUDA kernel ``ssd_scan_bwd`` on the
card, and the dt = 0 padding of a ragged T and the slice back to T pass
their gradients through.  Decode is the single-step recurrence in plain torch, as in the
reference.  B/C projections are shared across heads (ngroups=1).

Block structure (Mamba-2 paper):
  in-proj -> [z | x | B | C | dt] -> causal conv(x,B,C) -> silu
          -> SSD(x, dt, A, B, C) + D*x -> gated RMSNorm(z) -> out-proj

Weights keep the reference's (in, out) layout: a projection is ``x @ w``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of, normal_init, rmsnorm


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


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, summed tap by tap in float32.
    x: (B,T,C), w: (W,C)."""
    width, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(width):  # static tiny loop (W=4)
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
    y, h_final = ops.ssd_chunk_scan(
        x, dt.float(), a.float(), b, c,
        None if h0 is None else h0.float().contiguous(), chunk=q,
    )
    return y[:, :t].to(out_dtype), h_final


def mamba_apply(p, x, cfg: ModelConfig, *, state=None):
    """Mamba-2 block.  Prefill: state=None.  Decode: state is
    (conv_state (B,W-1,C), ssd_state (B,H,N,P)) and x is (B,1,D).
    Returns (out, (conv_state, ssd_state))."""
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
    xs2 = conv_out[..., :di].reshape(b_sz, t, h, pdim)  # a strided view
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
    y = y.reshape(b_sz, t, di)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if state is None:
        # prefill returns the final SSD state and the conv tail for decode
        w1 = cfg.ssm_conv - 1
        tail = conv_in[:, -w1:, :] if t >= w1 else F.pad(conv_in, (0, 0, w1 - t, 0))
        return out, (tail, final_state)
    return out, (new_conv_state, final_state)
