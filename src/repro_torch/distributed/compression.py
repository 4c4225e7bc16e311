"""Gradient compression with error feedback.

The counterpart of the JAX package's ``distributed/compression.py``.  Two
compressors, each applied to ``g + r`` with the error ``r' = (g + r) - c``
carried in the optimizer state (``"residual"``):

* ``int8``: symmetric per-tensor quantize-dequantize, rounding half to even
  (``torch.round``, as ``jnp.round``);
* ``topk``: keep the entries with ``|g| >= mean + (z - 1) std`` of ``|g|``
  (population std, as ``jnp.std``), z from rho by a Gaussian tail
  approximation: O(n), no sort.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint import _tree


def compress_int8(g: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize to int8 (symmetric, per tensor)."""
    gf = g.to(torch.float32)
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale).to(g.dtype)


def compress_topk(g: torch.Tensor, rho: float = 0.05) -> torch.Tensor:
    """Magnitude sparsification keeping ~rho of the entries."""
    gf = g.to(torch.float32)
    a = gf.abs()
    mu = a.mean()
    sd = torch.std(a, correction=0) + 1e-12
    z = torch.sqrt(torch.clamp(-2.0 * torch.log(torch.tensor(rho, device=g.device)), min=0.0))
    thr = mu + (z - 1.0) * sd
    return torch.where(a >= thr, gf, 0.0).to(g.dtype)


def apply_compression(grads: dict, residual: dict, kind: str):
    """Error-feedback compression: (compress(g + r), (g + r) - c)."""
    if kind == "none":
        return grads, residual
    fn = {"int8": compress_int8, "topk": compress_topk}[kind]

    def one(g, r):
        full = g.to(torch.float32) + r
        c = fn(full)
        return c.to(g.dtype), full - c.to(torch.float32)

    flat_g, tdef = _tree.flatten_with_path(grads)
    outs = [one(g, r) for (_, g), r in zip(flat_g, _tree.leaves(residual))]
    return (_tree.unflatten(tdef, [o[0] for o in outs]),
            _tree.unflatten(tdef, [o[1] for o in outs]))


def init_residual(params: dict) -> dict:
    from repro_torch.optim.adamw import tree_map

    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
