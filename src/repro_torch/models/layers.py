"""Model building blocks the Mamba-2 path needs: the compute dtype, the
normal initializer and RMSNorm.

The counterparts of ``dtype_of``, ``normal_init`` and ``rmsnorm`` in the JAX
package's ``models/layers.py``.  Attention, the MLPs, MoE and the sharding
helpers are not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def normal_init(generator: torch.Generator, shape, scale: float, dtype: torch.dtype,
                device: torch.device | str | None = None) -> torch.Tensor:
    """``scale`` * N(0, 1), drawn in float32 on the generator's device, then
    cast to ``dtype`` and moved to ``device`` (default: the generator's)."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (scale * w).to(device=device or generator.device, dtype=dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast back to ``x.dtype``, then scale (the
    reference's cast order)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale
