"""The control: the reference computed one precision below the configuration's.

The configurations state bfloat16 products; the next precision below, the
one a later change would be tempted by, is fp8.  ``fp8_round`` rounds a
tensor to float8 e4m3 with one scale per tensor (its largest magnitude
mapped to e4m3's largest finite value, 448) and back to float32; its
gradient passes straight through, so the control also trains.  The
reference applies it to both operands of every low-precision projection
(``mamba_lm.py``'s ``quant``).
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x)
