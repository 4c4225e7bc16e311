"""The one rule by which a call takes a CUDA kernel that has no backward:
prefill's attention (``attention.py``) and the Mamba-2 glue
(``mamba_glue.py``).  Each wrapper's ``takes`` applies :func:`forward_only`
to the operands its kernels read, and the model modules only ask ``takes``.
The rule never looks at shapes: operands that pass it go to the wrapper,
which raises for a shape or layout its kernels have no instance for, so a
bf16 prefill on the card never runs the plain version unnoticed.  The SSD
scan is not routed so: it has a backward kernel, and its plain version is a
sequential loop no call on the card should take, so its operands' device
picks its path (``ssd_scan.py``).
"""
from __future__ import annotations

import sys
from collections.abc import Iterable

import torch


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor when nothing
    has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def forward_only(activations: Iterable[torch.Tensor],
                 weights: Iterable[torch.Tensor] = ()) -> bool:
    """Whether a call on these operands may take a CUDA kernel with no
    backward: all of them plain CUDA tensors on one device, the
    ``activations`` bfloat16, and grad disabled or none of them requiring
    grad (``weights`` are the parameters the kernel reads, of any dtype)."""
    acts = tuple(activations)
    ops = (*acts, *weights)
    if any(is_dtensor(v) or not v.is_cuda for v in ops) or len({v.device for v in ops}) > 1:
        return False
    if any(v.dtype != torch.bfloat16 for v in acts):
        return False
    return not (torch.is_grad_enabled() and any(v.requires_grad for v in ops))
