"""Carry the JAX package's ``MambaLM`` parameters into the port's.

The reference's ``MambaLM.init`` tree, turned into numpy leaves, is::

    {"embed": (V, D), "lm_head": (D, V), "final_norm": (D,),
     "layers": {"block": {"w_z": (L, D, Di), ...}, "ln": (L, D)}}

Each leaf is copied into the port parameter of the same name and shape.
Weights keep the reference's (in, out) layout -- the port computes
``x @ w`` where the reference writes ``einsum("btd,de->bte", x, w)`` -- so
nothing is transposed.  Leaves pass through float32 on the way, which is
exact for bf16 and f32 weights.  This module takes numpy only; the tests
produce the tree from the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import MambaLM


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "/"))
        else:
            out[name] = val
    return out


def mamba_param_names(model: MambaLM) -> dict[str, torch.nn.Parameter]:
    """The port's parameters under the reference's tree paths."""
    names = {"embed": model.embed, "lm_head": model.lm_head,
             "final_norm": model.final_norm, "layers/ln": model.ln}
    names.update({f"layers/block/{k}": w for k, w in model.block.items()})
    return names


def load_jax_params(model: MambaLM, tree: dict) -> MambaLM:
    """Copy the reference's parameter tree (numpy leaves) into ``model``.

    Every leaf must have a port parameter of the same path and shape, and
    every port parameter a leaf; anything else raises."""
    flat = _flatten(tree)
    params = mamba_param_names(model)
    if set(flat) != set(params):
        raise KeyError(f"parameter trees differ: only in the reference "
                       f"{sorted(set(flat) - set(params))}, only in the port "
                       f"{sorted(set(params) - set(flat))}")
    for name, param in params.items():
        arr = np.asarray(flat[name]).astype(np.float32)
        if arr.shape != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape}, port {tuple(param.shape)}")
        param.data.copy_(torch.from_numpy(arr).to(param.dtype))
    return model
