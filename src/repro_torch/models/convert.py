"""Carry the JAX package's model parameters into the port's, for every family.

The reference's ``init`` tree, turned into numpy leaves, is a nested dict::

    {"embed": (V, D), "final_norm": (D,), "lm_head": (D, V),
     "layers": {"attn": {"wq": (L, D, H*HD), ...}, "mlp": {...}, "ln1": (L, D), ...}}

(``layers/block`` and ``shared`` for the Mamba-2 families, ``enc_layers`` /
``dec_layers`` for the encoder-decoder).  Each leaf is copied into the port
parameter of the same path (``layers/attn/wq`` is ``layers.attn.wq``) and
shape.  Weights keep the reference's (in, out) layout -- the port computes
``x @ w`` where the reference writes ``einsum("btd,de->bte", x, w)`` -- so
nothing is transposed.  Leaves pass through float32 on the way, which is
exact for bf16 and f32 weights, and land in the port parameter's dtype
(the MoE router stays float32 in a bf16 model, as the reference's does).
This module takes numpy only; the tests produce the tree from the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "/"))
        else:
            out[name] = val
    return out


def param_names(model: nn.Module) -> dict[str, nn.Parameter]:
    """The port's parameters under the reference's tree paths."""
    return {name.replace(".", "/"): p for name, p in model.named_parameters()}


def load_jax_params(model: nn.Module, tree: dict) -> nn.Module:
    """Copy the reference's parameter tree (numpy leaves) into ``model``.

    Every leaf must have a port parameter of the same path and shape, and
    every port parameter a leaf; anything else raises."""
    flat = _flatten(tree)
    params = param_names(model)
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
