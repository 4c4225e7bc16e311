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

``load_jax_opt_state`` and ``params_from_jax`` carry a reference training
state (``{"params", "opt"}``, numpy leaves, e.g. one restored mid-run) into
the port's trees of tensors (``train/steps.py``, ``optim/adamw.py``), so
both packages can train on from one state.
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


def _leaf(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy leaf of the reference as a tensor of ``dtype`` (through f32
    for floats, exact for bf16 and f32)."""
    arr = np.asarray(arr)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(arr.astype(np.int64)).to(device=device, dtype=dtype)
    return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=dtype)


def load_jax_opt_state(params: dict, tree: dict) -> dict:
    """The reference's AdamW state (``{"step", "master", "m", "v"}`` and
    ``"residual"`` with compression, numpy leaves) as the port's
    (``optim/adamw.py``): ``step`` an int32 0-d tensor, every other leaf
    f32, on the device of ``params`` (the port's parameter tree, whose
    paths every state tree must have)."""
    names = set(_flatten(params))
    dev = next(iter(_flatten(params).values())).device
    out = {"step": _leaf(tree["step"], torch.int32, dev)}
    for key, sub in tree.items():
        if key == "step":
            continue
        flat = _flatten(sub)
        if set(flat) != names:
            raise KeyError(f"optimizer state {key!r} and the parameters differ: "
                           f"{sorted(set(flat) ^ names)}")
        out[key] = _unflatten({k: _leaf(v, torch.float32, dev) for k, v in flat.items()})
    return out


def params_from_jax(params: dict, tree: dict) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's, each leaf
    in the dtype and on the device of the same path of ``params``."""
    like = _flatten(params)
    flat = _flatten(tree)
    if set(flat) != set(like):
        raise KeyError(f"parameter trees differ: {sorted(set(flat) ^ set(like))}")
    return _unflatten({k: _leaf(v, like[k].dtype, like[k].device) for k, v in flat.items()})


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for name, val in flat.items():
        node = out
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return out
