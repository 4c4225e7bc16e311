"""AdamW with f32 master weights, as plain functions on tensor trees.

The counterpart of the JAX package's ``optim/adamw.py``.  The state per
parameter is an f32 master copy and the first and second moments; the
step is the reference's, not ``torch.optim.AdamW``'s (which applies the
decay and the bias correction elsewhere and keeps no master copy):

* a global-norm clip, the squares summed leaf by leaf in the reference's
  leaf order (sorted keys, ``checkpoint/_tree.py``);
* the warm-up learning rate ``lr * min(1, (step + 1) / warmup_steps)``;
* ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, the bias
  corrections ``1 - b^step``, and decay on every leaf:
  ``mw - lr (mhat / (sqrt(vhat) + eps) + wd mw)``;
* a cast of the new master back to the parameter's dtype.

Trees are nested dicts of tensors.  The state is ``{"step", "master", "m",
"v"}`` (and ``"residual"`` with gradient compression, ``train/steps.py``),
each tree under the parameters' paths, so a ``{"params", "opt"}`` state
flattens to the reference's names.  ``apply_updates`` returns new tensors
and leaves its inputs as they are.  ZeRO-1 sharding (``state_specs``) needs
a device mesh and waits for the sharding slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint import _tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    compression: str = "none"  # none | int8 | topk


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def init_state(params: dict) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    dev = _tree.leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The warm-up learning rate at ``step`` (an int32 tensor), f32."""
    warm = torch.clamp((step + 1).to(torch.float32) / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step; returns (new_params, new_state, metrics) with
    metrics ``grad_norm`` and ``lr`` (0-d f32 tensors)."""
    flat_p, tdef = _tree.flatten_with_path(params)
    flat_g = _tree.leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in flat_g))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    lr = lr_at(cfg, state["step"])
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    def upd(p, g, mw, m, v):
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m2 / b1c
        vhat = v2 / b2c
        new_master = mw - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * mw)
        return new_master.to(p.dtype), new_master, m2, v2

    outs = [upd(p, *t) for (_, p), t in zip(
        flat_p, zip(flat_g, *(_tree.leaves(state[k]) for k in ("master", "m", "v"))))]
    new_params = _tree.unflatten(tdef, [o[0] for o in outs])
    new_state = {"step": step, **{k: _tree.unflatten(tdef, [o[i] for o in outs])
                                  for i, k in enumerate(("master", "m", "v"), 1)}}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
