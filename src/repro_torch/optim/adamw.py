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
and leaves its inputs as they are.

On a device mesh the leaves are DTensors: ``state_specs`` gives the state
the reference's ZeRO-1 layout (each leaf's parameter spec, plus its first
free divisible dim over the data axes), and ``apply_updates`` brings each
gradient to its state's layout first (a reduce-scatter or a slice), so the
moments and the master weights update shard by shard, then gathers the new
parameter back to the parameter's layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint import _tree
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import tree_map
from repro_torch.obs import spans


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
    with spans.span(spans.ADAMW):
        flat_p, tdef = _tree.flatten_with_path(params)
        flat_g = [_placed_like(g, mw) for g, mw in zip(_tree.leaves(grads),
                                                        _tree.leaves(state["master"]))]
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
            return _placed_like(new_master.to(p.dtype), p), new_master, m2, v2

        outs = [upd(p, *t) for (_, p), t in zip(
            flat_p, zip(flat_g, *(_tree.leaves(state[k]) for k in ("master", "m", "v"))))]
        new_params = _tree.unflatten(tdef, [o[0] for o in outs])
        new_state = {"step": step, **{k: _tree.unflatten(tdef, [o[i] for o in outs])
                                      for i, k in enumerate(("master", "m", "v"), 1)}}
        return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


def _placed_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to ``like``'s placements when both are DTensors
    that differ; ``x`` otherwise."""
    if getattr(x, "placements", None) is None or tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def state_specs(param_spec_tree: dict, param_shapes: dict, mesh, *, zero1: bool = True) -> dict:
    """Optimizer-state specs: inherit the param spec, then ZeRO-1 shard the
    first unsharded divisible dim over the data axes (the reference's
    rule)."""
    dp = sh.batch_axes(mesh)
    sizes = sh.mesh_sizes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]

    def one(spec, shape_leaf):
        shape = tuple(shape_leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if zero1 and dp and not any(
            (p == dp or p in dp or (isinstance(p, tuple) and set(dp) & set(p)))
            for p in parts if p is not None
        ):
            for i, (dim, p) in enumerate(zip(shape, parts)):
                if p is None and dim % dp_size == 0 and dim >= dp_size:
                    parts[i] = dp if len(dp) > 1 else dp[0]
                    break
        return sh.P(*parts)

    leaf_spec = tree_map(one, param_spec_tree, param_shapes)
    return {"step": sh.P(), "master": leaf_spec, "m": leaf_spec, "v": leaf_spec}
