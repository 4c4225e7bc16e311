"""AdamW with float32 master weights, as the optimizer under test states it.

The update, leaf by leaf (``optim/adamw.py``'s docstring in the port):

  g     <- g * min(1, clip / (||g||_global + 1e-9))
  lr    =  lr0 * min(1, (step + 1) / warmup)
  m     <- b1 m + (1 - b1) g;   v <- b2 v + (1 - b2) g^2
  w     <- w - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd w)

with t = step + 1 and weight decay on every leaf.  Everything is float32;
the global norm sums the leaves in sorted name order.
"""
from __future__ import annotations

import math

import torch


def init(master: dict) -> dict:
    return {"step": 0,
            "m": {k: torch.zeros_like(v) for k, v in master.items()},
            "v": {k: torch.zeros_like(v) for k, v in master.items()}}


@torch.no_grad()
def step(opt: dict, master: dict, grads: dict, state: dict) -> float:
    """One update of ``master`` (float32 leaves, in place) from ``grads``;
    ``state`` holds the moments and the step count.  Returns the global
    gradient norm before clipping."""
    names = sorted(master)
    gnorm = math.sqrt(sum(float(grads[k].double().pow(2).sum()) for k in names))
    scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
    lr = opt["lr"] * min(1.0, (state["step"] + 1) / opt["warmup_steps"])
    t = state["step"] + 1
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** t, 1 - b2 ** t
    for k in names:
        g = grads[k] * scale
        m, v = state["m"][k], state["v"][k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        w = master[k]
        w.sub_(lr * ((m / b1c) / (torch.sqrt(v / b2c) + opt["eps"]) + opt["weight_decay"] * w))
    state["step"] = t
    return gnorm
