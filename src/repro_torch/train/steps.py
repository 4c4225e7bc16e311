"""Train / serve step functions.

The counterpart of the JAX package's ``train/steps.py``:

``make_train_step``   -> (params, opt_state, batch) -> (params, opt_state, metrics)
``make_prefill_step`` -> (params, batch) -> (logits, cache)
``make_decode_step``  -> (params, cache, tokens) -> (logits, cache)

The steps are functional, as the reference's are: ``params`` is a nested
dict of tensors under the reference's tree paths (``params_of(model)`` gives
the model's own), and the step runs the model on it through
``torch.func.functional_call``, so the module's registered parameters are
never written.  The train step takes the loss's gradients with
``torch.autograd.grad`` on detached copies of the leaves that require grad,
(``value_and_grad``), optionally compresses them (error feedback in ``opt_state["residual"]``),
and returns the new parameters and optimizer state from
``optim.adamw.apply_updates``; ``metrics`` holds ``loss``, ``grad_norm`` and
``lr`` as 0-d f32 tensors on the parameters' device.  Nothing here
synchronises with the card.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import compression as comp
from repro_torch.models.model import build_model
from repro_torch.obs import spans
from repro_torch.optim import adamw


def _named(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """``{"layers.attn.wq": tensor, ...}`` of a nested dict, as the module
    names its parameters."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_named(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def _nest(flat: dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for name, val in flat.items():
        node = out
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return out


def params_of(model) -> dict:
    """The model's parameters as a nested dict of detached tensors (sharing
    the module's storage), the train state's ``params``."""
    return adamw.tree_map(lambda p: p.detach(), model.tree())


def value_and_grad(model, params: dict, batch: dict):
    """(loss, grads) of ``model.loss`` at ``params``: the loss a 0-d f32
    tensor, the gradients a tree of ``params``' structure and dtypes."""
    named = {k: v.detach().requires_grad_() for k, v in _named(params).items()}
    with torch.enable_grad():
        with spans.span(spans.FORWARD):
            loss = torch.func.functional_call(model, named, ("loss", batch))
        with spans.span(spans.BACKWARD):
            flat = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), _nest(dict(zip(named, flat)))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, device: str | torch.device = "cuda",
                    generator: torch.Generator | None = None, *, model=None):
    """(model, train_step) for ``cfg`` on ``device``; the model holds the
    seeded init (``params_of``); ``model`` reuses a built model of ``cfg``."""
    model = model or build_model(cfg, device=device, generator=generator)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        if opt_cfg.compression != "none":
            grads, new_resid = comp.apply_compression(grads, opt_state["residual"],
                                                      opt_cfg.compression)
        new_params, new_opt, metrics = adamw.apply_updates(opt_cfg, params, grads, opt_state)
        if opt_cfg.compression != "none":
            new_opt["residual"] = new_resid
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return model, train_step


def init_opt_state(model, params: dict, opt_cfg: adamw.AdamWConfig) -> dict:
    st = adamw.init_state(params)
    if opt_cfg.compression != "none":
        st["residual"] = comp.init_residual(params)
    return st


def _prefill_inputs(batch: dict) -> dict:
    return {k: batch[k] for k in ("vis_embeds", "frames") if k in batch}


def make_prefill_step(cfg, device: str | torch.device = "cuda",
                      generator: torch.Generator | None = None, *, model=None):
    """(model, prefill_step); ``model`` reuses a built model of ``cfg``."""
    model = model or build_model(cfg, device=device, generator=generator)

    def prefill_step(params, batch):
        return torch.func.functional_call(
            model, _named(params), ("prefill", batch["tokens"]), _prefill_inputs(batch))

    return model, prefill_step


def make_decode_step(cfg, device: str | torch.device = "cuda",
                     generator: torch.Generator | None = None, *, model=None):
    """(model, decode_step); ``model`` reuses a built model of ``cfg``."""
    model = model or build_model(cfg, device=device, generator=generator)

    def decode_step(params, cache, tokens):
        return torch.func.functional_call(model, _named(params),
                                          ("decode_step", cache, tokens))

    return model, decode_step
