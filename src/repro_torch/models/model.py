"""Model assembly: the Mamba-2 stack (family ``ssm``) as an ``nn.Module``.

The counterpart of ``MambaLM`` in the JAX package's ``models/model.py`` for
the attention-free family.  Parameters are stacked over layers as the
reference's are (``block`` leaves of shape (L, ...), ``ln`` (L, D)), so
``convert.py`` carries the reference's init across leaf by leaf, and the
layer loop indexes them.

API:
  prefill(tokens (B,T)) -> (last logits (B,1,V), cache)
  decode_step(cache, tokens (B,1)) -> (logits (B,1,V), cache)
  cache = {"conv": (L,B,W-1,C), "ssd": (L,B,H,N,P) float32, "len": int},
  the shapes of the reference's ``init_cache``.  ``decode_step`` writes the
  new states into the cache's tensors in place (the reference returns new
  arrays) so a step does not copy the whole (L,B,H,N,P) state.

The transformer, hybrid and encoder-decoder families are not ported yet:
``build_model`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.raid import check_device
from repro_torch.models import mamba2 as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of, normal_init, rmsnorm

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")


class MambaLM(nn.Module):
    """Mamba-2 language model, randomly initialised from ``generator``."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(f"MambaLM in the port runs family 'ssm' only, "
                                      f"not {cfg.family!r} (see ROADMAP.md)")
        dev = check_device(device)
        g = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        dt = dtype_of(cfg)
        d, v, n_layers = cfg.d_model, cfg.vocab, cfg.n_layers

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.block = nn.ParameterDict({
            k: param(w) for k, w in
            M.init_mamba_block(g, cfg, device=dev, lead=(n_layers,)).items()
        })
        self.ln = param(torch.ones((n_layers, d), dtype=dt, device=dev))
        self.embed = param(normal_init(g, (v, d), 1.0, dt, dev))
        self.final_norm = param(torch.ones((d,), dtype=dt, device=dev))
        self.lm_head = param(normal_init(g, (d, v), d ** -0.5, dt, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _layers(self):
        """Per-layer parameter dicts (views into the stacked leaves)."""
        per = {k: w.unbind(0) for k, w in self.block.items()}
        return [{k: per[k][i] for k in per} for i in range(self.cfg.n_layers)]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens (B,T) -> (logits of the last position (B,1,V), cache)."""
        cfg = self.cfg
        x = self.embed[tokens]
        convs, ssds = [], []
        for i, p in enumerate(self._layers()):
            out, (conv, ssd) = M.mamba_apply(p, rmsnorm(x, self.ln[i], cfg.norm_eps), cfg)
            x = x + out
            convs.append(conv)
            ssds.append(ssd)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        logits = x[:, -1:, :] @ self.lm_head
        return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds),
                        "len": tokens.shape[1]}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B,1) -> (logits (B,1,V), cache with its states advanced in
        place and ``len`` one longer)."""
        cfg = self.cfg
        x = self.embed[tokens]
        conv, ssd = cache["conv"], cache["ssd"]
        for i, p in enumerate(self._layers()):
            z = rmsnorm(x, self.ln[i], cfg.norm_eps)
            out, (c2, s2) = M.mamba_apply(p, z, cfg, state=(conv[i], ssd[i]))
            x = x + out
            conv[i] = c2
            ssd[i] = s2
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        logits = x @ self.lm_head
        cache["len"] += 1
        return logits, cache


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda",
                generator: torch.Generator | None = None) -> nn.Module:
    """The port's model for ``cfg`` on ``device`` (``cuda`` unless the caller
    asks for ``cpu``; ``cuda`` without a GPU raises)."""
    dev = check_device(device)
    if cfg.family == "ssm":
        return MambaLM(cfg, device=dev, generator=generator)
    if cfg.family in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch yet; "
            "ROADMAP.md Queue 1 lists what is left")
    raise ValueError(f"unknown family {cfg.family!r}")
