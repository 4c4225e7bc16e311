"""Model assembly: one ``nn.Module`` per architecture family.

The counterparts of the JAX package's ``models/model.py`` serving paths:

  dense / moe / vlm -> ``TransformerLM``: decoder-only transformer (GQA,
                       RoPE, SwiGLU, MoE in every layer when the config has
                       experts, optional projected vision prefix)
  ssm               -> ``MambaLM``: Mamba-2 stack (attention-free)
  hybrid            -> ``MambaLM`` + one shared attention block applied after
                       every ``shared_attn_every``-th layer (zamba2-style)
  hybrid_moe        -> ``HybridMoELM``: a per-layer pattern of Mamba-2 and
                       attention mixers, each layer followed by a MoE with a
                       shared expert (granite-4.0-h-style)
  encdec            -> ``EncDecLM``: whisper backbone, a bidirectional encoder
                       over stub frame embeddings + a causal decoder with
                       cross-attention

Parameters sit under the reference's tree paths (``layers.attn.wq`` for
``params["layers"]["attn"]["wq"]``), stacked over layers as the reference's
are, so ``convert.py`` carries the reference's init across leaf by leaf,
and the layer loops index them.  Weights are drawn from ``generator`` with
the reference's shapes and scales (torch's numbers, not jax's).

API:
  loss(batch) -> scalar f32: mean next-token cross-entropy of ``batch``
    (``tokens``, ``labels`` (B,T), and ``vis_embeds`` for a VLM or
    ``frames`` for an encoder-decoder, as ``data/pipeline.py`` makes them);
    the train step's target (``train/steps.py``), differentiable through
    every layer (the SSD scan through its backward kernel on the card).
    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant) and is recomputed in the backward pass, the reference's
    per-layer ``jax.checkpoint``: it changes memory only, not the numbers;
  forward(method, *args) -> ``getattr(self, method)(*args)``, so that
    ``torch.func.functional_call(model, params, ("loss", batch))`` runs any
    entry point on a parameter tree given by the caller;
and, under ``torch.no_grad``:
  prefill(tokens (B,T), ...) -> (last logits (B,1,V), cache)
  decode_step(cache, tokens (B,1)) -> (logits (B,1,V), cache)
  init_cache(batch, max_len) -> a zeroed cache of the reference's shapes
The caches are the reference's: ``k``/``v`` (L,B,S,KV,HD), ``conv``/``ssd``
for Mamba-2 layers, ``ak``/``av`` (apps,B,S,KV,HD) for the hybrid's shared
block or a layer pattern's attention layers, ``ck``/``cv`` (L,B,enc_len,KV,HD)
for cross-attention, and ``len`` (an int, the valid positions, a vision
prefix included).  ``decode_step``
writes into the cache's tensors in place (the reference returns new
arrays), so a KV cache must already have room for the new position:
``launch/serve.py`` grows it after prefill, as the reference's loop does.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.raid import check_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.config import ModelConfig


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: a dict becomes a submodule, a
    tensor a parameter, each under its key.  The registered parameters stay
    frozen (serving); training runs the model on a tree of tensors that
    require grad, through ``torch.func.functional_call``
    (``train/steps.py``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> dict:
        """The parameters as a nested dict, the shape of the reference's."""
        out: dict = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def per_layer(tree: dict, n: int) -> list[dict]:
    """Per-layer views of a tree of leaves stacked over ``n`` layers."""
    cols = {k: per_layer(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _positions(b: int, t: int, device) -> torch.Tensor:
    return torch.arange(t, device=device).expand(b, t)


def _ones(cfg: ModelConfig, shape, device) -> torch.Tensor:
    return torch.ones(shape, dtype=L.dtype_of(cfg), device=device)


def _ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``labels`` under ``logits``, in f32.  DTensor
    logits whose vocab dim is split over ranks take :func:`_ce_loss_sharded`;
    others compute each rank's tokens with the plain ops (``local_map``)."""
    logits = logits.float()
    if not L.is_dtensor(logits):
        return torch.mean(_token_ce(logits, labels))
    mesh, last = logits.device_mesh, logits.ndim - 1
    if any(L.splits(p, last, logits.ndim) and n > 1
           for p, n in zip(logits.placements, mesh.shape)):
        return _ce_loss_sharded(logits, labels)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    rows = list(labels.placements) if L.is_dtensor(labels) else [Replicate()] * mesh.ndim
    per_token = local_map(_token_ce, out_placements=rows, in_placements=(rows, rows),
                          device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return torch.mean(per_token)


def _token_ce(logits, labels):
    """Each token's cross-entropy: log-sum-exp of its logits less the gold one."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def _ce_loss_sharded(logits, labels):
    """The cross-entropy of DTensor logits, whose vocab dim may be sharded:
    the max, the sum of exponentials and the gold logit (a masked sum, where
    a gather would need every shard) reduce over the vocab shards as
    (B, T) partials, so the logits are never gathered.  The log-sum-exp is
    max + log(sum(exp(x - max))), as ``torch.logsumexp`` computes it."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    vocab = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.device.type), logits.device_mesh,
        [Shard(0) if L.splits(p, logits.ndim - 1, logits.ndim) else Replicate()
         for p in logits.placements], src_data_rank=None)
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = torch.where(vocab == labels.long()[..., None], logits, 0.0).sum(dim=-1)
    return torch.mean(logz - gold)


_META = object()  # meta_model's device: shapes only, past check_device


def _stacked(axes: dict) -> dict:
    """An axes tree with the leading "layers" stacking axis added."""
    return {k: _stacked(v) if isinstance(v, dict) else ("layers", *v) for k, v in axes.items()}


def _setup(cls, cfg: ModelConfig, families: tuple[str, ...], device, generator):
    """The checked device and the generator (seed 0 unless one is given)
    of a model of class ``cls``, which runs ``families``.  For
    :func:`meta_model` (``device`` is ``_META``) the meta device and no
    generator: nothing is drawn."""
    if cfg.family not in families:
        raise ValueError(f"{cls.__name__} runs families {families}, not {cfg.family!r}")
    if device is _META:
        return torch.device("meta"), None
    dev = check_device(device)
    return dev, generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)


class _LM(ParamTree):
    """A model's parameter tree and its config."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, method: str, *args, **kwargs):
        """``getattr(self, method)(*args, **kwargs)``: lets
        ``torch.func.functional_call`` run any entry point."""
        return getattr(self, method)(*args, **kwargs)

    def _remat(self, fn, *args):
        """``fn(*args)``; under ``cfg.remat`` while autograd records, as a
        non-reentrant ``torch.utils.checkpoint`` (recomputed in backward)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _grow_check(self, cache: dict, key: str) -> None:
        if cache["len"] >= cache[key].shape[2]:
            raise ValueError(f"cache {key!r} of {cache[key].shape[2]} positions is full at "
                             f"len {cache['len']}; grow it (launch/serve.py grow_cache)")


# =====================================================================
# decoder-only transformer (dense / moe / vlm)
# =====================================================================

class TransformerLM(_LM):
    """Decoder-only transformer.  A config with experts runs MoE in *every*
    layer and ignores ``moe_every``, as the reference does."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev, g = _setup(type(self), cfg, ("dense", "moe", "vlm"), device, generator)
        d, n, dt = cfg.d_model, cfg.n_layers, L.dtype_of(cfg)
        ffn = L.init_moe if cfg.n_experts else L.init_mlp
        tree = {
            "layers": {
                "attn": L.init_attention(g, cfg, device=dev, lead=(n,)),
                "mlp": ffn(g, cfg, device=dev, lead=(n,)),
                "ln1": _ones(cfg, (n, d), dev), "ln2": _ones(cfg, (n, d), dev),
            },
            "embed": L.normal_init(g, (cfg.vocab, d), 1.0, dt, dev),
            "final_norm": _ones(cfg, (d,), dev),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = L.normal_init(g, (d, cfg.vocab), d ** -0.5, dt, dev)
        if cfg.family == "vlm":
            tree["vis_proj"] = L.normal_init(g, (cfg.vis_embed_dim, d),
                                             cfg.vis_embed_dim ** -0.5, dt, dev)
        super().__init__(cfg, tree)

    def axes(self) -> dict:
        """The logical-axis tree of the parameters (the reference's)."""
        cfg = self.cfg
        ffn = L.moe_axes(cfg) if cfg.n_experts else L.mlp_axes()
        a = {"embed": ("vocab", "embed"),
             "layers": _stacked({"attn": L.attention_axes(cfg), "mlp": ffn,
                                 "ln1": (None,), "ln2": (None,)}),
             "final_norm": (None,)}
        if not cfg.tie_embeddings:
            a["lm_head"] = ("embed", "vocab")
        if cfg.family == "vlm":
            a["vis_proj"] = (None, "embed")
        return a

    def _layer(self, p, x, positions, kv_cache=None, cache_len=None, bf16_reduce=False):
        cfg = self.cfg
        h, kv = L.attention_apply(p["attn"], L.rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                                  positions=positions, kv_cache=kv_cache, cache_len=cache_len)
        x = x + h
        z = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if cfg.n_experts:
            return x + L.moe_apply(p["mlp"], z, cfg), kv
        return x + L.mlp_apply(p["mlp"], z, bf16_reduce), kv

    def _gather(self, p, x):
        """With ``cfg.fsdp_gather`` on a mesh, one layer's weights gathered to
        their TP-only placements and the residual stream pinned to the batch
        layout (the reference's FSDP layer loop); else as they are."""
        if not self.cfg.fsdp_gather:
            return p, x
        axes = L.strip_layer_axis(self.axes()["layers"])
        return L.gather_fsdp_weights(p, axes), L.pin_activation_batch(x)

    def _logits(self, x):
        if self.cfg.tie_embeddings:  # gemma-style scaling keeps tied-head logits O(1)
            return (x @ self.embed.T) * self.cfg.d_model ** -0.5
        return x @ self.lm_head

    def _inputs(self, tokens, vis_embeds):
        """Token embeddings, after the projected vision prefix for a VLM."""
        x = L.embed(self.embed, tokens)
        if vis_embeds is None:
            return x
        if self.cfg.family != "vlm":
            raise ValueError(f"{self.cfg.name}: vis_embeds given to a {self.cfg.family!r} model")
        return torch.cat([vis_embeds.to(x.dtype) @ self.vis_proj, x], dim=1)

    def loss(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        vis = batch.get("vis_embeds") if cfg.family == "vlm" else None
        x = self._inputs(batch["tokens"].long(), vis)
        positions = _positions(*x.shape[:2], x.device)

        def layer(p, h):
            p, h = self._gather(p, h)
            return self._layer(p, h, positions, bf16_reduce=cfg.bf16_reduce)[0]

        for p in per_layer(self.layers.tree(), cfg.n_layers):
            x = self._remat(layer, p, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        if vis is not None:
            x = x[:, vis.shape[1]:, :]
        return _ce_loss(self._logits(x), batch["labels"])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, vis_embeds: torch.Tensor | None = None):
        """tokens (B,T) [and vis_embeds (B,P,vis_embed_dim)] -> (logits of
        the last position (B,1,V), cache); the cache counts the prefix."""
        cfg = self.cfg
        x = self._inputs(tokens, vis_embeds)
        b, t = x.shape[:2]
        positions = _positions(b, t, x.device)
        ks, vs = [], []
        for p in per_layer(self.layers.tree(), cfg.n_layers):
            x, (k, v) = self._layer(*self._gather(p, x), positions, bf16_reduce=cfg.bf16_reduce)
            ks.append(k)
            vs.append(v)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self._logits(x[:, -1:]), {"k": torch.stack(ks), "v": torch.stack(vs), "len": t}

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd())
        z = torch.zeros(shape, dtype=L.dtype_of(cfg), device=self.device)
        return {"k": z, "v": torch.zeros_like(z), "len": 0}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B,1) -> (logits (B,1,V), cache with the new K/V written in
        place and ``len`` one longer)."""
        cfg = self.cfg
        self._grow_check(cache, "k")
        new_len = cache["len"] + 1
        x = L.embed(self.embed, tokens)
        positions = torch.full(tokens.shape, new_len - 1, device=x.device)
        for i, p in enumerate(per_layer(self.layers.tree(), cfg.n_layers)):
            # the reference's decode calls mlp_apply without bf16_reduce
            x, _ = self._layer(p, x, positions, kv_cache=(cache["k"][i], cache["v"][i]),
                               cache_len=new_len)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        cache["len"] = new_len
        return self._logits(x), cache


# =====================================================================
# Mamba-2 stack (ssm) and zamba2-style hybrid
# =====================================================================

class MambaLM(_LM):
    """Mamba-2 language model; for ``hybrid``, with one shared attention +
    MLP block applied after layer ``li`` whenever ``li % shared_attn_every
    == shared_attn_every - 1`` (``n_apps = n_layers // shared_attn_every``
    applications, each with its own KV cache)."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev, g = _setup(type(self), cfg, ("ssm", "hybrid"), device, generator)
        d, n, dt = cfg.d_model, cfg.n_layers, L.dtype_of(cfg)
        tree = {
            "layers": {"block": M.init_mamba_block(g, cfg, device=dev, lead=(n,)),
                       "ln": _ones(cfg, (n, d), dev)},
            "embed": L.normal_init(g, (cfg.vocab, d), 1.0, dt, dev),
            "final_norm": _ones(cfg, (d,), dev),
            "lm_head": L.normal_init(g, (d, cfg.vocab), d ** -0.5, dt, dev),
        }
        if cfg.family == "hybrid":
            tree["shared"] = {
                "attn": L.init_attention(g, cfg, device=dev),
                "mlp": L.init_mlp(g, cfg, device=dev),
                "ln1": _ones(cfg, (d,), dev), "ln2": _ones(cfg, (d,), dev),
            }
        super().__init__(cfg, tree)
        self.hybrid = cfg.family == "hybrid"
        self.n_apps = cfg.n_layers // cfg.shared_attn_every if self.hybrid else 0

    def axes(self) -> dict:
        """The logical-axis tree of the parameters (the reference's)."""
        a = {"embed": ("vocab", "embed"),
             "layers": _stacked({"block": M.mamba_block_axes(), "ln": (None,)}),
             "final_norm": (None,), "lm_head": ("embed", "vocab")}
        if self.hybrid:
            a["shared"] = {"attn": L.attention_axes(self.cfg), "mlp": L.mlp_axes(),
                           "ln1": (None,), "ln2": (None,)}
        return a

    def _shared_attn(self, x, positions, cache=None, cache_len=None):
        cfg = self.cfg
        sp = self.shared.tree()
        h, kv = L.attention_apply(sp["attn"], L.rmsnorm(x, sp["ln1"], cfg.norm_eps), cfg,
                                  positions=positions, kv_cache=cache, cache_len=cache_len)
        x = x + h
        return x + L.mlp_apply(sp["mlp"], L.rmsnorm(x, sp["ln2"], cfg.norm_eps)), kv

    def _is_app(self, li: int) -> bool:
        every = self.cfg.shared_attn_every
        return self.hybrid and li % every == every - 1

    def loss(self, batch: dict) -> torch.Tensor:
        """The remat body is one Mamba-2 layer; the hybrid's shared block
        runs outside it, as in the reference."""
        cfg = self.cfg
        x = L.embed(self.embed, batch["tokens"].long())
        positions = _positions(*x.shape[:2], x.device)

        def layer(p, h):
            return h + M.mamba_apply(p["block"], L.rmsnorm(h, p["ln"], cfg.norm_eps), cfg)[0]

        for i, p in enumerate(per_layer(self.layers.tree(), cfg.n_layers)):
            x = self._remat(layer, p, x)
            if self._is_app(i):
                x, _ = self._shared_attn(x, positions)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return _ce_loss(x @ self.lm_head, batch["labels"])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens (B,T) -> (logits of the last position (B,1,V), cache)."""
        cfg = self.cfg
        x = L.embed(self.embed, tokens)
        b, t = tokens.shape
        positions = _positions(b, t, x.device)
        convs, ssds, aks, avs = [], [], [], []
        for i, p in enumerate(per_layer(self.layers.tree(), cfg.n_layers)):
            out, (conv, ssd) = M.mamba_apply(p["block"], L.rmsnorm(x, p["ln"], cfg.norm_eps),
                                             cfg)
            x = x + out
            convs.append(conv)
            ssds.append(ssd)
            if self._is_app(i):
                x, (ak, av) = self._shared_attn(x, positions)
                aks.append(ak)
                avs.append(av)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        cache = {"conv": torch.stack(convs), "ssd": torch.stack(ssds), "len": t}
        if self.hybrid:
            cache["ak"], cache["av"] = torch.stack(aks), torch.stack(avs)
        return x[:, -1:, :] @ self.lm_head, cache

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        conv, ssd = M.zero_states(cfg, cfg.n_layers, batch_size, self.device)
        cache = {"conv": conv, "ssd": ssd, "len": 0}
        if self.hybrid:
            kv = (self.n_apps, batch_size, max_len, cfg.n_kv_heads, cfg.hd())
            cache["ak"] = torch.zeros(kv, dtype=dt, device=self.device)
            cache["av"] = torch.zeros(kv, dtype=dt, device=self.device)
        return cache

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B,1) -> (logits (B,1,V), cache with its states (and the
        shared block's K/V) advanced in place and ``len`` one longer)."""
        cfg = self.cfg
        if self.hybrid:
            self._grow_check(cache, "ak")
        new_len = cache["len"] + 1
        x = L.embed(self.embed, tokens)
        positions = torch.full(tokens.shape, new_len - 1, device=x.device)
        conv, ssd = cache["conv"], cache["ssd"]
        for i, p in enumerate(per_layer(self.layers.tree(), cfg.n_layers)):
            z = L.rmsnorm(x, p["ln"], cfg.norm_eps)
            out, (conv[i], ssd[i]) = M.mamba_apply(p["block"], z, cfg, state=(conv[i], ssd[i]))
            x = x + out
            if self._is_app(i):
                app = i // cfg.shared_attn_every
                x, _ = self._shared_attn(x, positions, cache=(cache["ak"][app], cache["av"][app]),
                                         cache_len=new_len)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        cache["len"] = new_len
        return x @ self.lm_head, cache


# =====================================================================
# whisper-style encoder-decoder
# =====================================================================

class EncDecLM(_LM):
    """Whisper backbone: the frontend is a stub, so ``prefill`` takes frame
    embeddings (B, enc_len, d_model) beside the tokens."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev, g = _setup(type(self), cfg, ("encdec",), device, generator)
        d, dt = cfg.d_model, L.dtype_of(cfg)
        ne, nd = cfg.enc_layers, cfg.n_layers
        super().__init__(cfg, {
            "enc_layers": {
                "attn": L.init_attention(g, cfg, device=dev, lead=(ne,)),
                "mlp": L.init_mlp(g, cfg, gated=False, device=dev, lead=(ne,)),
                "ln1": _ones(cfg, (ne, d), dev), "ln2": _ones(cfg, (ne, d), dev),
            },
            "dec_layers": {
                "self": L.init_attention(g, cfg, device=dev, lead=(nd,)),
                "cross": L.init_attention(g, cfg, device=dev, lead=(nd,)),
                "mlp": L.init_mlp(g, cfg, gated=False, device=dev, lead=(nd,)),
                "ln1": _ones(cfg, (nd, d), dev), "ln2": _ones(cfg, (nd, d), dev),
                "ln3": _ones(cfg, (nd, d), dev),
            },
            "embed": L.normal_init(g, (cfg.vocab, d), 1.0, dt, dev),
            "enc_norm": _ones(cfg, (d,), dev),
            "final_norm": _ones(cfg, (d,), dev),
        })

    def axes(self) -> dict:
        """The logical-axis tree of the parameters (the reference's)."""
        attn = L.attention_axes(self.cfg)
        mlp = L.mlp_axes(gated=False)
        return {"embed": ("vocab", "embed"),
                "enc_layers": _stacked({"attn": attn, "mlp": mlp, "ln1": (None,),
                                        "ln2": (None,)}),
                "dec_layers": _stacked({"self": attn, "cross": attn, "mlp": mlp,
                                        "ln1": (None,), "ln2": (None,), "ln3": (None,)}),
                "enc_norm": (None,), "final_norm": (None,)}

    def _attend(self, q, k, v):
        """Unmasked GQA attention (the encoder's and cross-attention's): f32
        scores and softmax; the output product stays in ``v.dtype``, as the
        reference's has no preferred type.  q (B,T,KV,G,hd) -> (B,T,H*hd)."""
        b, t, kvh, g, hd = q.shape
        w = torch.softmax(L._gqa_scores_block(q, k, hd ** -0.5), dim=-1)
        out = torch.einsum("bkgts,bskh->btkgh", w.to(v.dtype), v)
        return L.merge_heads(out.reshape(b, t, kvh * g, hd))

    def _heads(self, q):
        """q (B,T,H*hd) or (B,T,H,hd) -> the grouped layout (B,T,KV,G,hd)."""
        if q.ndim == 3:
            q = L.split_heads(q, self.cfg.n_heads, self.cfg.hd())
        return L.group_heads(q, self.cfg.n_kv_heads)

    def _encode(self, frames):
        """frames: (B, T_enc, d_model) stubbed frame embeddings; rope on the
        frames, no mask."""
        cfg = self.cfg
        x = frames.to(L.dtype_of(cfg))
        positions = _positions(*x.shape[:2], x.device)

        def layer(p, x):
            q, k, v = L._qkv(p["attn"], L.rmsnorm(x, p["ln1"], cfg.norm_eps), cfg)
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
            x = x + self._attend(self._heads(q), k, v) @ p["attn"]["wo"]
            return x + L.mlp_apply(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps))

        for p in per_layer(self.enc_layers.tree(), cfg.enc_layers):
            x = self._remat(layer, p, x)
        return L.rmsnorm(x, self.enc_norm, cfg.norm_eps)

    def _cross_kv(self, enc_out):
        """Per-layer cross-attention K/V of the encoder output, stacked
        (L, B, S, KV, HD).  The reference's ``_qkv`` also projects a query
        it drops; only K and V are computed here."""
        cfg = self.cfg
        ks, vs = [], []
        for p in per_layer(self.dec_layers.tree(), cfg.n_layers):
            k, v = enc_out @ p["cross"]["wk"], enc_out @ p["cross"]["wv"]
            if cfg.qkv_bias:
                k, v = k + p["cross"]["bk"], v + p["cross"]["bv"]
            ks.append(L.split_heads(k, cfg.n_kv_heads, cfg.hd()))
            vs.append(L.split_heads(v, cfg.n_kv_heads, cfg.hd()))
        return torch.stack(ks), torch.stack(vs)

    def _dec_layer(self, p, h, positions, cross_k, cross_v, kv_cache=None, cache_len=None):
        cfg = self.cfg
        out, kv = L.attention_apply(p["self"], L.rmsnorm(h, p["ln1"], cfg.norm_eps), cfg,
                                    positions=positions, kv_cache=kv_cache, cache_len=cache_len)
        h = h + out
        # cross attention (keys/values fixed, no mask, no rope)
        q = L.rmsnorm(h, p["ln2"], cfg.norm_eps) @ p["cross"]["wq"]
        if cfg.qkv_bias:
            q = q + p["cross"]["bq"]
        h = h + self._attend(self._heads(q), cross_k, cross_v) @ p["cross"]["wo"]
        return h + L.mlp_apply(p["mlp"], L.rmsnorm(h, p["ln3"], cfg.norm_eps)), kv

    def _logits(self, x):
        return (x @ self.embed.T) * self.cfg.d_model ** -0.5

    def loss(self, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        ck, cv = self._cross_kv(self._encode(batch["frames"]))
        x = L.embed(self.embed, batch["tokens"].long())
        positions = _positions(*x.shape[:2], x.device)

        def layer(p, h, k, v):
            return self._dec_layer(p, h, positions, k, v)[0]

        for i, p in enumerate(per_layer(self.dec_layers.tree(), cfg.n_layers)):
            x = self._remat(layer, p, x, ck[i], cv[i])
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return _ce_loss(self._logits(x), batch["labels"])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor | None = None):
        """tokens (B,T), frames (B, enc_len, d_model) -> (logits of the last
        position (B,1,V), cache)."""
        cfg = self.cfg
        if frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder's prefill needs frames "
                             f"(B, enc_len, d_model); it cannot run from tokens alone")
        ck, cv = self._cross_kv(self._encode(frames))
        x = L.embed(self.embed, tokens)
        b, t = tokens.shape
        positions = _positions(b, t, x.device)
        ks, vs = [], []
        for i, p in enumerate(per_layer(self.dec_layers.tree(), cfg.n_layers)):
            x, (k, v) = self._dec_layer(p, x, positions, ck[i], cv[i])
            ks.append(k)
            vs.append(v)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self._logits(x[:, -1:]), {"k": torch.stack(ks), "v": torch.stack(vs),
                                         "ck": ck, "cv": cv, "len": t}

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.hd())
        ckv = (cfg.n_layers, batch_size, cfg.enc_len, cfg.n_kv_heads, cfg.hd())
        return {"k": torch.zeros(kv, dtype=dt, device=self.device),
                "v": torch.zeros(kv, dtype=dt, device=self.device),
                "ck": torch.zeros(ckv, dtype=dt, device=self.device),
                "cv": torch.zeros(ckv, dtype=dt, device=self.device), "len": 0}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        cfg = self.cfg
        self._grow_check(cache, "k")
        new_len = cache["len"] + 1
        x = L.embed(self.embed, tokens)
        positions = torch.full(tokens.shape, new_len - 1, device=x.device)
        for i, p in enumerate(per_layer(self.dec_layers.tree(), cfg.n_layers)):
            x, _ = self._dec_layer(p, x, positions, cache["ck"][i], cache["cv"][i],
                                   kv_cache=(cache["k"][i], cache["v"][i]), cache_len=new_len)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        cache["len"] = new_len
        return self._logits(x), cache


# =====================================================================
# granite-4.0-h-style hybrid: a layer pattern of mixers, a MoE in every layer
# =====================================================================

class HybridMoELM(_LM):
    """Mamba-2 and attention mixers in the order of ``cfg.layer_types``, each
    layer followed by a MoE (``cfg.top_k`` of ``cfg.n_experts`` with a shared
    expert), as GraniteMoeHybrid computes:

      h = embed_scale * embed[tokens]
      per layer l:  h = h + residual_scale * Mixer_l(rmsnorm(h, ln1_l))
                    h = h + residual_scale * MoE_l(rmsnorm(h, ln2_l))
      logits = logits_scale * rmsnorm(h, final_norm) @ embed^T   (tied)

    The Mamba-2 blocks are stacked over the Mamba layers (``mamba``), the
    attention projections over the attention layers (``attn``), the norms
    and MoEs over every layer (``layers``).  The cache holds both kinds of
    state side by side: ``conv``/``ssd`` per Mamba layer and ``ak``/``av``
    per attention layer."""

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev, g = _setup(type(self), cfg, ("hybrid_moe",), device, generator)
        d, n, dt = cfg.d_model, cfg.n_layers, L.dtype_of(cfg)
        tree = {
            "layers": {"ln1": _ones(cfg, (n, d), dev), "ln2": _ones(cfg, (n, d), dev),
                       "moe": L.init_moe(g, cfg, device=dev, lead=(n,))},
            "mamba": M.init_mamba_block(g, cfg, device=dev, lead=(cfg.layers_of("mamba"),)),
            "attn": L.init_attention(g, cfg, device=dev, lead=(cfg.layers_of("attention"),)),
            "embed": L.normal_init(g, (cfg.vocab, d), 1.0, dt, dev),
            "final_norm": _ones(cfg, (d,), dev),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = L.normal_init(g, (d, cfg.vocab), d ** -0.5, dt, dev)
        super().__init__(cfg, tree)
        self.n_apps = cfg.layers_of("attention")

    def _stacks(self):
        """Per-layer views: [(kind, index within its kind, mixer leaves,
        layer leaves)] in layer order."""
        cfg = self.cfg
        mixers = {"mamba": per_layer(self.mamba.tree(), cfg.layers_of("mamba")),
                  "attention": per_layer(self.attn.tree(), self.n_apps)}
        seen = {"mamba": 0, "attention": 0}
        out = []
        for kind, p in zip(cfg.layer_types, per_layer(self.layers.tree(), cfg.n_layers)):
            out.append((kind, seen[kind], mixers[kind][seen[kind]], p))
            seen[kind] += 1
        return out

    def _layer(self, kind, mp, p, x, positions, state=None, cache_len=None):
        """One layer: (x, the mixer's new state: (conv, ssd) or (k, v))."""
        cfg = self.cfg
        u = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        if kind == "mamba":
            out, new = M.mamba_apply(mp, u, cfg, state=state)
        else:
            out, new = L.attention_apply(mp, u, cfg, positions=positions, kv_cache=state,
                                         cache_len=cache_len)
        x = x + cfg.residual_scale * out
        moe = L.moe_apply(p["moe"], L.rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
        return x + cfg.residual_scale * moe, new

    def _embed(self, tokens):
        return L.embed(self.embed, tokens) * self.cfg.embed_scale

    def _logits(self, x):
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (x @ w) * self.cfg.logits_scale

    def loss(self, batch: dict) -> torch.Tensor:
        x = self._embed(batch["tokens"].long())
        positions = _positions(*x.shape[:2], x.device)
        for kind, _, mp, p in self._stacks():
            x = self._remat(lambda mp, p, h, kind=kind: self._layer(kind, mp, p, h,
                                                                   positions)[0], mp, p, x)
        return _ce_loss(self._logits(x), batch["labels"])

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor):
        """tokens (B,T) -> (logits of the last position (B,1,V), cache).
        Each layer's state is copied into the cache as the layer ends: on
        the plain chain a Mamba-2 block's conv tail is a view of its whole
        conv input, which would otherwise stay alive until the last layer."""
        x = self._embed(tokens)
        b, t = tokens.shape
        positions = _positions(b, t, x.device)
        cache = self.init_cache(b, t)
        for kind, i, mp, p in self._stacks():
            x, new = self._layer(kind, mp, p, x, positions)
            for key, val in zip(("conv", "ssd") if kind == "mamba" else ("ak", "av"), new):
                cache[key][i].copy_(val)
        cache["len"] = t
        return self._logits(x[:, -1:]), cache

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        conv, ssd = M.zero_states(cfg, cfg.layers_of("mamba"), batch_size, self.device)
        kv = (self.n_apps, batch_size, max_len, cfg.n_kv_heads, cfg.hd())
        return {
            "conv": conv,
            "ssd": ssd,
            "ak": torch.zeros(kv, dtype=dt, device=self.device),
            "av": torch.zeros(kv, dtype=dt, device=self.device),
            "len": 0,
        }

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """tokens (B,1) -> (logits (B,1,V), cache with the Mamba states
        advanced and the new K/V written in place, ``len`` one longer)."""
        if self.n_apps:
            self._grow_check(cache, "ak")
        new_len = cache["len"] + 1
        x = self._embed(tokens)
        positions = torch.full(tokens.shape, new_len - 1, device=x.device)
        for kind, i, mp, p in self._stacks():
            if kind == "mamba":
                conv, ssd = cache["conv"], cache["ssd"]
                x, (conv[i], ssd[i]) = self._layer(kind, mp, p, x, positions,
                                                   state=(conv[i], ssd[i]))
            else:
                x, _ = self._layer(kind, mp, p, x, positions,
                                   state=(cache["ak"][i], cache["av"][i]), cache_len=new_len)
        cache["len"] = new_len
        return self._logits(x), cache


_MODELS = {"dense": TransformerLM, "moe": TransformerLM, "vlm": TransformerLM,
           "ssm": MambaLM, "hybrid": MambaLM, "hybrid_moe": HybridMoELM, "encdec": EncDecLM}


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda",
                generator: torch.Generator | None = None) -> nn.Module:
    """The port's model for ``cfg`` on ``device`` (``cuda`` unless the caller
    asks for ``cpu``; ``cuda`` without a GPU raises)."""
    dev = check_device(device)
    if cfg.family not in _MODELS:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _MODELS[cfg.family](cfg, device=dev, generator=generator)


def meta_model(cfg: ModelConfig) -> nn.Module:
    """The model of ``cfg`` on the meta device: its parameters' shapes and
    dtypes and no data, nothing drawn (the counterpart of
    ``jax.eval_shape(model.init)``, for the sharding specs and the dry
    run)."""
    if cfg.family not in _MODELS:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _MODELS[cfg.family](cfg, device=_META)
