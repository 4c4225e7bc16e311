"""A plain float32 granite-4.0-h language model (GraniteMoeHybrid).

Written from the published model (ibm-granite/granite-4.0-h-small,
``model_type`` granitemoehybrid): a pattern of Mamba-2 and attention mixers
(``layer_types``), each layer followed by a MoE of SwiGLU experts beside a
SwiGLU shared expert.  No kernel, no cache manager, no batching: one
sequence at a time, every product in float32 with TF32 off.

Weights are a flat dict of tensors under the leaf names of the model under
test, in the (in, out) layout, so a projection is ``x @ w``: the Mamba-2
blocks stacked over the Mamba layers (``mamba.w_z`` ...), the attention
projections over the attention layers (``attn.wq`` ...), the norms and MoEs
over every layer (``layers.ln1``, ``layers.moe.router``,
``layers.moe.w_gate`` (E, D, F) ..., ``layers.moe.shared.w_in`` ...),
``embed`` and ``final_norm``.  Each leaf is cast to float32 where it is used.

One sequence of T tokens:

  x = embed_scale * embed[tokens]
  per layer l:  x = x + residual_scale * Mixer_l(rmsnorm(x, ln1_l))
                u = rmsnorm(x, ln2_l)
                x = x + residual_scale * (MoE_l(u) + SwiGLU_shared_l(u))
  logits = logits_scale * rmsnorm(x, final_norm) @ embed^T      (tied)

  Mixer_l:  Mamba-2 (``mamba_lm.mamba_layer``) or causal GQA attention with
            no positional embedding, softmax of (q . k) * attn_scale
  MoE(u):   logits = u W_router;  the top k logits, softmax over those k;
            sum over the k of p_e * SwiGLU_e(u); no token dropped
  SwiGLU:   (silu(u W_gate) * (u W_in)) W_out

The SSD chunk is a divisor of T (the chunked form is exact for any chunk).
``quant`` rounds the operands of every projection that the configuration
computes in its low precision (all but the router and ``W_dt``, which are
float32 there); the identity by default.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from port_bench.reference import mamba_lm
from port_bench.reference.mamba_lm import identity, mamba_layer, rmsnorm


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the reference needs, read from a configuration file's
    ``model`` block."""
    mamba: mamba_lm.Shape     # the Mamba-2 mixers' sizes
    layer_types: tuple
    heads: int
    kv_heads: int
    head_dim: int
    top_k: int
    embed_scale: float
    residual_scale: float
    logits_scale: float
    attn_scale: float
    eps: float
    tied: bool

    @classmethod
    def of(cls, model: dict) -> "Shape":
        d = model["d_model"]
        d_inner = model["ssm_expand"] * d
        head_dim = model.get("head_dim") or d // model["n_heads"]
        eps = model.get("norm_eps", 1e-6)
        mamba = mamba_lm.Shape(
            n_layers=model["layer_types"].count("mamba"), d_model=d, vocab=model["vocab"],
            d_inner=d_inner, heads=d_inner // model["ssm_head_dim"],
            head_dim=model["ssm_head_dim"], state=model["ssm_state"], conv=model["ssm_conv"],
            chunk=model["ssm_chunk"], eps=eps)
        scale = model.get("attn_scale")
        return cls(mamba=mamba, layer_types=tuple(model["layer_types"]),
                   heads=model["n_heads"], kv_heads=model["n_kv_heads"], head_dim=head_dim,
                   top_k=model["top_k"], embed_scale=model.get("embed_scale", 1.0),
                   residual_scale=model.get("residual_scale", 1.0),
                   logits_scale=model.get("logits_scale", 1.0),
                   attn_scale=head_dim ** -0.5 if scale is None else scale, eps=eps,
                   tied=model.get("tie_embeddings", False))


def _proj(x, w, quant):
    return quant(x) @ quant(w.float())


def attention(p: dict, u: torch.Tensor, s: Shape, quant=identity):
    """Causal GQA attention with no positional embedding on u (T, D),
    already normalised, one K/V head's query group at a time.  Returns
    (out (T, D), K, V), K and V (T, KV, hd)."""
    t = u.shape[0]
    hq, kv, hd = s.heads, s.kv_heads, s.head_dim
    group = hq // kv
    q = _proj(u, p["wq"], quant).reshape(t, kv, group, hd)
    k = _proj(u, p["wk"], quant).reshape(t, kv, hd)
    v = _proj(u, p["wv"], quant).reshape(t, kv, hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=u.device).tril()
    o = torch.empty(t, kv, group, hd, dtype=torch.float32, device=u.device)
    for j in range(kv):
        scores = torch.einsum("tgd,sd->gts", q[:, j], k[:, j]) * s.attn_scale
        w = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
        o[:, j] = torch.einsum("gts,sd->tgd", w, v[:, j])
    return _proj(o.reshape(t, hq * hd), p["wo"], quant), k, v


def swiglu(p: dict, u: torch.Tensor, quant=identity) -> torch.Tensor:
    return _proj(torch.nn.functional.silu(_proj(u, p["w_gate"], quant))
                 * _proj(u, p["w_in"], quant), p["w_out"], quant)


def moe(p: dict, u: torch.Tensor, s: Shape, quant=identity) -> torch.Tensor:
    """The MoE on u (T, D), as published: the router's top k logits, a
    softmax over them, each expert run on the tokens routed to it, plus the
    shared expert."""
    top_l, top_e = torch.topk(u @ p["router"].float(), s.top_k, dim=-1)
    gates = torch.softmax(top_l, dim=-1)
    y = swiglu(p["shared"], u, quant)
    for e in range(p["router"].shape[-1]):
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        if tok.numel():
            ex = {k: p[k][e] for k in ("w_gate", "w_in", "w_out")}
            y = y.index_add(0, tok, gates[tok, slot, None] * swiglu(ex, u[tok], quant))
    return y


def _stack(weights: dict, prefix: str, i: int) -> dict:
    """Entry ``i`` of every leaf under ``prefix`` (nested by its dots)."""
    out: dict = {}
    for name, v in weights.items():
        if name.startswith(prefix):
            *groups, leaf = name[len(prefix):].split(".")
            node = out
            for g in groups:
                node = node.setdefault(g, {})
            node[leaf] = v[i]
    return out


def hidden(weights: dict, tokens: torch.Tensor, s: Shape, quant=identity, *,
           cache: dict | None = None) -> torch.Tensor:
    """The final normalised hidden states (T, D) of one sequence.  With
    ``cache`` (a dict) it receives per Mamba layer the conv tail and the SSD
    state, and per attention layer K and V."""
    t = tokens.shape[0]
    ms = dataclasses.replace(s.mamba, chunk=math.gcd(t, s.mamba.chunk))
    x = weights["embed"][tokens].float() * s.embed_scale
    if cache is not None:
        cache.update(conv=[], ssd=[], ak=[], av=[])
    seen = {"mamba": 0, "attention": 0}
    for layer, kind in enumerate(s.layer_types):
        u = rmsnorm(x, weights["layers.ln1"][layer], s.eps)
        if kind == "mamba":
            out, tail, h = mamba_layer(_stack(weights, "mamba.", seen[kind]), u, ms, quant)
            state = {"conv": tail, "ssd": h}
        else:
            out, k, v = attention(_stack(weights, "attn.", seen[kind]), u, s, quant)
            state = {"ak": k, "av": v}
        seen[kind] += 1
        if cache is not None:
            for key, val in state.items():
                cache[key].append(val)
        x = x + s.residual_scale * out
        u = rmsnorm(x, weights["layers.ln2"][layer], s.eps)
        x = x + s.residual_scale * moe(_stack(weights, "layers.moe.", layer), u, s, quant)
    return rmsnorm(x, weights["final_norm"], s.eps)


def _head(weights: dict, s: Shape) -> torch.Tensor:
    return weights["embed"].T if s.tied else weights["lm_head"]


def last_logits(weights: dict, tokens: torch.Tensor, s: Shape, quant=identity):
    """(logits of the last position (V,), cache) of one prompt (T,)."""
    cache: dict = {}
    with torch.no_grad():
        x = hidden(weights, tokens, s, quant, cache=cache)
        logits = _proj(x[-1:], _head(weights, s), quant)[0] * s.logits_scale
    return logits, cache


def all_logits(weights: dict, tokens: torch.Tensor, s: Shape, quant=identity):
    """The logits (T, V) of every position of one prompt (T,)."""
    with torch.no_grad():
        return _proj(hidden(weights, tokens, s, quant), _head(weights, s), quant) \
            * s.logits_scale
