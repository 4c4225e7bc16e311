"""Model building blocks: norms, rotary, blocked GQA attention, SwiGLU MLP,
and a capacity-based sorted-dispatch MoE.

The counterparts of the serving functions of the JAX package's
``models/layers.py``.  Conventions, as there:

* weights keep the reference's (in, out) layout, so a projection is
  ``x @ w``; every init function returns a dict of tensors whose leading
  dims are ``lead`` (the models pass ``(n_layers,)`` to draw the stacked
  layers at once);
* compute dtype = ``cfg.dtype`` (bf16 in production).  Where the reference
  asks for float32 results of bf16 products (``preferred_element_type``:
  the attention scores and the attention output product), the operands are
  upcast before the product, since a bf16 ``matmul`` in torch returns bf16;
* attention over long sequences is *blocked* over query chunks (exact), so
  the T x T score matrix never materialises whole.  It is plain torch
  written as the reference writes it (f32 scores, masks of ``-1e30``, the
  blocked causal softmax), not ``scaled_dot_product_attention``;
* the MoE dispatch sorts tokens by expert within each batch row (stably, as
  ``jnp.argsort``), scattering into an (E, C, D) capacity buffer.

The sharding helpers and ``seq_sharded_attention`` need a device mesh and
come with the sharding slice (``ROADMAP.md``); ``attention_apply`` raises
for the configuration flags that select them.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MASKED = -1e30  # the reference's mask value (not -inf)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


# ----------------------------------------------------------------- plumbing

def normal_init(generator: torch.Generator, shape, scale: float, dtype: torch.dtype,
                device: torch.device | str | None = None) -> torch.Tensor:
    """``scale`` * N(0, 1), drawn in float32 on the generator's device, then
    cast to ``dtype`` and moved to ``device`` (default: the generator's)."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (scale * w).to(device=device or generator.device, dtype=dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in float32, cast back to ``x.dtype``, then scale (the
    reference's cast order)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split; x: (..., T, H, D), positions: (..., T).
    Angles in float32; the result is cast back to ``x.dtype``."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions[..., :, None, None].float() * freqs  # (..., T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# -------------------------------------------------------------- attention

def init_attention(generator: torch.Generator, cfg: ModelConfig, *,
                   d_model: int | None = None, device: torch.device | str | None = None,
                   lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    d = d_model or cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    dt = dtype_of(cfg)
    dev = device or generator.device

    def nrm(shape, scale):
        return normal_init(generator, (*lead, *shape), scale, dt, dev)

    p = {
        "wq": nrm((d, h * hd), d ** -0.5),
        "wk": nrm((d, kv * hd), d ** -0.5),
        "wv": nrm((d, kv * hd), d ** -0.5),
        "wo": nrm((h * hd, d), (h * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dt, device=dev)
    return p


def _qkv(p, x, cfg: ModelConfig):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    b, t = x.shape[:2]
    return q.reshape(b, t, h, hd), k.reshape(b, t, kv, hd), v.reshape(b, t, kv, hd)


def _gqa_scores_block(q, k, scale):
    """q: (B,Tq,KV,G,hd), k: (B,S,KV,hd) -> (B,KV,G,Tq,S) f32."""
    return torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale


def _weighted_values(w, v):
    """The softmax weights (B,KV,G,Tq,S) f32, cast to ``v.dtype`` as the
    reference casts them, times v (B,S,KV,hd), summed in f32 ->
    (B,Tq,KV,G,hd) f32."""
    return torch.einsum("bkgts,bskh->btkgh", w.to(v.dtype).float(), v.float())


def blocked_causal_attention(q, k, v, *, q_block: int, q_offset: int = 0,
                             attn_chunk: int = 0):
    """Exact causal GQA attention, blocked over query chunks.

    q: (B,T,H,hd); k,v: (B,S,KV,hd).  Query position i attends to key
    positions <= i + q_offset (and, with attn_chunk>0, only keys in the same
    local chunk -- llama4-style chunked attention).  The query blocks are
    of the largest size <= ``q_block`` that divides T.  Returns (B,T,H,hd).
    """
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qb = min(q_block, t)
    while t % qb:  # largest block <= q_block that divides t (ragged prefixes)
        qb -= 1
    qr = q.reshape(b, t // qb, qb, kvh, g, hd)
    kpos = torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for i in range(t // qb):
        qpos = q_offset + i * qb + torch.arange(qb, device=q.device)
        scores = _gqa_scores_block(qr[:, i], k, scale)  # (B,KV,G,qb,S)
        mask = kpos[None, :] <= qpos[:, None]
        if attn_chunk:
            mask &= (kpos[None, :] // attn_chunk) == (qpos[:, None] // attn_chunk)
        w = torch.softmax(torch.where(mask, scores, MASKED), dim=-1)
        out[:, i * qb : (i + 1) * qb] = _weighted_values(w, v).reshape(b, qb, h, hd)
    return out


def decode_attention(q, k_cache, v_cache, cache_len: int, *, attn_chunk: int = 0):
    """Single-token attention over a KV cache.

    q: (B,1,H,hd); caches: (B,S,KV,hd); cache_len: count of valid entries
    (the new token's K/V must already be written at cache_len-1).
    """
    b, _, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(b, 1, kvh, h // kvh, hd)
    scores = _gqa_scores_block(qr, k_cache, hd ** -0.5)  # (B,KV,G,1,S)
    kpos = torch.arange(s, device=q.device)
    mask = kpos < cache_len
    if attn_chunk:
        mask &= (kpos // attn_chunk) == ((cache_len - 1) // attn_chunk)
    w = torch.softmax(torch.where(mask, scores, MASKED), dim=-1)
    return _weighted_values(w, v_cache).reshape(b, 1, h, hd).to(q.dtype)


def attention_apply(p, x, cfg: ModelConfig, *, positions, kv_cache=None,
                    cache_len: int | None = None, q_block: int = 512):
    """Unified attention: prefill (kv_cache=None -> returns the fresh (k, v))
    or decode (kv_cache given, x is (B,1,D)).  In decode the new token's K/V
    are written into the cache tensors in place at ``cache_len - 1`` (the
    reference returns updated copies), and the cache must have room there."""
    if cfg.attn_seq_shard or cfg.fsdp_gather:
        raise NotImplementedError(
            f"{cfg.name}: attn_seq_shard / fsdp_gather need a device mesh; the sharding "
            "slice is not ported yet (ROADMAP.md)")
    h, hd = cfg.n_heads, cfg.hd()
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        out = blocked_causal_attention(q, k, v, q_block=q_block, attn_chunk=cfg.attn_chunk)
        new_cache = (k, v)
    else:
        kc, vc = kv_cache
        idx = cache_len - 1
        if not 0 <= idx < kc.shape[1]:
            raise ValueError(f"KV cache of {kc.shape[1]} positions has no room at {idx}; "
                             "grow it first (launch/serve.py grow_cache)")
        kc[:, idx : idx + 1] = k
        vc[:, idx : idx + 1] = v
        out = decode_attention(q, kc, vc, cache_len, attn_chunk=cfg.attn_chunk)
        new_cache = (kc, vc)
    y = out.reshape(b, -1, h * hd) @ p["wo"]
    if cfg.bf16_reduce:  # the reference's preferred_element_type=bf16
        y = y.to(torch.bfloat16)
    return y, new_cache


# ------------------------------------------------------------------- MLP

def init_mlp(generator: torch.Generator, cfg: ModelConfig, *, d_ff: int | None = None,
             gated: bool = True, device: torch.device | str | None = None,
             lead: tuple[int, ...] = ()) -> dict[str, torch.Tensor]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    dev = device or generator.device
    p = {"w_in": normal_init(generator, (*lead, d, ff), d ** -0.5, dt, dev)}
    if gated:
        p["w_gate"] = normal_init(generator, (*lead, d, ff), d ** -0.5, dt, dev)
    p["w_out"] = normal_init(generator, (*lead, ff, d), ff ** -0.5, dt, dev)
    return p


def _swiglu(gate, up):
    """silu(gate) * up in float32, rounded once to the inputs' dtype: XLA
    fuses the two elementwise ops of the reference and rounds a bf16 result
    once, where two torch ops would round twice."""
    return (F.silu(gate.float()) * up.float()).to(up.dtype)


def mlp_apply(p, x, bf16_reduce: bool = False):
    """SwiGLU when ``p`` has a gate, else GELU in its tanh approximation
    (``jax.nn.gelu``'s default)."""
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = _swiglu(x @ p["w_gate"], h)
    else:
        h = F.gelu(h, approximate="tanh")
    y = h @ p["w_out"]
    return y.to(torch.bfloat16) if bf16_reduce else y


# ------------------------------------------------------------------- MoE

def init_moe(generator: torch.Generator, cfg: ModelConfig, *,
             device: torch.device | str | None = None,
             lead: tuple[int, ...] = ()) -> dict:
    """Expert weights in ``cfg.dtype``; the router stays float32 (as the
    reference's does, in a bf16 model too)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    dev = device or generator.device

    def nrm(shape, scale, dtype=dt):
        return normal_init(generator, (*lead, *shape), scale, dtype, dev)

    p = {
        "router": nrm((d, e), d ** -0.5, torch.float32),
        "w_gate": nrm((e, d, ff), d ** -0.5),
        "w_in": nrm((e, d, ff), d ** -0.5),
        "w_out": nrm((e, ff, d), ff ** -0.5),
    }
    if cfg.shared_expert_ff:
        p["shared"] = init_mlp(generator, cfg, d_ff=cfg.shared_expert_ff, device=dev,
                               lead=lead)
    return p


@dataclasses.dataclass
class Dispatch:
    """Where each of a batch row's t*k routed slots goes, in sorted order."""
    cap: int                # capacity of each expert
    token_of: torch.Tensor  # (b, t*k) source token of each sorted slot
    slot: torch.Tensor      # (b, t*k) expert*cap + position, or e*cap if dropped
    keep: torch.Tensor      # (b, t*k) bool: the slot fits its expert's capacity
    probs: torch.Tensor     # (b, t*k) f32 renormalised top-k probability


def moe_dispatch(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> Dispatch:
    """The reference's routing: f32 router softmax, top-k, renormalised;
    slots sorted by expert (stably, as ``jnp.argsort`` sorts), each kept
    while its expert has capacity ``max(1, ceil(t*k/e * capacity_factor))``."""
    b, t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(math.ceil(t * k / e * cfg.capacity_factor)))
    probs = torch.softmax(x.float() @ router, dim=-1)
    # jax.lax.top_k breaks ties toward the lower index; torch.topk does not
    # promise an order among equal values (ties need exactly equal f32 probs)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e, flat_p = top_e.reshape(b, t * k), top_p.reshape(b, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    pos_in_e = torch.gather(torch.cumsum(F.one_hot(sorted_e, e), dim=1), 2,
                            sorted_e[..., None])[..., 0] - 1
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)  # drop -> the sentinel row
    return Dispatch(cap, order // k, slot, keep, torch.gather(flat_p, 1, order))


def moe_apply(p, x, cfg: ModelConfig):
    """Capacity-based top-k MoE with sorted dispatch: scatter-add into an
    (E*C + 1, D) buffer per batch row (the last row the sentinel of dropped
    slots), the expert FFNs as batched products, then gather back with an
    appended zero row, weighted by the kept slots' probabilities."""
    b, t, d = x.shape
    e = cfg.n_experts
    dsp = moe_dispatch(p["router"], x, cfg)
    rows = e * dsp.cap + 1
    base = torch.arange(b, device=x.device)[:, None]
    gathered = x[base, dsp.token_of]  # (b, t*k, d)
    buf = torch.zeros((b * rows, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, (dsp.slot + base * rows).reshape(-1), gathered.reshape(-1, d))
    buf = buf.view(b, rows, d)[:, :-1].reshape(b, e, dsp.cap, d)
    gate = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    up = torch.einsum("becd,edf->becf", buf, p["w_in"])
    out = torch.einsum("becf,efd->becd", _swiglu(gate, up), p["w_out"])
    out = torch.cat([out.reshape(b, e * dsp.cap, d), out.new_zeros((b, 1, d))], dim=1)
    vals = torch.gather(out, 1, dsp.slot[..., None].expand(-1, -1, d))  # (b, t*k, d)
    vals = vals * (dsp.probs * dsp.keep)[..., None].to(vals.dtype)
    y = torch.zeros((b * t, d), dtype=out.dtype, device=x.device)
    y.index_add_(0, (dsp.token_of + base * t).reshape(-1), vals.reshape(-1, d))
    y = y.view(b, t, d)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x)
    return y.to(x.dtype)
