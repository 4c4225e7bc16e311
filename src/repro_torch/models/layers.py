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
  blocked causal softmax), not ``scaled_dot_product_attention``.  A
  prefill whose operands the port's own kernel takes (``kernels/attention.py``
  ``takes``) runs the same function as one launch of it instead
  (:func:`prefill_attention`);
* the MoE dispatch sorts tokens by expert within each batch row (stably, as
  ``jnp.argsort``), scattering into an (E, C, D) capacity buffer; with
  ``cfg.moe_dropless`` every routed slot is computed instead, the experts'
  products grouped over contiguous segments of the sorted slots.

The sharding helpers (``_wsc``, ``gather_fsdp_weights``,
``pin_activation_batch``) and ``seq_sharded_attention`` act on DTensors
under the mesh that ``distributed.sharding.use_mesh`` sets; without one
they leave tensors as they are and ``attention_apply`` takes the blocked
attention.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.kernels import attention as attention_kernel
from repro_torch.kernels.route import is_dtensor
from repro_torch.models.config import ModelConfig
from repro_torch.obs import spans

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MASKED = -1e30  # the reference's mask value (not -inf)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


# ---------------------------------------------- sharding-constraint helpers
#
# The counterparts of the reference's ``with_sharding_constraint`` helpers.
# The ambient mesh is the one set by ``distributed.sharding.use_mesh``; a
# constraint redistributes a DTensor to the placements of its spec, and is a
# no-op on a plain tensor or without an ambient mesh.

TP_AXES = {"heads", "kv", "ff", "vocab", "experts",
           "ssm_inner", "ssm_heads", "ssm_conv_ch"}


def replicated_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (made on every rank alike: positions, masks, rotary angles) as a
    replicated DTensor on ``like``'s mesh when ``like`` is a DTensor, so the
    two mix in one op; ``t`` itself otherwise."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import Replicate, distribute_tensor

    mesh = like.device_mesh
    return distribute_tensor(t, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)


def splits(p, dim: int, ndim: int) -> bool:
    """Whether placement ``p`` shards tensor dim ``dim`` of an ``ndim``-dim
    tensor (DTensor may keep a shard dim negative)."""
    from torch.distributed.tensor import Shard

    return isinstance(p, Shard) and p.dim % ndim == dim


def _whole(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """A DTensor ``x`` gathered over the mesh dims that split ``dim`` when
    they do not divide ``parts`` (its shards would cut a part apart)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    cut = [i for i, p in enumerate(x.placements) if splits(p, dim, x.ndim)]
    if parts % math.prod(x.device_mesh.shape[i] for i in cut) == 0:
        return x
    return x.redistribute(x.device_mesh, [Replicate() if i in cut else p
                                          for i, p in enumerate(x.placements)])


def split_heads(x: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(..., heads * head_dim) -> (..., heads, head_dim), a DTensor gathered
    first where its shards would cut heads apart."""
    return _whole(x, x.ndim - 1, heads).reshape(*x.shape[:-1], heads, head_dim)


def group_heads(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, KV, H/KV, hd), the grouped-query layout, a
    DTensor gathered first where its head shards would cut groups apart."""
    b, t, h, hd = q.shape
    return _whole(q, 2, kv_heads).reshape(b, t, kv_heads, h // kv_heads, hd)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: rows of the (V, D) embedding.  On DTensors the
    lookup runs per shard (``local_map``) on the rank's tokens against the
    whole table, gathered over the mesh (the gradient comes back summed over
    the ranks whose tokens differ); DTensor has no rule for an index into a
    vocab- or FSDP-sharded table on every mesh."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rows = [Shard(0) if splits(p, 0, tokens.ndim) else Replicate()
            for p in (tokens.placements if is_dtensor(tokens) else [Replicate()] * mesh.ndim)]
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p == Shard(0) else Replicate() for p in rows]
    return local_map(lambda t, i: t[i], out_placements=rows, in_placements=(whole, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) -> (..., H * hd).  On a DTensor the gradient is brought
    back to the merged tensor's layout before it is split into heads again
    (a shard of the merged dim need not hold whole heads)."""
    y = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return y.redistribute(y.device_mesh, y.placements) if is_dtensor(y) else y


def _ambient_mesh():
    return sharding.current_mesh()


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _wsc(x, parts):
    """``x`` redistributed to the spec ``parts`` on the ambient mesh (a
    no-op without one, or on a plain tensor)."""
    mesh = _ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    want = sharding.placements(mesh, sharding.P(*parts), x.ndim)
    return x if tuple(x.placements) == tuple(want) else x.redistribute(mesh, want)


def gather_fsdp_weights(p_layer, axes_layer):
    """FSDP weight gather: constrain each layer weight to its TP-only spec
    (data axes dropped), so the (small) weight shards are all-gathered once
    per layer instead of all-reducing (huge) partial-sum activations.

    ``axes_layer`` is the logical-axes tree of one layer's params (leading
    "layers" axis already stripped)."""
    am = _ambient_mesh()
    if am is None or "model" not in am.mesh_dim_names:
        return p_layer
    msz = sharding.mesh_sizes(am)["model"]

    def one(w, ax):
        parts, used = [], False
        for dim, a in zip(w.shape, ax):
            if a in TP_AXES and not used and dim % msz == 0:
                parts.append("model")
                used = True
            else:
                parts.append(None)
        return _wsc(w, parts)

    return sharding.tree_map(one, p_layer, axes_layer)


def strip_layer_axis(axes_layer_tree):
    """Drop the leading "layers" stacking axis from an axes tree."""
    return sharding.tree_map(lambda a: tuple(a[1:]), axes_layer_tree)


def pin_activation_batch(x):
    """Constrain an activation tensor to batch-sharded / feature-replicated:
    the residual stream at layer boundaries keeps the canonical
    data-parallel layout, so FSDP resolves into per-layer weight
    all-gathers."""
    am = _ambient_mesh()
    if am is None:
        return x
    dp = _data_axes(am)
    if not dp:
        return x
    sizes = sharding.mesh_sizes(am)
    if x.shape[0] % math.prod(sizes[a] for a in dp) != 0:
        return x
    return _wsc(x, [dp if len(dp) > 1 else dp[0]] + [None] * (x.ndim - 1))


# ----------------------------------------------------------------- plumbing

def normal_init(generator: torch.Generator | None, shape, scale: float, dtype: torch.dtype,
                device: torch.device | str | None = None) -> torch.Tensor:
    """``scale`` * N(0, 1), drawn in float32 on the generator's device, then
    cast to ``dtype`` and moved to ``device`` (default: the generator's).
    Without a generator (a model built on the meta device: shapes only)
    nothing is drawn: an empty tensor on ``device``."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
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
    cos, sin = replicated_like(torch.cos(ang), x), replicated_like(torch.sin(ang), x)
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


def attention_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_attention`'s leaves (the reference's)."""
    a = {"wq": ("embed", "heads"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
         "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        a["bq"], a["bk"], a["bv"] = ("heads",), ("kv",), ("kv",)
    return a


def _qkv(p, x, cfg: ModelConfig):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return split_heads(q, h, hd), split_heads(k, kv, hd), split_heads(v, kv, hd)


def _gqa_scores_block(q, k, scale):
    """q: (B,Tq,KV,G,hd), k: (B,S,KV,hd) -> (B,KV,G,Tq,S) f32."""
    return torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale


def _weighted_values(w, v):
    """The softmax weights (B,KV,G,Tq,S) f32, cast to ``v.dtype`` as the
    reference casts them, times v (B,S,KV,hd), summed in f32 ->
    (B,Tq,KV,G,hd) f32."""
    return torch.einsum("bkgts,bskh->btkgh", w.to(v.dtype).float(), v.float())


def per_head_shard(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` -> (B, T, H, hd) on each rank's shard
    (``local_map``), q (B, T, H, hd) and k, v (B, S, KV, hd) DTensors: batch
    rows over the data axes and query heads over "model" where they divide.
    K/V heads follow when they divide too; else K/V stay whole over "model"
    (gathered, with a partial gradient) and each rank takes the kv head of
    each of its query heads.  Heads that do not divide are computed whole
    on every model rank.  One region per call keeps the per-block ops of
    ``fn`` off DTensor's dispatch."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    sizes = sharding.mesh_sizes(mesh)
    b, _, h, _ = q.shape
    kvh = k.shape[2]
    dp = _data_axes(mesh)
    batch = bool(dp) and b % math.prod(sizes[a] for a in dp) == 0
    msz = sizes.get("model", 1)
    heads = "model" in sizes and h % msz == 0
    kv = heads and kvh % msz == 0
    pq, pkv, gkv = [], [], []
    for name in mesh.mesh_dim_names:
        if name in dp:
            one = Shard(0) if batch else Replicate()
            pq.append(one)
            pkv.append(one)
            gkv.append(one)
        elif name == "model" and heads:
            pq.append(Shard(2))
            pkv.append(Shard(2) if kv else Replicate())
            gkv.append(Shard(2) if kv else Partial())
        else:
            pq.append(Replicate())
            pkv.append(Replicate())
            gkv.append(Replicate())

    def local(q, k, v):
        if heads and not kv:  # this rank's query heads against their own kv heads
            hl = q.shape[2]
            first = mesh.get_local_rank("model") * hl
            idx = (first + torch.arange(hl, device=q.device)) // (h // kvh)
            k, v = k[:, :, idx], v[:, :, idx]
        return fn(q, k, v, **kw)

    return local_map(local, out_placements=(pq,), in_placements=(pq, pkv, pkv),
                     in_grad_placements=(pq, gkv, gkv), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def blocked_causal_attention(q, k, v, *, q_block: int, q_offset: int = 0,
                             attn_chunk: int = 0, scale: float | None = None):
    """Exact causal GQA attention, blocked over query chunks.

    q: (B,T,H,hd); k,v: (B,S,KV,hd).  Query position i attends to key
    positions <= i + q_offset (and, with attn_chunk>0, only keys in the same
    local chunk -- llama4-style chunked attention).  The scores are scaled
    by ``scale`` (hd ** -0.5 by default).  The query blocks are of the
    largest size <= ``q_block`` that divides T.  Returns (B,T,H,hd).
    On DTensors it runs on each rank's batch rows and heads
    (:func:`per_head_shard`).
    """
    if is_dtensor(q):
        return per_head_shard(blocked_causal_attention, q, k, v, q_block=q_block,
                              q_offset=q_offset, attn_chunk=attn_chunk, scale=scale)
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    qb = min(q_block, t)
    while t % qb:  # largest block <= q_block that divides t (ragged prefixes)
        qb -= 1
    qr = q.reshape(b, t // qb, qb, kvh, g, hd)
    kpos = torch.arange(s, device=q.device)
    out = []
    for i in range(t // qb):
        qpos = q_offset + i * qb + torch.arange(qb, device=q.device)
        scores = _gqa_scores_block(qr[:, i], k, scale)  # (B,KV,G,qb,S)
        mask = kpos[None, :] <= qpos[:, None]
        if attn_chunk:
            mask &= (kpos[None, :] // attn_chunk) == (qpos[:, None] // attn_chunk)
        w = torch.softmax(torch.where(mask, scores, MASKED), dim=-1)
        out.append(_weighted_values(w, v).reshape(b, qb, h, hd).to(q.dtype))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def prefill_attention(q, k, v, *, q_block: int, q_offset: int = 0, attn_chunk: int = 0,
                      scale: float | None = None):
    """Causal GQA attention of a prefill: what :func:`blocked_causal_attention`
    computes, as one launch of the CUDA kernel where it takes the operands
    (``kernels/attention.py`` ``takes``; its wrapper raises for a head dim
    without an instance), the blocked function otherwise.  On DTensors it
    runs on each rank's batch rows and heads (:func:`per_head_shard`)."""
    if is_dtensor(q):
        return per_head_shard(prefill_attention, q, k, v, q_block=q_block, q_offset=q_offset,
                              attn_chunk=attn_chunk, scale=scale)
    if attention_kernel.takes(q, k, v):
        return attention_kernel.causal_attention(q, k, v, q_offset=q_offset,
                                                 attn_chunk=attn_chunk, scale=scale)
    return blocked_causal_attention(q, k, v, q_block=q_block, q_offset=q_offset,
                                    attn_chunk=attn_chunk, scale=scale)


def seq_sharded_attention(q, k, v, *, q_offset: int = 0, attn_chunk: int = 0,
                          scale: float | None = None):
    """Exact causal GQA attention with the query *time* axis sharded over the
    ambient mesh's model axis (context parallelism).

    For architectures whose head count does not divide the TP degree,
    head-sharding degenerates to hd-dim partial sums and giant score-tensor
    all-reduces.  Sharding query time instead keeps every contraction local:
    the only collective is an all-gather of K/V.  Each rank's query rows run
    in ``local_map`` against the whole K/V; the values are
    ``blocked_causal_attention``'s."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    am = _ambient_mesh()
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sizes = sharding.mesh_sizes(am)
    msz = sizes["model"]
    tq = t // msz
    dp = _data_axes(am)
    batch_split = bool(dp) and b % math.prod(sizes[a] for a in dp) == 0
    qr = q.reshape(b, msz, tq, kvh, g, hd)
    scale = hd ** -0.5 if scale is None else scale

    def local(qr, k, v):
        m_local = qr.shape[1]
        m0 = am.get_local_rank("model") * m_local if m_local < msz else 0
        s_len = k.shape[1]
        scores = torch.einsum("bmtkgh,bskh->bmkgts", qr.float(), k.float()) * scale
        kpos = torch.arange(s_len, device=qr.device)
        qpos = (q_offset + (m0 + torch.arange(m_local, device=qr.device))[:, None] * tq
                + torch.arange(tq, device=qr.device)[None, :])  # (m, tq)
        mask = kpos[None, None, :] <= qpos[:, :, None]  # (m, tq, s)
        if attn_chunk:
            mask &= (kpos[None, None, :] // attn_chunk) == (qpos[:, :, None] // attn_chunk)
        w = torch.softmax(torch.where(mask[None, :, None, None], scores, MASKED), dim=-1)
        return torch.einsum("bmkgts,bskh->bmtkgh", w.to(v.dtype).float(), v.float())

    batch = [Shard(0) if batch_split else Replicate()]
    pl_q, pl_kv, grad_kv = [], [], []
    for name in am.mesh_dim_names:
        if name in dp:
            pl_q += batch
            pl_kv += batch
            grad_kv += batch
        elif name == "model":
            pl_q.append(Shard(1))
            pl_kv.append(Replicate())
            grad_kv.append(Partial())
        else:
            pl_q.append(Replicate())
            pl_kv.append(Replicate())
            grad_kv.append(Replicate())
    out = local_map(local, out_placements=(pl_q,), in_placements=(pl_q, pl_kv, pl_kv),
                    in_grad_placements=(pl_q, grad_kv, grad_kv), device_mesh=am,
                    redistribute_inputs=True)(qr, k, v)
    return out.reshape(b, t, h, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len: int, *, attn_chunk: int = 0,
                     scale: float | None = None):
    """Single-token attention over a KV cache.

    q: (B,1,H,hd); caches: (B,S,KV,hd); cache_len: count of valid entries
    (the new token's K/V must already be written at cache_len-1); scores
    scaled by ``scale`` (hd ** -0.5 by default).  On DTensors it runs on
    each rank's batch rows and heads (:func:`per_head_shard`).
    """
    if is_dtensor(q):
        return per_head_shard(decode_attention, q, k_cache, v_cache, cache_len=cache_len,
                              attn_chunk=attn_chunk, scale=scale)
    b, _, h, hd = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    qr = group_heads(q, kvh)
    scale = hd ** -0.5 if scale is None else scale
    scores = _gqa_scores_block(qr, k_cache, scale)  # (B,KV,G,1,S)
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
    reference returns updated copies), and the cache must have room there.
    Without ``cfg.use_rope`` (NoPE) q and k carry no positions; the scores
    are scaled by ``cfg.attn_scale`` where the config sets it."""
    with spans.span(spans.ATTENTION):
        h, hd = cfg.n_heads, cfg.hd()
        b = x.shape[0]
        q, k, v = _qkv(p, x, cfg)
        if cfg.use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        scale = cfg.attn_scale
        if kv_cache is None:
            am = _ambient_mesh()
            t = q.shape[1]
            if cfg.attn_seq_shard and am is not None and "model" in am.mesh_dim_names \
                    and t % sharding.mesh_sizes(am)["model"] == 0:
                out = seq_sharded_attention(q, k, v, attn_chunk=cfg.attn_chunk, scale=scale)
            else:
                out = prefill_attention(q, k, v, q_block=q_block, attn_chunk=cfg.attn_chunk,
                                        scale=scale)
            new_cache = (k, v)
        else:
            kc, vc = kv_cache
            idx = cache_len - 1
            if not 0 <= idx < kc.shape[1]:
                raise ValueError(f"KV cache of {kc.shape[1]} positions has no room at {idx}; "
                                 "grow it first (launch/serve.py grow_cache)")
            kc[:, idx : idx + 1] = k
            vc[:, idx : idx + 1] = v
            out = decode_attention(q, kc, vc, cache_len, attn_chunk=cfg.attn_chunk, scale=scale)
            new_cache = (kc, vc)
        y = merge_heads(out) @ p["wo"]
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


def mlp_axes(gated: bool = True) -> dict:
    a = {"w_in": ("embed", "ff"), "w_out": ("ff", "embed")}
    if gated:
        a["w_gate"] = ("embed", "ff")
    return a


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


def moe_axes(cfg: ModelConfig) -> dict:
    a = {"router": ("embed", None), "w_gate": ("experts", "embed", "ff"),
         "w_in": ("experts", "embed", "ff"), "w_out": ("experts", "ff", "embed")}
    if cfg.shared_expert_ff:
        a["shared"] = mlp_axes()
    return a


def moe_route(router: torch.Tensor, rows: torch.Tensor, top_k: int):
    """(experts (..., k), renormalised probabilities (..., k) f32) of rows
    (..., D): the f32 router softmax, its top k, renormalised (the same
    numbers as a softmax over the top k logits)."""
    probs = torch.softmax(rows.float() @ router, dim=-1)
    # jax.lax.top_k breaks ties toward the lower index; torch.topk does not
    # promise an order among equal values (ties need exactly equal f32 probs)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    return top_e, top_p / top_p.sum(dim=-1, keepdim=True)


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
    top_e, top_p = moe_route(router, x, k)
    flat_e, flat_p = top_e.reshape(b, t * k), top_p.reshape(b, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    pos_in_e = torch.gather(torch.cumsum(F.one_hot(sorted_e, e), dim=1), 2,
                            sorted_e[..., None])[..., 0] - 1
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, e * cap)  # drop -> the sentinel row
    return Dispatch(cap, order // k, slot, keep, torch.gather(flat_p, 1, order))


def _moe_scatter(router, x, cfg: ModelConfig):
    """Route ``x`` and scatter-add its slots into the capacity buffer:
    (buf (b, e, cap, d), token_of, slot, weight) with ``weight`` the kept
    slots' probabilities (0 where dropped)."""
    b, t, d = x.shape
    e = cfg.n_experts
    dsp = moe_dispatch(router, x, cfg)
    rows = e * dsp.cap + 1
    base = torch.arange(b, device=x.device)[:, None]
    gathered = x[base, dsp.token_of]  # (b, t*k, d)
    buf = torch.zeros((b * rows, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, (dsp.slot + base * rows).reshape(-1), gathered.reshape(-1, d))
    buf = buf.view(b, rows, d)[:, :-1].reshape(b, e, dsp.cap, d)
    return buf, dsp.token_of, dsp.slot, dsp.probs * dsp.keep


def _moe_gather(out, token_of, slot, weight, t: int):
    """Gather each slot's expert output back (an appended zero row for the
    dropped), weight it and sum it into its token: (b, t, d)."""
    b, e, cap, d = out.shape
    out = torch.cat([out.reshape(b, e * cap, d), out.new_zeros((b, 1, d))], dim=1)
    vals = torch.gather(out, 1, slot[..., None].expand(-1, -1, d))  # (b, t*k, d)
    vals = vals * weight[..., None].to(vals.dtype)
    base = torch.arange(b, device=out.device)[:, None]
    y = torch.zeros((b * t, d), dtype=out.dtype, device=out.device)
    y.index_add_(0, (token_of + base * t).reshape(-1), vals.reshape(-1, d))
    return y.view(b, t, d)


def _per_batch_shard(fn, like, n_in: int, n_out: int, replicated_in: tuple = ()):
    """``fn`` run by ``local_map`` on each rank's batch rows: every operand
    and result sharded on dim 0 over the data axes where the batch divides
    (replicated over the other mesh dims, computed alike on each), except
    the inputs at ``replicated_in`` (weights), which are replicated and get
    a partial gradient over the split data axes.  ``fn`` itself off a
    mesh."""
    if not is_dtensor(like):
        return fn
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = like.device_mesh
    sizes = sharding.mesh_sizes(mesh)
    dp = _data_axes(mesh)
    split = bool(dp) and like.shape[0] % math.prod(sizes[a] for a in dp) == 0
    rows = [Shard(0) if split and n in dp else Replicate() for n in mesh.mesh_dim_names]
    rep = [Replicate()] * mesh.ndim
    part = [Partial() if split and n in dp else Replicate() for n in mesh.mesh_dim_names]
    ins = tuple(rep if i in replicated_in else rows for i in range(n_in))
    grads = tuple(part if i in replicated_in else rows for i in range(n_in))
    return local_map(fn, out_placements=(rows,) * n_out if n_out > 1 else rows,
                     in_placements=ins, in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def _moe_dropless(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Every routed slot of every token computed, none dropped: the b*t*k
    slots stably sorted by expert and their rows gathered, each expert's
    SwiGLU run on its contiguous segment by grouped products (one launch a
    projection; the segments' ends stay on the device, so nothing is read
    back), the outputs put back in (token, slot) order and each token's k
    outputs summed with its probabilities (rounded to ``x.dtype``, as the
    capacity path weights them) in one batched product that accumulates in
    f32.  Returns the routed part (b, t, d) in f32."""
    b, t, d = x.shape
    k = cfg.top_k
    rows = x.reshape(b * t, d)
    top_e, top_p = moe_route(p["router"], rows, k)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    experts = torch.arange(cfg.n_experts, device=x.device)
    ends = torch.searchsorted(flat_e[order], experts, right=True, out_int32=True)
    src = rows[order // k]  # (b*t*k, d), grouped by expert
    with spans.span(spans.MOE_EXPERTS):
        act = _swiglu(torch._grouped_mm(src, p["w_gate"], offs=ends),
                      torch._grouped_mm(src, p["w_in"], offs=ends))
        out = torch._grouped_mm(act, p["w_out"], offs=ends)
    slots = torch.empty_like(out).index_copy(0, order, out).view(b * t, k, d)
    y = torch.bmm(top_p.to(out.dtype).view(b * t, 1, k), slots)
    return y.view(b, t, d).float()


def moe_apply(p, x, cfg: ModelConfig):
    """Top-k MoE.  With ``cfg.moe_dropless``, every routed slot is computed
    (:func:`_moe_dropless`) and the shared expert is added in f32 before the
    one rounding to ``x.dtype``.  Otherwise capacity-based with sorted
    dispatch: scatter-add into an (E*C + 1, D) buffer per batch row (the last
    row the sentinel of dropped slots), the expert FFNs as batched products,
    then gather back with an appended zero row, weighted by the kept slots'
    probabilities.

    On DTensors the capacity path's routing, scatter and gather run on each
    rank's batch rows (``local_map``: the sort is along the unsharded T
    axis, as in the reference), and the expert products between them on
    the mesh, the expert weights sharded over experts or their ffn dim; the
    dropless path takes no DTensors."""
    with spans.span(spans.MOE):
        if cfg.moe_dropless:
            if is_dtensor(x):
                raise NotImplementedError(f"{cfg.name}: the dropless MoE runs on one device; "
                                          "its expert segments are not split over a mesh")
            y = _moe_dropless(p, x, cfg)
            if "shared" in p:
                y = y + mlp_apply(p["shared"], x)
            return y.to(x.dtype)
        t = x.shape[1]
        scatter = _per_batch_shard(lambda r, x: _moe_scatter(r, x, cfg), x, 2, 4, (0,))
        buf, token_of, slot, weight = scatter(p["router"], x)
        b, e, cap, d = buf.shape
        # the expert products as batched matmuls over e: (e, b*cap, d) x (e, d, ff)
        with spans.span(spans.MOE_EXPERTS):
            rows = buf.permute(1, 0, 2, 3).reshape(e, b * cap, d)
            act = _swiglu(torch.bmm(rows, p["w_gate"]), torch.bmm(rows, p["w_in"]))
            out = torch.bmm(act, p["w_out"]).reshape(e, b, cap, d).permute(1, 0, 2, 3)
        gather = _per_batch_shard(lambda o, i, s, w: _moe_gather(o, i, s, w, t), x, 4, 1)
        y = gather(out, token_of, slot, weight)
        if "shared" in p:
            y = y + mlp_apply(p["shared"], x)
        return y.to(x.dtype)
