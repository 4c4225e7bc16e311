"""A plain float32 Mamba-2 language model and the zamba2 hybrid.

Written from the published equations: Mamba-2 (arXiv 2405.21060, section 6
and listing 1) and, for the hybrid, one shared attention + MLP block applied
after every ``attn_every``-th Mamba-2 layer, as the configuration simplifies
Zamba2 (arXiv 2411.15242: one shared block, no LoRA, no concatenated
embedding).  No kernel, no cache manager, no batching: one sequence at a
time, every product in float32 with TF32 off.

Weights are a flat dict of tensors under the leaf names of the model under
test (``layers.block.w_z`` stacked over layers, ``embed``, ``lm_head``,
``shared.attn.wq`` ...), in the (in, out) layout, so a projection is
``x @ w``.  Each leaf is cast to float32 where it is used.

One sequence of T tokens:

  x = embed[tokens]
  per layer i:  x = x + Mamba2(rmsnorm(x, ln_i))
                (hybrid, i % every == every - 1:  x = Shared(x))
  logits = rmsnorm(x, final_norm) @ lm_head

  Mamba2(u): z, xs, B, C = u W_z, u W_x, u W_B, u W_C;  dt = softplus(u W_dt + dt_bias)
             xs, B, C = silu(causal depthwise conv([xs | B | C]) + bias)
             y = SSD(xs, dt, A = -exp(a_log), B, C) + D * xs
             out = rmsnorm(y * silu(z), norm) W_out
  SSD:       h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,  y_t = C_t . h_t
             (B and C shared by the heads: one group)
  Shared(x): x = x + Attn(rmsnorm(x, ln1));  x + SwiGLU(rmsnorm(x, ln2))
             causal softmax attention with rotary embeddings (half split)

``quant`` rounds the operands of every projection that the configuration
computes in its low precision (all but ``W_dt``, which is float32 there); the
identity by default.  The control passes an fp8 rounding
(``control.fp8_round``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def exact_float32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclasses.dataclass(frozen=True)
class Shape:
    """The sizes the reference needs, read from a configuration file's
    ``model`` block."""
    n_layers: int
    d_model: int
    vocab: int
    d_inner: int
    heads: int        # SSD heads
    head_dim: int     # P
    state: int        # N
    conv: int
    chunk: int
    eps: float
    hybrid: bool = False
    attn_every: int = 0
    attn_heads: int = 0
    attn_kv_heads: int = 0
    attn_head_dim: int = 0
    rope_theta: float = 10000.0

    @classmethod
    def of(cls, model: dict) -> "Shape":
        d_inner = model["ssm_expand"] * model["d_model"]
        hybrid = model["family"] == "hybrid"
        head_dim = model.get("head_dim") or model["d_model"] // model["n_heads"]
        return cls(
            n_layers=model["n_layers"], d_model=model["d_model"], vocab=model["vocab"],
            d_inner=d_inner, heads=d_inner // model["ssm_head_dim"],
            head_dim=model["ssm_head_dim"], state=model["ssm_state"],
            conv=model["ssm_conv"], chunk=model["ssm_chunk"],
            eps=model.get("norm_eps", 1e-6), hybrid=hybrid,
            attn_every=model.get("shared_attn_every", 0) if hybrid else 0,
            attn_heads=model["n_heads"] if hybrid else 0,
            attn_kv_heads=model["n_kv_heads"] if hybrid else 0,
            attn_head_dim=head_dim if hybrid else 0,
            rope_theta=model.get("rope_theta", 10000.0))

    def is_attn(self, layer: int) -> bool:
        return self.hybrid and layer % self.attn_every == self.attn_every - 1


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over time: u (T, C), w (W, C), b (C,);
    out_t = sum_j u_{t-W+1+j} w_j + b."""
    width, t = w.shape[0], u.shape[0]
    up = F.pad(u, (0, 0, width - 1, 0))
    out = b.float().expand(t, -1)
    for j in range(width):
        out = out + up[j:j + t] * w[j].float()
    return out


def ssd(x, dt, a, b, c, chunk: int):
    """The SSD scan of one sequence in its chunked (dual) form.

    x (T, H, P), dt (T, H), a (H,), b and c (T, N).  Returns y (T, H, P) and
    the final state h (H, N, P).  Within a chunk of Q steps, y = (L o C B^T)
    (dt x) with L_ls = exp(sum_{s<k<=l} dt_k a) for s <= l; across chunks
    the state is carried by the recurrence, one chunk at a time."""
    t, nh, p = x.shape
    n = b.shape[-1]
    q = min(chunk, t)
    nc = t // q
    xd = (x * dt[..., None]).reshape(nc, q, nh, p)
    acs = (dt * a).reshape(nc, q, nh).permute(2, 0, 1).cumsum(-1)        # (H, C, Q)
    bm, cm = b.reshape(nc, q, n), c.reshape(nc, q, n)
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = (acs[..., :, None] - acs[..., None, :]).masked_fill(~causal, -math.inf)
    decay = torch.exp(seg)                                                # (H, C, Q, Q)
    cb = torch.einsum("cln,csn->cls", cm, bm)
    y = torch.einsum("hcls,cshp->clhp", decay * cb, xd)
    to_end = torch.exp(acs[..., -1:] - acs)                               # (H, C, Q)
    states = torch.einsum("csn,hcs,cshp->chnp", bm, to_end, xd)           # (C, H, N, P)
    chunk_decay = torch.exp(acs[..., -1])                                 # (H, C)
    h = x.new_zeros(nh, n, p)
    entering = []
    for i in range(nc):
        entering.append(h)
        h = chunk_decay[:, i, None, None] * h + states[i]
    y = y + torch.einsum("cln,chnp,hcl->clhp", cm, torch.stack(entering), torch.exp(acs))
    return y.reshape(t, nh, p), h


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half split, positions 0..T-1; x (T, H, D)."""
    t, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None, None] * freqs
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x2 * torch.cos(ang) + x1 * torch.sin(ang)], dim=-1)


def _proj(x, w, quant):
    return quant(x) @ quant(w.float())


def mamba_layer(p: dict, u: torch.Tensor, s: Shape, quant=identity):
    """One Mamba-2 mixer on u (T, D), already normalised.  Returns (out,
    conv tail (W-1, C) of the conv's input, final SSD state (H, N, P))."""
    t = u.shape[0]
    di, n = s.d_inner, s.state
    z = _proj(u, p["w_z"], quant)
    conv_in = torch.cat([_proj(u, p["w_x"], quant), _proj(u, p["w_b"], quant),
                         _proj(u, p["w_c"], quant)], dim=-1)
    dt = F.softplus(u @ p["w_dt"].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    v = F.silu(causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs = v[:, :di].reshape(t, s.heads, s.head_dim)
    y, h = ssd(xs, dt, a, v[:, di:di + n], v[:, di + n:], s.chunk)
    y = y + xs * p["d_skip"].float()[:, None]
    y = rmsnorm(y.reshape(t, di) * F.silu(z), p["norm"], s.eps)
    return _proj(y, p["w_out"], quant), conv_in[t - (s.conv - 1):].clone(), h


def shared_block(p: dict, x: torch.Tensor, s: Shape, quant=identity):
    """The shared attention + SwiGLU block on x (T, D).  Returns (x, K, V),
    K rotated, K and V (T, KV, hd)."""
    t = x.shape[0]
    hq, kv, hd = s.attn_heads, s.attn_kv_heads, s.attn_head_dim
    u = rmsnorm(x, p["ln1"], s.eps)
    at = p["attn"]
    q = rope(_proj(u, at["wq"], quant).reshape(t, hq, hd), s.rope_theta)
    k = rope(_proj(u, at["wk"], quant).reshape(t, kv, hd), s.rope_theta)
    v = _proj(u, at["wv"], quant).reshape(t, kv, hd)
    group = hq // kv
    kq, vq = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    scores = torch.einsum("thd,shd->hts", q, kq) * hd ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    o = torch.einsum("hts,shd->thd", w, vq).reshape(t, hq * hd)
    x = x + _proj(o, at["wo"], quant)
    m = rmsnorm(x, p["ln2"], s.eps)
    mlp = p["mlp"]
    hidden = F.silu(_proj(m, mlp["w_gate"], quant)) * _proj(m, mlp["w_in"], quant)
    return x + _proj(hidden, mlp["w_out"], quant), k, v


def layer_params(weights: dict, i: int) -> dict:
    """Layer ``i``'s Mamba-2 leaves and its norm from the stacked leaves."""
    pre = "layers.block."
    p = {k[len(pre):]: v[i] for k, v in weights.items() if k.startswith(pre)}
    p["ln"] = weights["layers.ln"][i]
    return p


def shared_params(weights: dict) -> dict:
    return {"ln1": weights["shared.ln1"], "ln2": weights["shared.ln2"],
            "attn": {k: weights[f"shared.attn.{k}"] for k in ("wq", "wk", "wv", "wo")},
            "mlp": {k: weights[f"shared.mlp.{k}"] for k in ("w_in", "w_gate", "w_out")}}


def hidden(weights: dict, tokens: torch.Tensor, s: Shape, quant=identity, *,
           cache: dict | None = None, remat: bool = False) -> torch.Tensor:
    """The final normalised hidden states (T, D) of one sequence.  With
    ``cache`` (a dict) it receives per layer the conv tail and the SSD
    state, and per shared-block application K and V.  ``remat`` recomputes
    each layer in the backward pass (memory only)."""
    x = weights["embed"][tokens].float()
    shared = shared_params(weights) if s.hybrid else None
    if cache is not None:
        cache.update(conv=[], ssd=[], ak=[], av=[])
    for i in range(s.n_layers):
        p = layer_params(weights, i)

        def step(x, p=p):
            out, tail, h = mamba_layer(p, rmsnorm(x, p["ln"], s.eps), s, quant)
            return x + out, tail, h

        if remat:
            x, tail, h = checkpoint(step, x, use_reentrant=False)
        else:
            x, tail, h = step(x)
        if cache is not None:
            cache["conv"].append(tail)
            cache["ssd"].append(h)
        if s.is_attn(i):
            if remat:
                x, k, v = checkpoint(shared_block, shared, x, s, quant, use_reentrant=False)
            else:
                x, k, v = shared_block(shared, x, s, quant)
            if cache is not None:
                cache["ak"].append(k)
                cache["av"].append(v)
    return rmsnorm(x, weights["final_norm"], s.eps)


def last_logits(weights: dict, tokens: torch.Tensor, s: Shape, quant=identity):
    """(logits of the last position (V,), cache) of one prompt (T,)."""
    cache: dict = {}
    with torch.no_grad():
        x = hidden(weights, tokens, s, quant, cache=cache)
        logits = _proj(x[-1:], weights["lm_head"], quant)[0]
    return logits, cache


def all_logits(weights: dict, tokens: torch.Tensor, s: Shape, quant=identity):
    """The logits (T, V) of every position of one prompt (T,)."""
    with torch.no_grad():
        return _proj(hidden(weights, tokens, s, quant), weights["lm_head"], quant)


def sequence_loss(weights: dict, tokens: torch.Tensor, labels: torch.Tensor, s: Shape,
                  quant=identity) -> torch.Tensor:
    """Mean next-token cross-entropy of one sequence (T,), with remat."""
    x = hidden(weights, tokens, s, quant, remat=True)
    logits = _proj(x, weights["lm_head"], quant)
    return F.cross_entropy(logits, labels.long())
