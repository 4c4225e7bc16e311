"""The yardstick: the card's peaks, and the FLOPs and bytes that a step or a
kernel call needs, from shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3.

Model FLOPs count what the mathematics needs, not what an implementation
issues: 2 FLOPs per multiply-add of every projection (the embedding is a
lookup), the SSD scan's chunked form, and causal attention's QK^T and PV
over the T(T+1)/2 pairs it needs.  Training counts the forward pass once
and the backward pass (2x a projection's forward, and the SSD backward);
remat's recomputation is not counted.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _derived(m: dict) -> dict:
    d = m["d_model"]
    di = m["ssm_expand"] * d
    return dict(d=d, di=di, h=di // m["ssm_head_dim"], n=m["ssm_state"], p=m["ssm_head_dim"],
                q=m["ssm_chunk"], v=m["vocab"], layers=m["n_layers"],
                apps=m["n_layers"] // m["shared_attn_every"] if m["family"] == "hybrid" else 0,
                hq=m["n_heads"], kv=m["n_kv_heads"],
                hd=m.get("head_dim") or d // m["n_heads"], ff=m["d_ff"])


def layer_matmul_params(m: dict) -> int:
    """Weights of one Mamba-2 layer's projections: z, x, B, C, dt in, out."""
    s = _derived(m)
    return s["d"] * (2 * s["di"] + 2 * s["n"] + s["h"]) + s["di"] * s["d"]


def shared_matmul_params(m: dict) -> int:
    """Weights of the hybrid's shared block's projections (0 without one)."""
    s = _derived(m)
    if not s["apps"]:
        return 0
    attn = s["d"] * s["hq"] * s["hd"] + 2 * s["d"] * s["kv"] * s["hd"] + s["hq"] * s["hd"] * s["d"]
    return attn + 3 * s["d"] * s["ff"]


def ssd_fwd_flops(b: int, h: int, t: int, q: int, n: int, p: int) -> int:
    """The scan's forward: per batch row and chunk the lower triangle of
    C B^T (shared by the heads); per head and chunk the triangle's product
    with dt x, C h_prev and the state update.  (The same count as the
    port's ``kernels/ssd_scan.py`` ``ssd_flops``.)"""
    q = min(q, t)
    tri = q * (q + 1) // 2
    return (t // q) * (b * 2 * tri * n + b * h * (2 * tri * p + 4 * q * n * p))


def ssd_bwd_flops(b: int, h: int, t: int, q: int, n: int, p: int) -> int:
    """The scan's gradient: per batch row and chunk the triangle of C B^T;
    per head and chunk dY X^T, (L o G)^T dY, dG B, dG^T C over the
    triangle and four (q x n x p) products for the state gradients.  (The
    same count as the port's ``ssd_bwd_flops``.)"""
    q = min(q, t)
    tri = q * (q + 1) // 2
    return (t // q) * (b * 2 * tri * n + b * h * (4 * tri * p + 4 * tri * n + 8 * q * n * p))


def ssd_fwd_bytes(b: int, h: int, t: int, q: int, n: int, p: int, x_bytes: int,
                  keep_states: bool) -> int:
    """The forward operator's inputs read once and outputs written once:
    x, b, c (``x_bytes`` each element), dt and a (f32) in; y and the final
    state (f32) out, and with ``keep_states`` the state entering each chunk
    (f32, for the backward)."""
    ins = (b * t * h * p + 2 * b * t * n) * x_bytes + 4 * (b * t * h + h)
    outs = 4 * (b * t * h * p + b * h * n * p)
    if keep_states:
        outs += 4 * b * (t // min(q, t)) * h * n * p
    return ins + outs


def ssd_bwd_bytes(b: int, h: int, t: int, q: int, n: int, p: int, x_bytes: int) -> int:
    """The backward operator's inputs read once (x, b, c, dt, a, dy f32 and
    the kept chunk states) and outputs written once (dx, db, dc in x's type,
    ddt and da f32)."""
    ins = ((b * t * h * p + 2 * b * t * n) * x_bytes + 4 * (b * t * h + h)
           + 4 * b * t * h * p + 4 * b * (t // min(q, t)) * h * n * p)
    outs = (b * t * h * p + 2 * b * t * n) * x_bytes + 4 * (b * t * h + h)
    return ins + outs


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def attention_flops(t: int, heads: int, hd: int) -> int:
    """Causal attention of one sequence: QK^T and PV over T(T+1)/2 pairs."""
    return 2 * 2 * hd * heads * t * (t + 1) // 2


def train_flops_per_token(m: dict, t: int) -> float:
    """Model FLOPs of a training step per token of sequences of ``t``."""
    s = _derived(m)
    proj = s["layers"] * layer_matmul_params(m) + s["apps"] * shared_matmul_params(m) \
        + s["d"] * s["v"]
    ssd = s["layers"] * (ssd_fwd_flops(1, s["h"], t, s["q"], s["n"], s["p"])
                         + ssd_bwd_flops(1, s["h"], t, s["q"], s["n"], s["p"]))
    attn = 3 * s["apps"] * attention_flops(t, s["hq"], s["hd"])
    return 6 * proj + (ssd + attn) / t


def prefill_flops_per_token(m: dict, t: int) -> float:
    """Model FLOPs of a prefill per prompt token of prompts of ``t``: the
    layers at every position, the head on the last position only."""
    s = _derived(m)
    proj = s["layers"] * layer_matmul_params(m) + s["apps"] * shared_matmul_params(m)
    ssd = s["layers"] * ssd_fwd_flops(1, s["h"], t, s["q"], s["n"], s["p"])
    attn = s["apps"] * attention_flops(t, s["hq"], s["hd"])
    return 2 * proj + (2 * s["d"] * s["v"] + ssd + attn) / t
