"""The prefill driver of a model with a layer pattern of Mamba-2 and
attention mixers and a MoE in every layer (family ``hybrid_moe``,
granite-4.0-h): the port's serving loop (``launch/serve.py`` ``serve()``)
with ``gen_len`` 1, so every call is one batched prefill through
``model.prefill``, and the loop, the kept call and the traced stretch of
``drivers/prefill.py``, whose helpers it imports.

What differs from that driver is what the model needs: its weights (the
Mamba-2 blocks are stacked over the Mamba layers alone), its FLOPs (the
active weights: ``top_k`` of the experts), the least time of the routed
experts' products, and the check against ``reference/granite_hybrid.py``:
the same three numbers as ``check.prefill_check``, over every SSD and conv
state and every attention layer's K and V.  The record's ``driver`` is
``"prefill"``, so that the prefill readers apply.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from port_bench import check, common, flops, trace as tracing
from port_bench.drivers.prefill import _Keep, _prompts
from port_bench.reference import granite_hybrid, mamba_lm
from port_bench.reference.control import fp8_round


# ------------------------------------------------------------------ weights

# The embedding's standard deviation: the stream starts at rms 12 x 0.05 =
# 0.6, of the size of what the 80 branches add.  Of 0.0183 (0.22 / 12),
# 0.05 and 0.1 read on the card, 0.05 put the fp8 control furthest above
# the program (x4.1 on ``cache``): smaller, the MoE's routing flips and
# the program's bf16 stream carry its error up to the control's; larger,
# the stream stays near the embedding.
EMBED_STD = 0.05


def make_weights(cfg, seed: int, device) -> dict:
    """The model's leaves drawn on ``device`` from ``seed`` with
    ``common._init``'s kinds and scales: one draw per leaf type for every
    normal leaf at once, one for each dt bias and A leaf (by leaf name,
    wherever the Mamba-2 blocks sit in the tree).

    The embedding alone is drawn at ``EMBED_STD``: at N(0, 1) the stream
    starts at 12 x the embedding, the branches, scaled by 0.22, barely move
    it, and the check does not see the experts."""
    from repro_torch.models.model import meta_model

    leaves_of = common.flat(meta_model(cfg).tree())
    gen = torch.Generator(device=device).manual_seed(seed)
    out: dict = {}
    normal: dict = {}
    special = []
    for name, like in sorted(leaves_of.items()):
        kind, scale = common._init(name, like.shape)
        if name == "embed":
            scale = EMBED_STD
        if kind == "normal":
            normal.setdefault(like.dtype, []).append((name, like, scale))
        elif kind in ("ones", "zeros"):
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(
                like.shape, dtype=like.dtype, device=device)
        else:
            special.append((name, kind))
    for dtype, leaves in sorted(normal.items(), key=lambda kv: str(kv[0])):
        total = sum(like.numel() for _, like, _ in leaves)
        buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for name, like, scale in leaves:
            out[name] = buf[off:off + like.numel()].view(like.shape).mul_(scale)
            off += like.numel()
    for name, kind in special:
        like = leaves_of[name]
        u = torch.rand(like.shape, generator=gen, dtype=torch.float32, device=device)
        if kind == "dt_bias":  # dt log-uniform in [1e-3, 1e-1], through the softplus
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            out[name] = (dt + torch.log(-torch.expm1(-dt))).to(like.dtype)
        else:                  # A uniform in [1, 16]
            out[name] = torch.log(1 + 15 * u).to(like.dtype)
    return out


# ---------------------------------------------------------------- yardstick

def _sizes(m: dict) -> dict:
    d = m["d_model"]
    di = m["ssm_expand"] * d
    hd = m.get("head_dim") or d // m["n_heads"]
    return dict(d=d, di=di, h=di // m["ssm_head_dim"], n=m["ssm_state"], p=m["ssm_head_dim"],
                q=m["ssm_chunk"], v=m["vocab"], layers=m["n_layers"],
                mamba=m["layer_types"].count("mamba"), attn=m["layer_types"].count("attention"),
                hq=m["n_heads"], kv=m["n_kv_heads"], hd=hd, ff=m["d_ff"], e=m["n_experts"],
                k=m["top_k"], shared=m["shared_expert_ff"])


def attention_matmul_params(m: dict) -> int:
    """Weights of one attention layer's projections: q, k, v, out."""
    s = _sizes(m)
    return 2 * s["d"] * s["hq"] * s["hd"] + 2 * s["d"] * s["kv"] * s["hd"]


def moe_active_params(m: dict) -> int:
    """Weights one token meets in one MoE layer: the router, ``top_k``
    experts' three projections and the shared expert's."""
    s = _sizes(m)
    return s["d"] * s["e"] + s["k"] * 3 * s["d"] * s["ff"] + 3 * s["d"] * s["shared"]


def prefill_flops_per_token(m: dict, t: int) -> float:
    """Model FLOPs of a prefill per prompt token of prompts of ``t``: 2 x the
    active weights (the Mamba layers' projections, the attention layers',
    and in every layer the router, ``top_k`` experts and the shared
    expert), the SSD forward and causal QK^T and PV at every position, the
    head on the last position only."""
    s = _sizes(m)
    proj = s["mamba"] * flops.layer_matmul_params(m) + s["attn"] * attention_matmul_params(m) \
        + s["layers"] * moe_active_params(m)
    ssd = s["mamba"] * flops.ssd_fwd_flops(1, s["h"], t, s["q"], s["n"], s["p"])
    attn = s["attn"] * flops.attention_flops(t, s["hq"], s["hd"])
    return 2 * proj + (2 * s["d"] * s["v"] + ssd + attn) / t


def moe_experts_flops(m: dict, tokens: int) -> int:
    """The routed experts' products in one MoE layer over ``tokens`` tokens:
    each of the tokens x ``top_k`` slots through one SwiGLU expert (three
    projections of d x ff), 2 FLOPs a multiply-add."""
    s = _sizes(m)
    return 2 * 3 * s["d"] * s["ff"] * tokens * s["k"]


def moe_experts_bytes(m: dict, tokens: int, x_bytes: int) -> int:
    """The same products' least traffic: every expert's weights read once,
    each slot's row read once and its output row written once."""
    s = _sizes(m)
    return (3 * s["e"] * s["d"] * s["ff"] + 2 * tokens * s["k"] * s["d"]) * x_bytes


# -------------------------------------------------------------------- check

def prefill_check(config: dict, weights: dict, prompts: torch.Tensor, logits: torch.Tensor,
                  cache: dict, served, quant=None) -> tuple[dict, dict | None]:
    """``check.prefill_check``'s numbers of one call's rows against
    ``reference/granite_hybrid.py``; with ``quant`` the control's second."""
    mamba_lm.exact_float32()
    s = granite_hybrid.Shape.of(config["model"])
    w = {k: v.detach() for k, v in weights.items()}
    prog = dict.fromkeys(("logits", "cache", "token_gap"), 0.0)
    ctrl = dict(prog) if quant is not None else None
    for r in range(prompts.shape[0]):
        ref = granite_hybrid.last_logits(w, prompts[r], s)
        row = {k: v[:, r] for k, v in cache.items() if k != "len"}
        check._compare(prog, logits[r], row, int(served[r]), *ref)
        if quant is not None:
            c_logits, c_cache = granite_hybrid.last_logits(w, prompts[r], s, quant)
            check._compare(ctrl, c_logits, c_cache, int(c_logits.argmax()), *ref)
    return prog, ctrl


def control_token_gap(config: dict, weights: dict, prompts: torch.Tensor, quant) -> float:
    """``check.control_token_gap`` against ``reference/granite_hybrid.py``."""
    mamba_lm.exact_float32()
    s = granite_hybrid.Shape.of(config["model"])
    w = {k: v.detach() for k, v in weights.items()}
    gap = 0.0
    for r in range(prompts.shape[0]):
        ref = granite_hybrid.all_logits(w, prompts[r], s)
        first = granite_hybrid.all_logits(w, prompts[r], s, quant).argmax(-1, keepdim=True)
        gap = max(gap, float((ref.max(-1).values - ref.gather(-1, first)[:, 0]).max()))
    return gap


# ------------------------------------------------------------------- faults

def _routing(change):
    """A fault that, for the length of each prefill, routes every MoE layer
    through ``change(experts, probabilities, n_experts)`` after the
    program's own routing (``models/layers.py`` ``moe_route``)."""
    def fault(prefill):
        from repro_torch.models import layers

        def faulty(tokens):
            route = layers.moe_route

            def wrong(router, rows, top_k):
                return change(*route(router, rows, top_k), router.shape[-1])

            layers.moe_route = wrong
            try:
                return prefill(tokens)
            finally:
                layers.moe_route = route
        return faulty
    return fault


# Faults of the MoE, beside ``faults.PREFILL``: the routed experts' outputs
# dropped (the shared expert alone), or every slot sent to the next expert.
FAULTS = {
    "routed_dropped": _routing(lambda e, p, n: (e, torch.zeros_like(p))),
    "experts_shifted": _routing(lambda e, p, n: ((e + 1) % n, p)),
}


# ---------------------------------------------------------------------- run

def _alloc_retries(dev) -> int:
    """The caching allocator's retries so far: each freed its cached blocks,
    synchronising the card, to make room for an allocation."""
    return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) if dev.type == "cuda" else 0


def run(cell: common.Cell, t_start: float, *, fault=None, control=False) -> common.Record:
    """One run, as ``drivers/prefill.py`` ``run``: ``fault`` wraps the
    model's ``prefill``, ``control`` also runs the control on the kept
    call's prompts (``notes["control"]``)."""
    from repro_torch.launch.serve import serve

    tr, dev = cell.traffic, torch.device(cell.device)
    cfg = common.port_config(cell.config)
    phases: dict = {}
    common.stamp(phases, "imports", t_start, dev)
    weights = make_weights(cfg, cell.seed, dev)
    common.stamp(phases, "weights", t_start, dev)
    model = common.port_model(cfg, weights)
    pool = _prompts(tr, cfg.vocab, cell.seed)
    keep = _Keep(model.prefill if fault is None else fault(model.prefill), cell.seed)
    model.prefill = keep
    batch, gen = tr["batch"], tr["gen_len"]
    common.stamp(phases, "model_and_prompts", t_start, dev)
    # Each warm-up call runs while the previous one's outputs are held, as a
    # window call runs beside the kept call: with the weights taking 64 GB,
    # the allocator's pool reaches its steady size here and not in the window.
    held = []

    def holding(tokens):
        held[:] = [keep(tokens)]
        return held[0]

    model.prefill = holding
    for i in range(tr["warmup_calls"]):
        serve(model, pool[i % len(pool)], batch=batch, gen_len=gen)
        common.stamp(phases, f"warmup_call_{i}", t_start, dev)
    model.prefill = keep
    held.clear()

    collections = common.Collections()
    common.reset_peak(dev)
    setup_s = time.perf_counter() - t_start
    keep.on = True
    served, tokens, calls = [], 0, 0
    marks = common.Marks(dev)
    retries = _alloc_retries(dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        marks.mark()
        st = serve(model, pool[(tr["warmup_calls"] + calls) % len(pool)], batch=batch,
                   gen_len=gen)
        served.append([int(o[0]) for o in st.outputs])
        tokens += st.prefill_tokens
        calls += 1
    marks.mark()
    window_s = time.perf_counter() - t0
    keep.on = False
    peak = common.peak(dev)

    m = cell.config["model"]
    rec = common.Record(
        driver="prefill", setup_s=setup_s, window_s=window_s, work=tokens,
        units=calls * batch, peak_bytes=peak,
        flops_per_token=prefill_flops_per_token(m, tr["prompt_len"]), numbers={})
    rec.notes["setup_phases"] = phases
    rec.notes["call_ms"] = marks.ms()
    rec.notes["alloc_retries"] = _alloc_retries(dev) - retries

    if cell.trace:
        from torch.profiler import record_function

        def traced():
            for i in range(tr["trace_calls"]):
                with record_function("bench.serve"):
                    serve(model, pool[(tr["warmup_calls"] + calls + i) % len(pool)],
                          batch=batch, gen_len=gen)

        rec.trace = tracing.capture(traced)
        rec.notes["traced_device_events"] = len(rec.trace.devices)
        rec.traced_units = tr["trace_calls"]
        x_bytes = common.dtype_bytes(cfg)
        shape = dict(b=batch, h=cfg.ssm_nheads, t=tr["prompt_len"], q=cfg.ssm_chunk,
                     n=cfg.ssm_state, p=cfg.ssm_head_dim)
        rec.ssd_calls = {"repro_torch::ssd_scan": flops.least_s(
            flops.ssd_fwd_flops(**shape),
            flops.ssd_fwd_bytes(**shape, x_bytes=x_bytes, keep_states=False))}
        routed = batch * tr["prompt_len"]
        rec.notes["moe_experts_least_s"] = flops.least_s(
            moe_experts_flops(m, routed), moe_experts_bytes(m, routed, x_bytes))

    rec.notes["gc"] = collections.close()
    index, logits, cache = keep.kept
    rec.notes["kept_call"] = index
    prompts = torch.from_numpy(np.stack(pool[(tr["warmup_calls"] + index) % len(pool)])).to(dev)
    del keep, model
    common.free(dev)
    t_ref = time.perf_counter()
    rec.numbers, ctrl = prefill_check(cell.config, weights, prompts, logits[:, 0], cache,
                                      served[index], quant=fp8_round if control else None)
    rec.notes["reference_s"] = time.perf_counter() - t_ref
    if control:
        del logits, cache
        ctrl["token_gap"] = control_token_gap(cell.config, weights, prompts, fp8_round)
        rec.notes["control"] = ctrl
    return rec
