"""The prefill driver: the port's serving loop (``launch/serve.py``
``serve()``) with ``gen_len`` 1, so every call is one batched prefill
through ``model.prefill`` whose caches then grow for decode.

Set-up draws the weights and a pool of prompts (numpy arrays of token ids,
what ``serve()`` takes; their copy to the card is part of the served path)
from the seed, and warms up with ``warmup_calls`` calls.  The window calls
``serve()`` with one batch's queue at a time until ``--seconds`` have
passed; ``serve()`` synchronises and reads its tokens back once a call, and
the benchmark adds nothing to that.  The benchmark observes the calls by
wrapping ``model.prefill`` and keeps the outputs (last logits and cache) of
one call of the window, drawn from the seed by reservoir sampling, with the
tokens that call served; holding one call's cache while the next runs is
what ``serve()`` itself does over a longer queue.  A traced run then makes
``trace_calls`` more calls under the profiler, each in the span
``bench.serve``.

After the window everything but the kept outputs and the weights is freed,
and the reference runs every prompt of the kept call.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from port_bench import check, common, flops, trace as tracing
from port_bench.reference.control import fp8_round


def _prompts(tr: dict, vocab: int, seed: int) -> list[list[np.ndarray]]:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (tr["pool"], tr["batch"], tr["prompt_len"]), dtype=np.int64)
    return [list(call) for call in ids]


class _Keep:
    """Reservoir of one ``model.prefill`` call, drawn from the seed."""

    def __init__(self, prefill, seed: int):
        self.prefill = prefill
        self.rng = random.Random(seed)
        self.on = False
        self.seen = 0
        self.kept = None      # (call index, logits, cache)

    def __call__(self, tokens):
        logits, cache = self.prefill(tokens)
        if self.on:
            if self.rng.randrange(self.seen + 1) == 0:
                self.kept = (self.seen, logits, cache)
            self.seen += 1
        return logits, cache


def run(cell: common.Cell, t_start: float, *, fault=None, control=False) -> common.Record:
    """One run.  For the readings that set the limits only: ``fault`` wraps
    the model's ``prefill`` (inside the benchmark's observer), and
    ``control`` also runs the control (the reference in fp8) on the kept
    call's prompts and puts its numbers in ``notes["control"]``."""
    from repro_torch.launch.serve import serve

    tr, dev = cell.traffic, torch.device(cell.device)
    cfg = common.port_config(cell.config)
    phases: dict = {}
    common.stamp(phases, "imports", t_start, dev)
    weights = common.make_weights(cfg, cell.seed, dev)
    common.stamp(phases, "weights", t_start, dev)
    model = common.port_model(cfg, weights)
    pool = _prompts(tr, cfg.vocab, cell.seed)
    keep = _Keep(model.prefill if fault is None else fault(model.prefill), cell.seed)
    model.prefill = keep
    batch, gen = tr["batch"], tr["gen_len"]
    common.stamp(phases, "model_and_prompts", t_start, dev)
    for i in range(tr["warmup_calls"]):
        serve(model, pool[i % len(pool)], batch=batch, gen_len=gen)
        common.stamp(phases, f"warmup_call_{i}", t_start, dev)

    collections = common.Collections()
    common.reset_peak(dev)
    setup_s = time.perf_counter() - t_start
    keep.on = True
    served, tokens, calls = [], 0, 0
    marks = common.Marks(dev)
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

    rec = common.Record(
        driver="prefill", setup_s=setup_s, window_s=window_s, work=tokens,
        units=calls * batch, peak_bytes=peak,
        flops_per_token=flops.prefill_flops_per_token(cell.config["model"], tr["prompt_len"]),
        numbers={})
    rec.notes["setup_phases"] = phases
    rec.notes["call_ms"] = marks.ms()

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
        shape = dict(b=batch, h=cfg.ssm_nheads, t=tr["prompt_len"], q=cfg.ssm_chunk,
                     n=cfg.ssm_state, p=cfg.ssm_head_dim)
        rec.ssd_calls = {"repro_torch::ssd_scan": flops.least_s(
            flops.ssd_fwd_flops(**shape),
            flops.ssd_fwd_bytes(**shape, x_bytes=common.dtype_bytes(cfg), keep_states=False))}

    rec.notes["gc"] = collections.close()
    index, logits, cache = keep.kept
    rec.notes["kept_call"] = index
    prompts = torch.from_numpy(np.stack(pool[(tr["warmup_calls"] + index) % len(pool)])).to(dev)
    del keep, model
    common.free(dev)
    t_ref = time.perf_counter()
    rec.numbers, ctrl = check.prefill_check(cell.config, weights, prompts, logits[:, 0], cache,
                                            served[index], quant=fp8_round if control else None)
    rec.notes["reference_s"] = time.perf_counter() - t_ref
    if control:
        del logits, cache
        ctrl["token_gap"] = check.control_token_gap(cell.config, weights, prompts, fp8_round)
        rec.notes["control"] = ctrl
    return rec
