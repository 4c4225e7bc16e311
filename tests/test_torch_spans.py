"""The program's spans (``repro_torch/obs/spans.py``) on the CPU: a smoke-size
hybrid ``MambaLM`` with remat, under ``torch.profiler`` (CPU activity).

Each entry point opens its spans as often as the layers run: a train step
(``value_and_grad`` then ``apply_updates``) opens the forward, the backward
and AdamW once each, every Mamba-2 block twice (once more in remat's
recompute, inside the backward) and the shared attention once per
application; a prefill opens each block and application once; ``serve()``
opens one serve span per batch with one prefill span inside it.  With no
profiler recording, ``span()`` calls no ``record_function``; and the
outputs are bit-equal with the profiler on and off.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models.config import smoke
from repro_torch.models.model import build_model
from repro_torch.obs import spans
from repro_torch.optim import adamw
from repro_torch.train import steps

CFG = dataclasses.replace(smoke(get_config("zamba2-2.7b")), remat=True)
N_APPS = CFG.n_layers // CFG.shared_attn_every
BATCH, SEQ, N_BATCHES = 2, 16, 2


def _model():
    return build_model(CFG, device="cpu", generator=torch.Generator().manual_seed(0))


def _tokens(seed: int = 1) -> torch.Tensor:
    return torch.randint(0, CFG.vocab, (BATCH, SEQ + 1),
                         generator=torch.Generator().manual_seed(seed))


def _train(model):
    opt_cfg = adamw.AdamWConfig()
    params = steps.params_of(model)
    opt = steps.init_opt_state(model, params, opt_cfg)
    rows = _tokens()
    loss, grads = steps.value_and_grad(model, params, {"tokens": rows[:, :-1],
                                                       "labels": rows[:, 1:]})
    params, opt, _ = adamw.apply_updates(opt_cfg, params, grads, opt)
    return [loss, *steps._named(params).values(), *steps._named(opt["master"]).values()]


def _prefill(model):
    logits, cache = model.prefill(_tokens()[:, :-1])
    return [logits, cache["conv"], cache["ssd"], cache["ak"], cache["av"]]


def _serve(model):
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, CFG.vocab, (SEQ,)) for _ in range(BATCH * N_BATCHES)]
    st = serve(model, queue, batch=BATCH, gen_len=2)
    return [torch.from_numpy(np.stack(st.outputs))]


ENTRIES = {"train": _train, "prefill": _prefill, "serve": _serve}

# Spans each entry point opens, and how many of them begin inside
# ``BACKWARD`` (remat's recompute; the CPU runs the backward on the
# calling thread).
OPENS = {
    "train": ({spans.FORWARD: 1, spans.BACKWARD: 1, spans.ADAMW: 1,
               spans.MAMBA: 2 * CFG.n_layers, spans.ATTENTION: N_APPS},
              {spans.MAMBA: CFG.n_layers}),
    "prefill": ({spans.MAMBA: CFG.n_layers, spans.ATTENTION: N_APPS}, {}),
    "serve": ({spans.SERVE: N_BATCHES, spans.PREFILL: N_BATCHES,
               spans.MAMBA: (1 + 1) * CFG.n_layers * N_BATCHES,
               spans.ATTENTION: (1 + 1) * N_APPS * N_BATCHES}, {}),
}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name in spans.NAMES]


def _inside(e, outer) -> bool:
    return outer.time_range.start <= e.time_range.start and \
        e.time_range.end <= outer.time_range.end


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_open_at_the_layer_boundaries(entry):
    _, events = _profiled(lambda: ENTRIES[entry](_model()))
    want, in_backward = OPENS[entry]
    got = {n: sum(1 for e in events if e.name == n) for n in spans.NAMES}
    assert got == {n: want.get(n, 0) for n in spans.NAMES}
    backward = [e for e in events if e.name == spans.BACKWARD]
    for name, n in in_backward.items():
        assert sum(1 for e in events if e.name == name
                   and any(_inside(e, b) for b in backward)) == n
    if entry == "serve":
        served = [e for e in events if e.name == spans.SERVE]
        for p in (e for e in events if e.name == spans.PREFILL):
            assert sum(1 for s in served if _inside(p, s)) == 1


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_without_a_profiler_span_records_nothing(entry, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span(spans.MAMBA) is spans.span(spans.SERVE)
    ENTRIES[entry](_model())


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_outputs_are_bit_equal_with_the_profiler_on_and_off(entry):
    off = ENTRIES[entry](_model())
    on, events = _profiled(lambda: ENTRIES[entry](_model()))
    assert events
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
