"""Named spans at the port's layer boundaries, on the host and device clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records, so the span lands on the profiler's host timeline, which kineto
aligns with the CUPTI device timeline: a traced run can put device time and
idle gaps down to the layer that launched them.  With no profiler recording
it is one shared ``nullcontext``, about a microsecond a use, and the work
launched and its numbers are the same either way.

Every span name the program opens is one of the constants below; each says
what it encloses and which per-layer metric of the benchmark reads it
(``port_bench/metrics/<metric>.py``).

This module must not import anything from ``port_bench``: the benchmark
reads the program, never the other way round.
"""
from __future__ import annotations

import contextlib

import torch

# The forward of a train step (``train/steps.py value_and_grad``, around
# ``functional_call(model, ..., ("loss", batch))``): ``forward_ms.train``,
# ``launches.train``.
FORWARD = "repro_torch.forward"
# The backward of a train step, remat's recompute included (the same
# function, around ``torch.autograd.grad``): ``backward_ms.train``,
# ``remat_ms.train``, ``launches.train``.
BACKWARD = "repro_torch.backward"
# The optimizer step (``optim/adamw.py apply_updates``): ``launches.train``.
ADAMW = "repro_torch.adamw"
# One Mamba-2 block, projections to out-projection (``models/mamba2.py
# mamba_apply``); opened again by remat's recompute inside the backward:
# ``remat_ms.train``, ``mamba_outside_scan_share.prefill``,
# ``mamba_launches.prefill``.
MAMBA = "repro_torch.mamba"
# One attention application, QKV to out-projection (``models/layers.py
# attention_apply``): ``attention_share.prefill``.
ATTENTION = "repro_torch.attention"
# One batch of ``launch/serve.py serve``: assembly, copy to the device,
# prefill, cache growth, decode, every sync, the read-back:
# ``serve_idle_ms.prefill``.
SERVE = "repro_torch.serve"
# The model's prefill inside a ``SERVE`` span: ``serve_idle_ms.prefill``.
PREFILL = "repro_torch.prefill"

NAMES = (FORWARD, BACKWARD, ADAMW, MAMBA, ATTENTION, SERVE, PREFILL)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a span while a profiler
    records on this thread, and does nothing otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
