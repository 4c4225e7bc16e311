"""Serving driver: batched prefill, then batched greedy decode, with the
batch refilled from a request queue.

The counterpart of the JAX package's ``launch/serve.py`` token path.  The
loop is :func:`serve`, which ``run()`` and ``chip_smoke.py`` both call: it
takes up to ``batch`` prompts from the queue (padding a short batch with
repeats of its last prompt, as the reference does), prefills them in one
call, decodes ``gen_len - 1`` more tokens step by step, and moves on to the
next batch until the queue is empty.  It reports prefill and decode tokens
and the time each phase took.

The model is randomly initialised from ``--seed``; no weights are loaded.
``--smoke/--no-smoke`` picks the smoke-size or the full configuration (the
reference's ``--smoke`` cannot be turned off).  The default architecture is
``mamba2-1.3b``, the one family the port runs.  The reference's
``--storage-sim`` scenario is not ported yet.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu    # smoke size, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
      --prompt-len 1024 --gen-len 32                                 # full width, GPU
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.raid import check_device
from repro_torch.models.config import smoke
from repro_torch.models.model import build_model


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    prefill_calls: int = 0
    prefill_tokens: int = 0   # batch x prompt length, padding slots included
    decode_tokens: int = 0    # batch x (gen_len - 1)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    outputs: list = dataclasses.field(default_factory=list)  # (gen_len,) per request

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next token of each row: argmax of the last position, (B, 1)."""
    return logits[:, -1].argmax(-1, keepdim=True)


def serve(model, queue: Sequence[np.ndarray], *, batch: int, gen_len: int,
          choose: Callable[[torch.Tensor], torch.Tensor] = greedy) -> ServeStats:
    """Serve every prompt of ``queue`` (1-d token arrays of one length).

    ``choose`` maps each step's logits (B,1,V) to the next tokens (B,1);
    greedy by default (a test may force the tokens).  Phase times end in a
    device synchronisation, so they hold the device's work."""
    dev = model.device
    pending = list(queue)
    st = ServeStats()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    while pending:
        take = [pending.pop(0) for _ in range(min(batch, len(pending)))]
        prompts = take + [take[-1]] * (batch - len(take))  # pad batch with repeats
        tokens = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(tokens)
        sync()
        t1 = time.perf_counter()
        st.prefill_s += t1 - t0
        st.prefill_calls += 1
        st.prefill_tokens += tokens.numel()
        tok = choose(logits)
        outs = [tok]
        for _ in range(gen_len - 1):
            logits, cache = model.decode_step(cache, tok)
            tok = choose(logits)
            outs.append(tok)
            st.decode_tokens += tok.shape[0]
        sync()
        st.decode_s += time.perf_counter() - t1
        gen = torch.cat(outs, dim=1).cpu().numpy()
        st.outputs.extend(gen[: len(take)])
        st.requests += len(take)
    return st


def run(argv=None) -> ServeStats:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    dev = check_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)
    rng = np.random.default_rng(args.seed)
    queue = [rng.integers(0, cfg.vocab, (args.prompt_len,)) for _ in range(args.requests)]
    st = serve(model, queue, batch=args.batch, gen_len=args.gen_len)
    print(f"served {st.requests} requests of {cfg.name} on {dev} | "
          f"prefill {st.prefill_tok_s:.0f} tok/s | decode {st.decode_tok_s:.0f} tok/s")
    return st


if __name__ == "__main__":
    run()
