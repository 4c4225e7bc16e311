"""Serving driver: batched prefill, then batched greedy decode, with the
batch refilled from a request queue.

The counterpart of the JAX package's ``launch/serve.py`` token path.  The
loop is :func:`serve`, which ``run()`` and ``chip_smoke.py`` both call: it
takes up to ``batch`` prompts from the queue (padding a short batch with
repeats of its last prompt, as the reference does), prefills them in one
call, decodes ``gen_len - 1`` more tokens step by step, and moves on to the
next batch until the queue is empty.  It reports prefill and decode tokens
and the time each phase took.

After prefill the KV caches (``k``, ``v``, and the hybrid's ``ak``, ``av``)
grow by ``gen_len`` positions along the sequence axis, as the reference's
loop pads them (:func:`grow_cache`); decode then writes into them in place.
A VLM is served without a vision prefix, as the reference serves it.  An
encoder-decoder cannot be served from tokens alone (its prefill needs frame
embeddings; the reference's loop fails there too): :func:`serve` raises
``ValueError`` for it.

The model is randomly initialised from ``--seed``; no weights are loaded.
``--smoke/--no-smoke`` picks the smoke-size or the full configuration (the
reference's ``--smoke`` cannot be turned off).  The default architecture is
the reference's, ``qwen2.5-3b``.

With ``--storage-sim`` the token loop is replaced by the storage-side view of
the same cell (:func:`run_storage_sim`): ``--jobs`` simulated training jobs
stream ``--saves`` erasure-coded checkpoint saves each through the async
block service (``repro_torch.service``) while latency-class serving reads run
alongside; the report is per-tenant tail latency on the virtual clock under
``--policy`` (``both`` prints the QoS-vs-FIFO comparison).  ``--device``
picks the device of the array's stripe codec; the virtual times do not
depend on it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu    # smoke size, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \\
      --prompt-len 1024 --gen-len 32                                 # full width, GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --storage-sim --policy both
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
from repro_torch.obs import spans


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


KV_CACHES = ("k", "v", "ak", "av")


def grow_cache(cache: dict, extra: int) -> dict:
    """Give each KV cache of ``cache`` ``extra`` more positions along its
    sequence axis (axis 2), zeroed, the prefix copied in: the reference's
    ``jnp.pad`` of the same caches, as one allocation that decode then
    writes into in place."""
    for key in KV_CACHES:
        if key in cache:
            old = cache[key]
            new = old.new_zeros((*old.shape[:2], old.shape[2] + extra, *old.shape[3:]))
            new[:, :, : old.shape[2]] = old
            cache[key] = new
    return cache


def serve(model, queue: Sequence[np.ndarray], *, batch: int, gen_len: int,
          choose: Callable[[torch.Tensor], torch.Tensor] = greedy) -> ServeStats:
    """Serve every prompt of ``queue`` (1-d token arrays of one length).

    ``choose`` maps each step's logits (B,1,V) to the next tokens (B,1);
    greedy by default (a test may force the tokens).  Phase times end in a
    device synchronisation, so they hold the device's work."""
    if model.cfg.family == "encdec":
        raise ValueError(f"{model.cfg.name}: an encoder-decoder cannot be served from tokens "
                         "alone; its prefill needs frame embeddings")
    dev = model.device
    pending = list(queue)
    st = ServeStats()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    while pending:
        with spans.span(spans.SERVE):
            take = [pending.pop(0) for _ in range(min(batch, len(pending)))]
            prompts = take + [take[-1]] * (batch - len(take))  # pad batch with repeats
            tokens = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
            sync()
            t0 = time.perf_counter()
            with spans.span(spans.PREFILL):
                logits, cache = model.prefill(tokens)
            grow_cache(cache, gen_len)
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


def run_storage_sim(args) -> dict:
    """Checkpoint traffic at scale under serving, on the virtual clock.
    Prints the reference's report lines; returns the results by policy."""
    from repro_torch.service.scenario import checkpoint_under_serving

    policies = ("qos", "fifo") if args.policy == "both" else (args.policy,)
    results = {}
    for pol in policies:
        res = checkpoint_under_serving(
            policy=pol, n_jobs=args.jobs, n_saves=args.saves, seed=args.seed,
            device=args.device,
        )
        results[pol] = res
        ten = res["summary"]["tenants"]
        print(
            f"[{pol:4s}] serve read p50 {res['serve_p50_us']:7.1f}us "
            f"p99 {res['serve_p99_us']:7.1f}us (n={res['serve_n']}) | "
            f"ckpt save mean {res['ckpt_save_mean_us']:8.1f}us "
            f"max {res['ckpt_save_max_us']:8.1f}us | "
            f"restore bit-identical: {res['restore_ok']}"
        )
        for name in sorted(ten):
            t = ten[name]
            print(
                f"       {name:6s} class={t['qos']:10s} accepted={t['accepted']:4d} "
                f"rejected={t['rejected']:3d} completed={t['completed']:4d}"
            )
    if len(results) == 2:
        gain = results["fifo"]["serve_p99_us"] / results["qos"]["serve_p99_us"]
        print(f"QoS cuts the serving tenant's read p99 by {gain:.1f}x vs FIFO")
    return results


def run(argv=None) -> ServeStats | dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--storage-sim", action="store_true",
                    help="run the checkpoint-under-serving storage scenario")
    ap.add_argument("--policy", default="both", choices=("qos", "fifo", "both"))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--saves", type=int, default=2)
    args = ap.parse_args(argv)

    if args.storage_sim:
        check_device(args.device)
        return run_storage_sim(args)

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
