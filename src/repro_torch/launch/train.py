"""End-to-end training driver.

The counterpart of the JAX package's ``launch/train.py``: a training loop on
one device with

* the deterministic synthetic data pipeline (``data/pipeline.py``, the
  reference's batches),
* AdamW with f32 master weights (+ optional gradient compression),
* ZapRAID-backed checkpointing every ``--ckpt-every`` steps
  (``checkpoint/zapraid_ckpt.py``; its RAID-5 codec on ``--device``),
* failure injection (``--fail-lane N --fail-at S``): the lane fails after
  step S and later restores read through the degraded path,
* a crash-restart (``--restart-at S``): after step S the loop restores the
  newest checkpoint and trains on from it, so the loss trace repeats the
  steps after it and must repeat them exactly.

``run`` returns the loss of every step taken, repeated steps included, as
the reference's does.  The model starts from the port's seeded init (seed
0), or from ``init_params``, a reference parameter tree of numpy leaves
(``models/convert.py``), which makes the run the reference's.
``--smoke/--no-smoke`` picks the smoke-size or the full configuration (the
reference's ``--smoke`` cannot be turned off, so it always trains at smoke
size).  ``--device`` is ``cuda`` unless ``cpu`` is asked for.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --no-smoke \\
      --steps 4 --global-batch 4 --seq-len 1024                      # full width, GPU
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint.zapraid_ckpt import CheckpointConfig, CheckpointEngine
from repro_torch.configs import get_config
from repro_torch.core.raid import check_device
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.models import convert
from repro_torch.models.config import smoke
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_mod


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--compression", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--fail-lane", type=int, default=-1)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--restart-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def run(argv=None, *, init_params: dict | None = None, report: dict | None = None):
    """Train as the flags say; return the list of losses.

    ``report``, a dict, receives what a caller measures: ``step_s`` (wall
    seconds of each step, ending with the loss on the host), ``grad_norm``,
    ``tokens_per_step``, ``params`` (count), the ``engine`` stats and
    ``leaf_norms`` (the f32 norm of each final parameter, by its tree
    path)."""
    args = parse_args(argv)
    dev = check_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    opt_cfg = adamw.AdamWConfig(compression=args.compression, warmup_steps=10)
    model, train_step = steps_mod.make_train_step(cfg, opt_cfg, device=dev)
    if init_params is not None:
        convert.load_jax_params(model, init_params)
    params = steps_mod.params_of(model)
    opt_state = steps_mod.init_opt_state(model, params, opt_cfg)
    dc = DataConfig(args.global_batch, args.seq_len, cfg.vocab)

    engine = CheckpointEngine(
        CheckpointConfig(n_lanes=4, scheme="raid5", group_size=8, block_bytes=4096,
                         zone_cap_blocks=512, n_zones=96, device=str(dev)),
        logical_blocks=1 << 14,
    )
    rep = report if report is not None else {}
    rep.update(step_s=[], grad_norm=[], tokens_per_step=args.global_batch * args.seq_len,
               params=sum(p.numel() for p in model.parameters()))

    losses = []
    step = 0
    t0 = time.time()
    while step < args.steps:
        batch = batch_for_step(dc, cfg, step, device=dev)
        ts = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        rep["step_s"].append(time.perf_counter() - ts)
        rep["grad_norm"].append(float(metrics["grad_norm"]))
        step += 1
        if step % args.ckpt_every == 0:
            engine.save(step, {"params": params, "opt": opt_state})
            print(f"step {step}: loss={losses[-1]:.4f} (checkpointed)")
        else:
            print(f"step {step}: loss={losses[-1]:.4f}")

        if step == args.fail_at and args.fail_lane >= 0:
            print(f"!! injecting storage-lane failure: lane {args.fail_lane}")
            engine.fail_lane(args.fail_lane)

        if step == args.restart_at:
            print("!! simulating preemption: restore from latest checkpoint")
            args.restart_at = -1  # one-shot
            last = max(engine.catalog)
            restored = engine.restore(last, {"params": params, "opt": opt_state})
            params, opt_state = restored["params"], restored["opt"]
            step = last

    dt = time.time() - t0
    rep["engine"] = engine.stats()
    rep["leaf_norms"] = leaf_norms(params)
    print(f"done: {args.steps} steps in {dt:.1f}s; "
          f"final loss {losses[-1]:.4f}; ckpt stats: {engine.stats()}")
    return losses


def leaf_norms(params: dict) -> dict[str, float]:
    """{tree path: f32 norm} of a parameter tree (a DTensor's whole tensor)."""
    from repro_torch.checkpoint import _tree

    def whole(p):
        return p.full_tensor() if hasattr(p, "full_tensor") else p

    return {name: float(whole(p).float().norm()) for name, p in _tree.flatten_with_path(params)[0]}


if __name__ == "__main__":
    run()
