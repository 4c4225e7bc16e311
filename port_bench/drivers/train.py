"""The training driver: the port's train step (``train/steps.py``
``make_train_step``, what ``launch/train.py`` runs) on seeded token
batches, AdamW with float32 masters.

Set-up builds one train state (the model on the seeded weights, its
parameters and optimizer state) and drives it through the first
``check_steps`` steps by the window's own call on the window's own feed, on
batches whose rows all differ; they are the warm-up too.  From them it
keeps, on the card, each step's loss, each leaf's norm of the first
gradient as the optimizer got it (m after one step over 1 - b1) and, after
the last of them, each leaf's norm of the change of its float32 master.
The same state takes one more step, so the caching allocator settles after
the readings, and then trains for the window: nothing is read back to the
host until a synchronisation after the last step.  A traced run then takes
``trace_steps`` more steps under the profiler, calling the two halves of
the step, ``steps.value_and_grad`` and ``adamw.apply_updates``, each in
its own span.

After the window the state is freed and the reference follows the same
``check_steps`` steps from the same weights and batches
(``port_bench/reference``), in float32, one sequence at a time.
"""
from __future__ import annotations

import time

import torch

from port_bench import check, common, flops, trace as tracing
from port_bench.reference.control import fp8_round


def _batches(tr: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """(pool, batch, seq_len + 1) token ids from the seed, on the card."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randint(0, vocab, (tr["pool"], tr["batch"], tr["seq_len"] + 1),
                         generator=gen, device=device)


def _batch(pool: torch.Tensor, i: int) -> dict:
    rows = pool[i % pool.shape[0]]
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _norms(flat: dict) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(v.float()) for v in flat.values()])


def run(cell: common.Cell, t_start: float, *, fault=None, control=False) -> common.Record:
    """One run.  For the readings that set the limits only: ``fault`` wraps
    the train step, and ``control`` also runs the control (the reference in
    fp8) and puts its numbers in ``notes["control"]``."""
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    tr, dev = cell.traffic, torch.device(cell.device)
    cfg = common.port_config(cell.config)
    opt_cfg = adamw.AdamWConfig(**tr["optimizer"])
    phases: dict = {}
    common.stamp(phases, "imports", t_start, dev)
    weights = common.make_weights(cfg, cell.seed, dev)
    common.stamp(phases, "weights", t_start, dev)
    model = common.port_model(cfg, weights)
    model, train_step = steps.make_train_step(cfg, opt_cfg, device=dev, model=model)
    if fault is not None:
        train_step = fault(train_step)
    params = steps.params_of(model)
    opt = steps.init_opt_state(model, params, opt_cfg)
    pool = _batches(tr, cfg.vocab, cell.seed, dev)
    common.stamp(phases, "state_and_batches", t_start, dev)
    n_check = tr["check_steps"]

    losses = []
    for i in range(n_check):
        params, opt, met = train_step(params, opt, _batch(pool, i))
        losses.append(met["loss"])
        if i == 0:
            m1 = common.flat(opt["m"])
            grad_norms = _norms({k: m1[k] for k in weights}) / (1 - opt_cfg.b1)
            del m1
    master = common.flat(opt["master"])
    change = _norms({k: master[k] - w.float() for k, w in weights.items()})
    program = {"losses": torch.stack(losses).tolist(),
               "grad": dict(zip(weights, grad_norms.tolist())),
               "change": dict(zip(weights, change.tolist()))}
    del master
    common.stamp(phases, "check_steps", t_start, dev)
    # One more step after the readings: their temporaries leave the caching
    # allocator's blocks laid out otherwise than a step leaves them, and the
    # window's first step would pay for that.
    params, opt, met = train_step(params, opt, _batch(pool, n_check))
    first = n_check + 1
    common.stamp(phases, "settle_step", t_start, dev)

    tokens = tr["batch"] * tr["seq_len"]
    collections = common.Collections()
    common.reset_peak(dev)
    setup_s = time.perf_counter() - t_start
    window_losses = []
    done = 0
    marks = common.Marks(dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        marks.mark()
        params, opt, met = train_step(params, opt, _batch(pool, first + done))
        window_losses.append(met["loss"])
        done += 1
    marks.mark()
    common.sync(dev)
    window_s = time.perf_counter() - t0
    peak = common.peak(dev)

    rec = common.Record(
        driver="train", setup_s=setup_s, window_s=window_s, work=done * tokens, units=done,
        peak_bytes=peak, flops_per_token=flops.train_flops_per_token(cell.config["model"],
                                                                     tr["seq_len"]),
        numbers={})
    rec.notes["setup_phases"] = phases
    rec.notes["last_window_loss"] = float(window_losses[-1])
    rec.notes["step_ms"] = marks.ms()

    if cell.trace:
        from torch.profiler import record_function

        def traced():
            nonlocal params, opt
            for i in range(tr["trace_steps"]):
                with record_function("bench.step"):
                    batch = _batch(pool, first + done + i)
                    with record_function("bench.value_and_grad"):
                        loss, grads = steps.value_and_grad(model, params, batch)
                    with record_function("bench.apply_updates"):
                        params, opt, _ = adamw.apply_updates(opt_cfg, params, grads, opt)
                    del loss, grads

        rec.trace = tracing.capture(traced)
        rec.notes["traced_device_events"] = len(rec.trace.devices)
        rec.traced_units = tr["trace_steps"]
        shape = dict(b=tr["batch"], h=cfg.ssm_nheads, t=tr["seq_len"], q=cfg.ssm_chunk,
                     n=cfg.ssm_state, p=cfg.ssm_head_dim)
        xb = common.dtype_bytes(cfg)
        rec.ssd_calls = {
            "repro_torch::ssd_scan": flops.least_s(
                flops.ssd_fwd_flops(**shape), flops.ssd_fwd_bytes(**shape, x_bytes=xb,
                                                                 keep_states=True)),
            "repro_torch::ssd_scan_bwd": flops.least_s(
                flops.ssd_bwd_flops(**shape), flops.ssd_bwd_bytes(**shape, x_bytes=xb)),
        }

    rec.notes["gc"] = collections.close()
    del params, opt, met, train_step, window_losses, losses
    del model
    common.free(dev)
    batches = [_batch(pool, i) for i in range(n_check)]
    t_ref = time.perf_counter()
    reference = check.reference_train(cell.config, weights, batches, tr["optimizer"])
    rec.notes["reference_s"] = time.perf_counter() - t_ref
    rec.numbers = check.train_numbers(program, reference)
    rec.notes["program"] = program
    rec.notes["reference"] = {k: reference[k] for k in ("losses", "grad", "change")}
    if control:
        ctrl = check.reference_train(cell.config, weights, batches, tr["optimizer"],
                                     quant=fp8_round)
        rec.notes["control"] = check.train_numbers(ctrl, reference)
    return rec
