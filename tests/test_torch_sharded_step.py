"""One train step on a real 4-rank (2, 2) device mesh equals the unsharded
step, on the CPU: gloo, four processes, the port's params, AdamW state and
batch distributed as DTensors by ``param_specs``, ``state_specs`` and
``batch_specs``.  Smoke qwen2.5-3b with its query time sharded over "model"
(``attn_seq_shard``), smoke grok-1-314b with FSDP and the per-layer weight
gather, and smoke mamba2-1.3b (the SSD scan per shard, heads over
"model").  Some parameter must really be split.

The sharded step's loss, gradient norm and new moments (m and v: its
gradients) must agree with the unsharded step's within ``TOL`` of each
leaf's largest value (f32; the two sum in different orders).  The new
parameters and master weights are held the way ``test_torch_train.py``
holds the reference's: the sharded ZeRO-1 update from the unsharded step's
gradients against the unsharded update, within ``TOL``.  (Adam's first step
is ~lr * sign(g), so a leaf whose gradient is rounding noise -- ``bk``, to
which softmax is blind -- takes a noise-sized difference in g to a
step-sized one in the parameter.)"""
import socket
import time

import pytest
import torch
import torch.multiprocessing as mp

TOL = 1e-5
WORLD = 4
CASES = {
    "qwen2.5-3b": dict(attn_seq_shard=True),
    "grok-1-314b": dict(fsdp=True, fsdp_gather=True),
    "mamba2-1.3b": dict(),
}
BATCH = dict(global_batch=4, seq_len=16)
JOIN_S = 240


def _rel(got, want) -> float:
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / max(scale, 1e-30) if want.numel() else 0.0


def _worker(rank: int, port: int, arch: str, overrides: dict) -> None:
    import torch.distributed as dist

    from repro_torch.checkpoint import _tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step, batch_specs
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.config import smoke
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig, state_specs
    from repro_torch.train import steps

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_host_mesh(model_parallel=2, device_type="cpu")
        cfg = smoke(get_config(arch), **overrides)
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
        model, step = steps.make_train_step(cfg, opt_cfg, device="cpu",
                                            generator=torch.Generator().manual_seed(0))
        params = steps.params_of(model)
        opt = steps.init_opt_state(model, params, opt_cfg)
        dc = DataConfig(BATCH["global_batch"], BATCH["seq_len"], cfg.vocab)
        batch = batch_for_step(dc, cfg, 0, device="cpu")
        _, want_o, want_m = step(params, opt, batch)

        pspecs = sh.param_specs(params, model.axes(), mesh, fsdp=cfg.fsdp)
        ospecs = state_specs(pspecs, params, mesh)
        dparams = sh.distribute(params, mesh, pspecs)
        split = [name for name, p in _tree.flatten_with_path(dparams)[0]
                 if any(type(pl).__name__ == "Shard" for pl in p.placements)]
        assert split, f"{arch}: no parameter is split over the mesh"
        seq_calls = []
        real = L.seq_sharded_attention
        L.seq_sharded_attention = lambda *a, **k: seq_calls.append(1) or real(*a, **k)
        try:
            with sh.use_mesh(mesh):
                _, got_o, got_m = step(dparams, sh.distribute(opt, mesh, ospecs),
                                           sh.distribute(batch, mesh, batch_specs(dc, cfg, mesh)))
        finally:
            L.seq_sharded_attention = real
        assert bool(seq_calls) == bool(cfg.attn_seq_shard), (arch, len(seq_calls))

        def full(x):
            return x.full_tensor() if hasattr(x, "full_tensor") else x

        def check(got, want, what):
            for (name, w), g in zip(_tree.flatten_with_path(want)[0], _tree.leaves(got)):
                err = _rel(full(g).float(), w.float())
                assert err <= TOL, (arch, what, name, err)

        for key in ("loss", "grad_norm"):
            err = _rel(full(got_m[key]), want_m[key])
            assert err <= TOL, (arch, key, err)
        for key in ("m", "v"):
            check(got_o[key], want_o[key], f"step {key}")
        assert int(full(got_o["step"])) == int(want_o["step"]) == 1
        # the ZeRO-1 update on the mesh from the unsharded step's gradients
        _, grads = steps.value_and_grad(model, params, batch)
        new_p, new_o, _ = adamw.apply_updates(opt_cfg, params, grads, opt)
        with sh.use_mesh(mesh):
            got_p, got_o, _ = adamw.apply_updates(opt_cfg, dparams,
                                                  sh.distribute(grads, mesh, pspecs),
                                                  sh.distribute(opt, mesh, ospecs))
        check(got_p, new_p, "update params")
        for key in ("master", "m", "v"):
            check(got_o[key], new_o[key], f"update {key}")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_train_step_equals_the_unsharded_one(arch, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ctx = mp.spawn(_worker, args=(_free_port(), arch, CASES[arch]), nprocs=WORLD,
                   join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{arch}: the 4-rank step did not finish in {JOIN_S} s")
