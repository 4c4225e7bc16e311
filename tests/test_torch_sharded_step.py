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
step-sized one in the parameter.)

On the same harness, mamba2-1.3b's sharded state after that step goes
through the checkpoint engine and the state parity with DTensor leaves: the
manifest, the drive images and the parity rows must equal the reference's
on the same global values, and every restored or rebuilt leaf is a DTensor
placed as the saved one (``_ckpt_worker``)."""
import socket
import time

import jax.numpy as jnp
import numpy as np
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


# the checkpoint engine of tests/test_torch_checkpoint.py, and state parity
# over k rank trees (AdamW's master, m and v) with rank LOST rebuilt
CKPT = dict(n_lanes=4, scheme="raid5", group_size=8, block_bytes=512, zone_cap_blocks=256,
            n_zones=64, chunk_blocks=2)
CKPT_LOGICAL = 1 << 13
PARITY_RANKS = ("master", "m", "v")
LOST = 1


def _ckpt_worker(rank: int, port: int, out: str) -> None:
    """mamba2-1.3b's params and AdamW state after one sharded step on the
    (2, 2) mesh: saved, restored healthy, with lane 1 failed and after a
    crash remount (each leaf a DTensor placed as saved, its global value
    bit-equal); state parity with m = 1 and 2 over the master, m and v
    trees, rank ``LOST`` rebuilt.  Rank 0 writes the global values, the
    manifest, the drive images after the save and the parity rows to
    ``out`` for the reference to be held to."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import _tree
    from repro_torch.checkpoint.state_parity import encode_shards, reconstruct_shard
    from repro_torch.checkpoint.zapraid_ckpt import CheckpointConfig, CheckpointEngine
    from repro_torch.configs import get_config
    from repro_torch.core.zns import drive_images
    from repro_torch.data.pipeline import DataConfig, batch_for_step, batch_specs
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import smoke
    from repro_torch.optim.adamw import AdamWConfig, state_specs
    from repro_torch.train import steps

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_host_mesh(model_parallel=2, device_type="cpu")
        cfg = smoke(get_config("mamba2-1.3b"))
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
        model, step = steps.make_train_step(cfg, opt_cfg, device="cpu",
                                            generator=torch.Generator().manual_seed(0))
        params = steps.params_of(model)
        opt = steps.init_opt_state(model, params, opt_cfg)
        pspecs = sh.param_specs(params, model.axes(), mesh, fsdp=cfg.fsdp)
        dc = DataConfig(BATCH["global_batch"], BATCH["seq_len"], cfg.vocab)
        with sh.use_mesh(mesh):
            dparams, dopt, _ = step(
                sh.distribute(params, mesh, pspecs),
                sh.distribute(opt, mesh, state_specs(pspecs, params, mesh)),
                sh.distribute(batch_for_step(dc, cfg, 0, device="cpu"), mesh,
                              batch_specs(dc, cfg, mesh)))
        state = {"params": dparams, "opt": dopt}
        flat = _tree.flatten_with_path(state)[0]
        assert all(isinstance(leaf, DTensor) for _, leaf in flat)
        assert any(type(pl).__name__ == "Shard" for _, leaf in flat for pl in leaf.placements)

        def same(got, want, what):
            for (name, w), g in zip(_tree.flatten_with_path(want)[0], _tree.leaves(got)):
                assert isinstance(g, DTensor) and g.placements == w.placements, (what, name)
                assert g.device_mesh == w.device_mesh, (what, name)
                gf, wf = g.full_tensor(), w.full_tensor()
                assert gf.dtype == wf.dtype and torch.equal(gf, wf), (what, name)

        eng = CheckpointEngine(CheckpointConfig(**CKPT, device="cpu"), CKPT_LOGICAL)
        eng.save(1, state)
        dump = {"state": _tree.unflatten(_tree.structure(state),
                                         [leaf.full_tensor() for _, leaf in flat]),
                "manifest": eng._manifest_blocks(), "catalog": eng.catalog,
                "images": drive_images(eng.array.drives)}
        same(eng.restore(1, state), state, "restore")
        eng.fail_lane(1)
        same(eng.restore(1, state), state, "degraded restore")
        assert eng.array.stats.degraded_reads > 0
        eng = eng.crash_and_remount()
        same(eng.restore(1, state), state, "restore after a remount")

        ranks = [dopt[key] for key in PARITY_RANKS]
        for m in (1, 2):
            parity = encode_shards(ranks, m=m)
            assert all(type(p) is torch.Tensor for tree in parity for p in _tree.leaves(tree))
            dump[f"parity{m}"] = parity
            rec = reconstruct_shard(LOST, {r: t for r, t in enumerate(ranks) if r != LOST},
                                    parity, len(ranks))
            same(rec, ranks[LOST], f"rank {LOST} rebuilt, m={m}")
        if rank == 0:
            torch.save(dump, out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, args, what):
    ctx = mp.spawn(fn, args=(_free_port(), *args), nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{what}: the 4 ranks did not finish in {JOIN_S} s")


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_train_step_equals_the_unsharded_one(arch, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _spawn(_worker, (arch, CASES[arch]), arch)


def _jax_tree(tree):
    """A tree of torch tensors as jax arrays of the same dtype and bits."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def test_sharded_state_checkpoints_and_parity_as_the_reference(monkeypatch, tmp_path):
    from _port import JAX
    from repro_torch.checkpoint import _tree
    from repro_torch.core.zns import drive_images

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "rank0.pt"
    _spawn(_ckpt_worker, (str(out),), "sharded checkpoint")
    got = torch.load(out, weights_only=False)
    state = _jax_tree(got["state"])
    eng = JAX.ckpt.CheckpointEngine(JAX.ckpt.CheckpointConfig(**CKPT), CKPT_LOGICAL)
    eng.save(1, state)
    assert eng.catalog == got["catalog"]
    assert np.array_equal(eng._manifest_blocks(), got["manifest"])
    for ia, ib in zip(drive_images(eng.array.drives), got["images"], strict=True):
        for key in ia:
            assert np.array_equal(ia[key], ib[key]), key
    ranks = [state["opt"][key] for key in PARITY_RANKS]
    for m in (1, 2):
        want = JAX.parity.encode_shards(ranks, m=m, use_pallas=False)
        for w, g in zip(want, got[f"parity{m}"], strict=True):
            for (name, a), b in zip(_tree.flatten_with_path(w)[0], _tree.leaves(g)):
                assert np.asarray(a).tobytes() == b.numpy().tobytes(), (m, name)
