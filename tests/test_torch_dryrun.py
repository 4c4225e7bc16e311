"""The port's dry run (``launch/{shapes,dryrun}.py``, ``analysis/roofline.py``)
against the JAX package's.

The shape cells, their support and the model FLOPs per step must be the
reference's; the per-device parameter and state bytes of every (arch, shape,
mesh) cell must equal the reference's ``_dev_bytes`` exactly (both are spec
arithmetic on shapes); the ring costs of the collectives must be those
``analyze_hlo`` gives on an HLO text holding one of each.  Two cells run end
to end on a fake 256-way mesh at smoke width on the CPU."""
import dataclasses
import functools
import json
import math
import os

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.analysis import roofline as jroof
from repro.configs import ARCHS
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as jsh
from repro.launch import shapes as jshapes
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.analysis import roofline as roof
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import smoke

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _jdryrun():
    """The reference's dry-run module; importing it sets ``XLA_FLAGS`` to
    fake 512 host devices, which is put back."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdryrun


@pytest.fixture
def fresh_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_shape_cells_and_support_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.LONG_CONTEXT_FAMILIES == jshapes.LONG_CONTEXT_FAMILIES
    for arch in ARCHS:
        for name in shapes.SHAPES:
            assert shapes.cell_supported(get_config(arch), name) == \
                jshapes.cell_supported(j_get_config(arch), name)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, cell in shapes.SHAPES.items():
        jcell = jshapes.SHAPES[name]
        assert roof.model_flops_per_step(cfg, cell) == jroof.model_flops_per_step(jcfg, jcell)
        if cell.kind == "decode":
            continue
        got = shapes.batch_struct(cfg, cell)
        want = jshapes.batch_struct(jcfg, jcell)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())


@functools.lru_cache(maxsize=None)
def _reference_bytes(arch, shape, multi_pod):
    """The reference dry run's param_dev_bytes and state_dev_bytes of a cell,
    from the same spec arithmetic, on an abstract mesh."""
    jd = _jdryrun()
    cfg = j_get_config(arch)
    cell = jshapes.SHAPES[shape]
    mesh = AbstractMesh(*MESHES[multi_pod])
    opt_cfg = jadamw.AdamWConfig()
    model, _ = jsteps.make_train_step(cfg, opt_cfg)
    tp = cfg.parallelism == "tp"
    param_shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pspecs = jsh.param_specs(param_shapes, model.axes(), mesh, fsdp=cfg.fsdp, tp=tp)
    param_bytes = jd._dev_bytes(param_shapes, pspecs, mesh)
    if cell.kind == "train":
        opt_shapes = jax.eval_shape(lambda p: jsteps.init_opt_state(model, p, opt_cfg),
                                    param_shapes)
        ospecs = jadamw.state_specs(pspecs, param_shapes, mesh, zero1=True)
        if "residual" in opt_shapes:
            ospecs["residual"] = ospecs["m"]
        return param_bytes, param_bytes + jd._dev_bytes(opt_shapes, ospecs, mesh)
    if cell.kind == "prefill":
        return param_bytes, param_bytes
    cache, _ = jshapes.decode_structs(model, cfg, cell)
    cspecs = jd._cache_specs(model, cfg, cache, mesh)
    return param_bytes, param_bytes + jd._dev_bytes(cache, cspecs, mesh)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dev_bytes_equal_the_reference_in_every_cell(fresh_group, arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    for shape, cell in shapes.SHAPES.items():
        got = dryrun.cell_inputs(get_config(arch), cell, mesh)
        want = _reference_bytes(arch, shape, multi_pod)
        assert (got["param_dev_bytes"], got["state_dev_bytes"]) == want, (arch, shape)


_HLO = """HloModule synthetic

ENTRY %main (p0: f32[1024,256]) -> f32[1024,256] {
  %p0 = f32[1024,256]{1,0} parameter(0)
  %ar = f32[1024,256]{1,0} all-reduce(f32[1024,256]{1,0} %p0), replica_groups=[16,16]<=[256], to_apply=%add
  %ag = bf16[4096,256]{1,0} all-gather(bf16[256,256]{1,0} %x), replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[64,256]{1,0} reduce-scatter(f32[1024,256]{1,0} %p0), replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add
  %a2a = bf16[512,128]{1,0} all-to-all(bf16[512,128]{1,0} %y), replica_groups=[32,8]<=[256], dimensions={0}
  %cp = f32[100]{0} collective-permute(f32[100]{0} %z), source_target_pairs={{0,1},{1,0}}
  ROOT %out = f32[1024,256]{1,0} add(%ar, %p0)
}
"""


def test_ring_costs_equal_the_reference():
    """Each collective's result bytes and group size give the wire bytes the
    reference's HLO analysis gives (its groups from ``replica_groups``)."""
    rep = jroof.analyze_hlo(_HLO, n_devices=256)
    cases = {"all-reduce": (1024 * 256 * 4, 16), "all-gather": (4096 * 256 * 2, 16),
             "reduce-scatter": (64 * 256 * 4, 16), "all-to-all": (512 * 128 * 2, 8),
             "collective-permute": (100 * 4, 256)}
    assert set(rep.collectives) == set(cases) == set(roof.COLLECTIVES)
    for op, (b, s) in cases.items():
        st = rep.collectives[op]
        assert st["count"] == 1 and st["bytes"] == b, op
        assert roof.ring_wire_bytes(op, b, s) == st["wire_bytes"], op
    assert roof.ring_wire_bytes("all-reduce", 8.0, 1) == 0.0


def test_recorder_counts_flops_bytes_and_collectives(fresh_group):
    """On a fake 4-rank mesh: a row-parallel matmul's FLOPs on the local
    shard, and the all-reduce DTensor issues for its partial sum."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    x = distribute_tensor(torch.empty((8, 64), device="meta"), mesh, [Shard(1)])
    w = distribute_tensor(torch.empty((64, 32), device="meta"), mesh, [Shard(0)])
    with roof.Recorder() as rec:
        y = (x @ w).redistribute(mesh, [Replicate()])
    assert tuple(y.to_local().shape) == (8, 32)
    assert rec.flops == 2 * 8 * 16 * 32
    st = rec.collectives["all-reduce"]
    assert (st.count, st.bytes, st.wire_bytes) == (1, 8 * 32 * 4, 2 * 8 * 32 * 4 * 3 / 4)
    report = rec.report(analytic_hbm_bytes=1e15)
    assert report.hbm_bytes == 1e15 and report.dominant() == "memory"
    assert report.to_dict()["dominant"] == "memory"


@pytest.mark.parametrize("arch,shape", [("smollm-135m", "train_4k"),
                                        ("mamba2-1.3b", "prefill_32k")])
def test_run_cell_at_smoke_width_on_a_256_way_mesh(fresh_group, tmp_path, arch, shape):
    small = smoke(get_config(arch))
    overrides = {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
                 if getattr(small, f.name) != getattr(get_config(arch), f.name)}
    r = dryrun.run_cell(arch, shape, False, tmp_path, cfg_overrides=overrides, device="cpu")
    assert r["status"] == "ok", r.get("traceback")
    assert r["n_devices"] == 256 and r["roofline"]["flops"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    ssd = r["ssd_calls"]["repro_torch.ssd_scan"]
    assert ssd == (small.n_layers if small.family == "ssm" else 0)
    assert (tmp_path / f"{arch}__{shape}__single.json").exists()
    # resumable: the file is read back, not run again
    again = dryrun.run_cell(arch, shape, False, tmp_path, device="cpu")
    assert again == json.loads((tmp_path / f"{arch}__{shape}__single.json").read_text())
    assert again["wall_s"] == r["wall_s"]


def _rank0_bytes(tree) -> int:
    """Rank 0's bytes of a tree of step inputs or outputs, from each leaf's
    global shape and placements: a ``Shard(d)`` over a mesh dim of size k
    leaves rank 0 the first ceil(n / k) of dim d's n (``torch.chunk``); a
    plain tensor is whole, anything else (a cache's ``len``) an int32."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.checkpoint import _tree

    total = 0
    for leaf in _tree.leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            total += 4
            continue
        shape = list(leaf.shape)
        if isinstance(leaf, DTensor):
            for k, p in zip(leaf.device_mesh.shape, leaf.placements):
                if isinstance(p, Shard):
                    shape[p.dim] = -(-shape[p.dim] // k)
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch,shape", [("smollm-135m", "train_4k"),
                                        ("mamba2-1.3b", "decode_32k")])
def test_run_cell_records_memory_analysis(fresh_group, tmp_path, arch, shape):
    """The cell records the reference's ``memory_analysis`` fields: the
    placed inputs' bytes on rank 0, the step's outputs' bytes, and the peak
    of the live bytes the recorded step allocated, less the outputs alive
    then; a train step gives back parameters and optimizer state laid out
    as it took them."""
    small = smoke(get_config(arch))
    overrides = {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
                 if getattr(small, f.name) != getattr(get_config(arch), f.name)}
    r = dryrun.run_cell(arch, shape, False, tmp_path, cfg_overrides=overrides, device="cpu")
    assert r["status"] == "ok", r.get("traceback")
    ma = r["memory_analysis"]
    assert set(ma) == {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes"}
    run = dryrun.cell_inputs(small, shapes.SHAPES[shape], make_production_mesh(device_type="cpu"))
    assert ma["argument_size_in_bytes"] == _rank0_bytes(run["args"])
    assert ma["temp_size_in_bytes"] > 0 and ma["output_size_in_bytes"] > 0
    if shape == "train_4k":  # (params, opt, batch) in, (params, opt, metrics) out
        state = _rank0_bytes(run["args"][:2])
        assert state <= ma["output_size_in_bytes"] < state + 1024


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_recorder_tallies_live_bytes_to_the_byte(device):
    """``Recorder``'s live bytes on a step whose allocations and frees are
    known: a and b live (8,000 B), a view of b and an in-place op on it
    allocate nothing, a freed, c taken (the peak: b + c = 10,000 B), c
    freed, e taken (5,000 B).  At the peak the outputs b and e held only
    b, so their part of it is 4,000 B."""
    rec = roof.Recorder()
    with rec:
        a = torch.ones(1000, device=device)  # 4,000 B
        b = a * 2  # 4,000 B
        view = b[::2]
        b.add_(1)
        view.mul_(3)
        assert rec.live_bytes == 8000
        del a
        assert rec.live_bytes == 4000
        c = torch.zeros(750, dtype=torch.float64, device=device)  # 6,000 B
        d = c.sum()  # 8 B, freed with c
        del c, d, view
        assert rec.live_bytes == 4000
        e = torch.empty(250, device=device)  # 1,000 B
    assert (rec.live_bytes, rec.peak_bytes) == (5000, 10008)
    assert rec.live_at_peak([b, e]) == 4000
    assert rec.live_at_peak({"e": e}) == 0
