"""The port's sharding layer (``distributed/sharding.py``, ``Model.axes()``,
``optim.adamw.state_specs``, ``data.pipeline.batch_specs``, the dry run's
cache specs) against the JAX package's.

The reference's specs are built on a ``jax.sharding.AbstractMesh`` from
``jax.eval_shape`` shapes; the port's on a ``DeviceMesh`` over a ``fake``
process group of the same shape, from a model built on the meta device.
Every arch at full width on the 256-way (16, 16) and the 512-way
(2, 16, 16) production meshes: the spec trees must be equal leaf for leaf,
and each leaf's DTensor placements must give the local shape its spec
gives."""
import functools
import math
import os

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ARCHS
from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.distributed import sharding as jsh
from repro.launch import shapes as jshapes
from repro.models.model import build_model as j_build_model
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, shapes
from repro_torch.models.model import meta_model
from repro_torch.optim import adamw

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _reference_cache_specs():
    """The reference dry run's ``_cache_specs``; importing its module sets
    ``XLA_FLAGS`` to fake 512 host devices, which is put back."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdryrun._cache_specs


def fake_mesh(shape, names):
    """A DeviceMesh of ``shape`` over a fake process group of its size."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@pytest.fixture(params=list(MESHES))
def meshes(request):
    shape, names = MESHES[request.param]
    yield AbstractMesh(shape, names), fake_mesh(shape, names)
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _reference(arch):
    model = j_build_model(j_get_config(arch))
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0)), model.axes()


@functools.lru_cache(maxsize=None)
def _port(arch):
    model = meta_model(get_config(arch))
    return model, model.tree()


def _as_tuple(tree):
    """A spec or axes tree with every leaf a plain tuple (jax's
    ``PartitionSpec``, the port's ``P``)."""
    if isinstance(tree, dict):
        return {k: _as_tuple(v) for k, v in tree.items()}
    return tuple(tree)


def test_resolve_spec_divisibility_guard():
    mesh = fake_mesh((1, 1), ("data", "model"))
    try:
        rules = {"heads": "model", "embed": None, None: None}
        spec = sh.resolve_spec((9, 64), ("heads", "embed"), rules, mesh)
        assert spec == sh.P("model", None)  # 9 % 1 == 0 on a 1-wide axis
        # and on a 16-wide axis 9 heads fall through
        big = fake_mesh((16, 16), ("data", "model"))
        assert sh.resolve_spec((9, 64), ("heads", "embed"), rules, big) == sh.P(None, None)
    finally:
        dist.destroy_process_group()


def test_resolve_spec_single_use_per_axis():
    mesh = fake_mesh((1, 1), ("data", "model"))
    try:
        rules = {"experts": "model", "ff": "model", None: None}
        spec = sh.resolve_spec((8, 128, 256), ("experts", None, "ff"), rules, mesh)
        assert spec == sh.P("model", None, None)  # ff falls through: axis used
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(meshes, arch):
    """Parameter, optimizer-state, batch and cache specs, leaf for leaf."""
    amesh, mesh = meshes
    jmodel, jshapes_, jaxes = _reference(arch)
    jcfg = jmodel.cfg
    tmodel, params = _port(arch)
    cfg = tmodel.cfg
    assert _as_tuple(tmodel.axes()) == _as_tuple(jaxes)
    tp = cfg.parallelism == "tp"
    jps = jsh.param_specs(jshapes_, jaxes, amesh, fsdp=jcfg.fsdp, tp=tp)
    tps = sh.param_specs(params, tmodel.axes(), mesh, fsdp=cfg.fsdp, tp=tp)
    assert _as_tuple(tps) == _as_tuple(jps)
    jos = jadamw.state_specs(jps, jshapes_, amesh, zero1=True)
    tos = adamw.state_specs(tps, params, mesh, zero1=True)
    assert _as_tuple(tos) == _as_tuple(jos)
    dc = (jpipe.DataConfig(8, 16, jcfg.vocab), tpipe.DataConfig(8, 16, cfg.vocab))
    assert _as_tuple(tpipe.batch_specs(dc[1], cfg, mesh)) == \
        _as_tuple(jpipe.batch_specs(dc[0], jcfg, amesh))
    j_cache_specs = _reference_cache_specs()
    for shape in ("decode_32k", "long_500k"):
        jc = jmodel.init_cache(jshapes.SHAPES[shape].global_batch, jshapes.SHAPES[shape].seq_len)
        tc, _ = shapes.decode_structs(tmodel, cfg, shapes.SHAPES[shape])
        assert {k: tuple(v.shape) for k, v in tc.items() if k != "len"} == \
            {k: tuple(v.shape) for k, v in jc.items() if k != "len"}
        assert _as_tuple(dryrun._cache_specs(tmodel, cfg, tc, mesh)) == \
            _as_tuple(j_cache_specs(jmodel, jcfg, jc, amesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_give_each_leaf_its_spec_shape(meshes, arch):
    """A leaf distributed by ``placements`` holds, on this rank, the shape
    its spec divides out (every split of the resolver divides evenly)."""
    _, mesh = meshes
    tmodel, params = _port(arch)
    cfg = tmodel.cfg
    specs = sh.param_specs(params, tmodel.axes(), mesh, fsdp=cfg.fsdp,
                           tp=cfg.parallelism == "tp")
    ospecs = adamw.state_specs(specs, params, mesh)["m"]
    dparams = sh.distribute(params, mesh, specs)
    dm = sh.distribute(params, mesh, ospecs)
    for tree, spec_tree in ((dparams, specs), (dm, ospecs)):
        for key, leaf, spec in _zip(tree, spec_tree):
            want = _local_shape(tuple(leaf.shape), mesh, spec)
            assert tuple(leaf.to_local().shape) == want, (arch, key, spec)


def _local_shape(shape, mesh, spec):
    """Each rank's shard shape of ``shape`` under ``spec``: every split the
    resolver makes divides evenly."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else e or ()))
                 for d, e in zip(shape, spec))


def _zip(tree, specs, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _zip(v, specs[k], f"{prefix}{k}/")
        else:
            yield prefix + k, v, specs[k]


def test_placements_follow_the_mesh_order():
    mesh = fake_mesh((2, 16, 16), ("pod", "data", "model"))
    try:
        from torch.distributed.tensor import Replicate, Shard

        assert sh.placements(mesh, sh.P(("pod", "data"), None, "model"), 3) == \
            [Shard(0), Shard(0), Shard(2)]
        assert sh.placements(mesh, sh.P(), 2) == [Replicate()] * 3
        with pytest.raises(AssertionError, match="mesh's order"):
            sh.placements(mesh, sh.P(("data", "pod")), 1)
        t = sh.distribute({"w": torch.empty((64, 32), device="meta")}, mesh,
                          {"w": sh.P(("pod", "data"), "model")})["w"]
        assert tuple(t.to_local().shape) == (2, 2)
    finally:
        dist.destroy_process_group()


def test_use_mesh_sets_the_ambient_mesh():
    assert sh.current_mesh() is None
    with sh.use_mesh("m") as m:
        assert sh.current_mesh() == m == "m"
        with sh.use_mesh("n"):
            assert sh.current_mesh() == "n"
        assert sh.current_mesh() == "m"
    assert sh.current_mesh() is None


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "grok-1-314b", "llama4-scout-17b-a16e"])
def test_folded_multi_pod_mesh_holds_the_same_shards(arch):
    """``compute_mesh`` of the (2, 16, 16) mesh is (32, 16) over the same
    ranks, and the folded specs give each leaf of the FSDP archs the local
    shape the 3-D specs give."""
    from repro_torch.launch.mesh import compute_mesh

    mesh = fake_mesh(*MESHES["multi"])
    try:
        flat = compute_mesh(mesh)
        assert dict(zip(flat.mesh_dim_names, flat.shape)) == {"data": 32, "model": 16}
        assert flat.mesh.flatten().tolist() == mesh.mesh.flatten().tolist()
        tmodel, params = _port(arch)
        cfg = tmodel.cfg
        specs = sh.param_specs(params, tmodel.axes(), mesh, fsdp=cfg.fsdp)
        folded = sh.fold_pod(specs)
        assert any(("pod", "data") == e for _, _, s in _zip(params, specs) for e in s)
        assert all("pod" not in str(s) for _, _, s in _zip(params, folded))
        dparams = sh.distribute(params, flat, folded)
        for key, leaf, spec in _zip(dparams, specs):
            assert tuple(leaf.to_local().shape) == _local_shape(tuple(leaf.shape), mesh, spec)
    finally:
        dist.destroy_process_group()
