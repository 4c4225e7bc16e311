"""Device meshes: the production meshes and a mesh over the present ranks.

The counterpart of the JAX package's ``launch/mesh.py``.  The single-pod
mesh is 16 x 16 = 256 devices ("data", "model"); the multi-pod mesh is
2 x 16 x 16 = 512 devices ("pod", "data", "model").  Each function sets up
the process group it needs when none is there, so importing this module
starts nothing:

* :func:`make_production_mesh` stands for 256 or 512 devices in one
  process: a ``fake`` process group of that world size (this process is
  rank 0; collectives are recorded, not run), the dry run's mesh
  (``launch/dryrun.py``), as the reference's dry run fakes its devices;
* :func:`make_host_mesh` is a mesh over the ranks that are really there: an
  NCCL group on the card (``cuda``), gloo on the CPU.  Without a process
  group it starts a single-rank one on ``tcp://localhost``.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh over a fake process group of 256 or 512 ranks.
    An existing fake group of that size is reused; any other group is torn
    down first."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, names = PRODUCTION[multi_pod]
    world = 1
    for s in shape:
        world *= s
    if dist.is_initialized() and (dist.get_backend() != "fake"
                                  or dist.get_world_size() != world):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def compute_mesh(mesh):
    """The mesh a step's DTensors live on: ``mesh`` itself, or for the
    multi-pod mesh the equivalent (pod * data, model) = (32, 16) mesh over
    the same ranks, "pod" folded into "data" pod-major.  Every spec names
    "pod" and "data" together and in that order (``distributed/sharding.py``),
    so the two layouts hold the same shards; on the folded mesh a batch or
    FSDP dim has one mesh dim, so DTensor issues one 32-way collective where
    the reference's replica groups span both axes, and takes its plain
    redistribution planner (a dim split over two mesh dims sends it through
    a graph search that dominated a multi-pod cell's host time)."""
    from torch.distributed.device_mesh import init_device_mesh

    names = mesh.mesh_dim_names
    if "pod" not in names:
        return mesh
    sizes = dict(zip(names, mesh.shape))
    return init_device_mesh(mesh.device_type, (sizes["pod"] * sizes["data"], sizes["model"]),
                            mesh_dim_names=("data", "model"))


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """A ("data", "model") mesh over the ranks of the process group:
    world / model_parallel x model_parallel.  Without a group, a single-rank
    one (NCCL on the card, gloo on the CPU) is started first: on one card
    that is the (1, 1) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' but no CUDA device is available; "
                           "pass device_type='cpu' for a gloo mesh on the host")
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not divide into model_parallel={model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=("data", "model"))
