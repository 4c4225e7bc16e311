"""Logical-axis -> mesh-axis resolution, and DTensor placements from it.

The counterpart of the JAX package's ``distributed/sharding.py``.  Model
code annotates every parameter dimension with a *logical* axis name
("heads", "ff", "vocab", "experts", ...; ``Model.axes()``).  This module
resolves those names against a ``torch.distributed`` ``DeviceMesh``, read by
its ``mesh_dim_names``, with the reference's rules:

* tensor-parallel axes map to ``model``;
* with FSDP enabled, the ``embed`` (d_model) dimension of weight matrices is
  additionally sharded over the data axes (``("pod","data")`` on the
  multi-pod mesh) -- ZeRO-3-style weight sharding;
* a dimension only receives a mesh axis if its size is divisible by the mesh
  axis size (grok's 8 experts do not divide a 16-way model axis, so the
  resolver falls through to sharding the expert *ffn* dimension instead;
  llama4's 16 experts do divide it);
* each mesh axis is used at most once per tensor.

A spec is a :class:`P`: a tuple with one entry per tensor dimension, each
``None``, a mesh-axis name or a tuple of names, so spec trees compare one to
one with the reference's ``PartitionSpec`` trees.  :func:`placements` turns
one into DTensor placements (``Shard(d)`` / ``Replicate()``, one per mesh
dimension), :func:`distribute` a tree of tensors into DTensors, and
:func:`use_mesh` sets the mesh that the models' sharding constraints read
(``models/layers.py``), the counterpart of ``jax.set_mesh``.

Nothing here creates a process group: the mesh comes from the caller
(``launch/mesh.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    Missing trailing entries mean ``None``; a tuple of one axis is that axis
    (``P(("data",))`` is ``P("data")``), as jax's ``PartitionSpec`` has it."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Within the block, :func:`current_mesh` is ``mesh``."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh set by the innermost :func:`use_mesh`, or None."""
    return _MESH.get()


def mesh_sizes(mesh) -> dict[str, int]:
    """{mesh-dim name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_rules(mesh, *, fsdp: bool = False, tp: bool = True) -> dict:
    """logical axis -> mesh axis (str or tuple) for this mesh."""
    names = mesh.mesh_dim_names
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    model = ("model" if "model" in names else None) if tp else None
    return {
        "vocab": model,
        "heads": model,
        "kv": model,
        "ff": model,
        "experts": model,
        "ssm_inner": model,
        "ssm_heads": model,
        "ssm_conv_ch": model,
        "embed": (data_axes if fsdp and data_axes else None),
        "layers": None,
        None: None,
    }


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def resolve_spec(shape: tuple, axes: tuple, rules: dict, mesh) -> P:
    """The spec of one tensor, honoring divisibility and single use of each
    mesh axis."""
    assert len(shape) == len(axes), (shape, axes)
    used: set = set()
    out = []
    for dim, logical in zip(shape, axes):
        mesh_axis = rules.get(logical)
        if mesh_axis is None:
            out.append(None)
            continue
        flat = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        if any(a in used for a in flat) or dim % _axis_size(mesh, mesh_axis) != 0:
            out.append(None)
            continue
        used.update(flat)
        out.append(mesh_axis)
    return P(*out)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure (the first
    tree's keys): the port's trees of tensors and of specs."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def param_specs(param_shapes: dict, axes_tree: dict, mesh, *, fsdp: bool = False,
                tp: bool = True) -> dict:
    """Spec tree of a parameter tree (leaves with a ``.shape``: tensors, fake
    or meta tensors) under the logical axes of ``Model.axes()``."""
    rules = mesh_rules(mesh, fsdp=fsdp, tp=tp)
    return tree_map(lambda leaf, ax: resolve_spec(tuple(leaf.shape), ax, rules, mesh),
                    param_shapes, axes_tree)


def batch_axes(mesh) -> tuple:
    """Mesh axes used for data parallelism (batch dimension)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def data_spec(mesh, ndim: int, *, batch_dim: int = 0, batch_size: Optional[int] = None,
              include_model: bool = False) -> P:
    """Batch-over-data-axes spec; leaves the batch replicated if its size
    does not divide the data-parallel degree (long_500k's batch of 1).  With
    ``include_model`` (pure-DP profiles) the batch also shards over the
    model axis."""
    dp = batch_axes(mesh)
    if include_model and "model" in mesh.mesh_dim_names:
        dp = dp + ("model",)
    parts: list = [None] * ndim
    if dp and (batch_size is None or batch_size % _axis_size(mesh, dp) == 0):
        parts[batch_dim] = dp if len(dp) > 1 else dp[0]
    return P(*parts)


def cache_spec(mesh, shape: tuple, kv_heads_dim: int, seq_dim: int, batch_dim: int = 1) -> P:
    """KV-cache spec: batch over data axes; kv-heads over model when
    divisible, else sequence over model (cache sequence parallelism)."""
    dp = batch_axes(mesh)
    parts: list = [None] * len(shape)
    if dp and shape[batch_dim] % _axis_size(mesh, dp) == 0:
        parts[batch_dim] = dp
    if "model" in mesh.mesh_dim_names:
        msz = mesh_sizes(mesh)["model"]
        if shape[kv_heads_dim] % msz == 0 and shape[kv_heads_dim] >= msz:
            parts[kv_heads_dim] = "model"
        elif shape[seq_dim] % msz == 0:
            parts[seq_dim] = "model"
    return P(*parts)


# ----------------------------------------------------------------- DTensor

def fold_pod(spec_tree):
    """A spec tree for ``launch.mesh.compute_mesh``'s folded multi-pod mesh:
    every ``("pod", "data", ...)`` entry without "pod"."""
    def one(spec):
        return P(*(tuple(a for a in e if a != "pod") if isinstance(e, tuple) else e
                   for e in spec))
    return tree_map(one, spec_tree)


def placements(mesh, spec, ndim: int) -> list:
    """DTensor placements of a tensor of ``ndim`` dims under ``spec``: for
    each mesh dim, ``Shard(d)`` if tensor dim ``d`` names it, else
    ``Replicate()``.

    A dim over several mesh axes (``("pod", "data")``) is split by DTensor
    in mesh-dim order and by JAX in the tuple's order; the two layouts agree
    only while the tuple is in mesh order, which is asserted."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        flat = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in flat]
        assert idx == sorted(idx), f"spec entry {entry} is not in the mesh's order {names}"
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} used twice in {spec}")
            out[i] = Shard(d)
    return out


def distribute(tree, mesh, spec_tree):
    """The tensors of ``tree`` as DTensors on ``mesh`` under ``spec_tree``
    (the counterpart of ``named`` + ``device_put``).  Every rank must hold
    the same values: each keeps its own shards, and nothing is sent.
    Leaves that are not tensors (a cache's ``len``) pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh, placements(mesh, spec, t.ndim), src_data_rank=None)

    return tree_map(one, tree, spec_tree)
