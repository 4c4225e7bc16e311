"""Flattening of nested training state, in the JAX package's order and names.

The checkpoint engine lays leaves out on the volume in flatten order and
names them in its manifest, so both must match what ``jax.tree_util`` gives
the reference for the same state, or the media bytes, the manifest and the
virtual times would differ:

* a ``dict`` is walked in sorted key order (``layer0, layer1, layer10,
  layer11, layer2, ...``), an ``OrderedDict`` in insertion order; lists and
  tuples go by index; ``None`` is an empty node with no leaf; anything else
  is a leaf (tensors, numpy arrays, Python scalars); a namedtuple goes by
  field;
* a leaf's name is its path as ``keystr`` writes it: ``['params']['w0']``,
  ``['b'][1][0]`` (each dict key in ``repr``, each index bare, each field
  as ``.name``).

``torch.utils._pytree`` and ``state_dict()`` walk dicts in insertion order,
so neither is used here.

A leaf's bytes and metadata follow numpy's view of it (``np.asarray``): the
dtype's name (``float32``, ``bfloat16``, ``int64`` for a Python ``int``),
the shape, and the raw bytes in C order.  A ``torch.bfloat16`` tensor is
read through a byte view, since numpy may have no ``bfloat16``.
"""
from __future__ import annotations

import collections
from typing import Any

import numpy as np
import torch

_SEQUENCES = (list, tuple)


class TreeDef:
    """The structure of a flattened tree, to rebuild it from its leaves."""

    def __init__(self, kind: Any, keys: tuple = (), children: tuple = ()):
        self.kind = kind          # dict type, list, tuple, namedtuple, None, or "leaf"
        self.keys = keys          # dict keys (namedtuple fields) in flatten order
        self.children = children  # child TreeDefs


def _dict_keys(node: dict) -> list:
    if isinstance(node, collections.OrderedDict):
        return list(node)
    try:
        return sorted(node)
    except TypeError as e:
        raise TypeError("dict keys of a state tree must be mutually orderable") from e


def flatten_with_path(tree) -> tuple[list[tuple[str, Any]], TreeDef]:
    """[(keystr name, leaf)] in the reference's order, and the structure."""
    out: list[tuple[str, Any]] = []

    def walk(node, path: str) -> TreeDef:
        if node is None:
            return TreeDef(None)
        if isinstance(node, dict):
            keys = _dict_keys(node)
            kids = tuple(walk(node[k], f"{path}[{k!r}]") for k in keys)
            return TreeDef(type(node), tuple(keys), kids)
        if isinstance(node, tuple) and hasattr(node, "_fields"):  # a namedtuple
            kids = tuple(walk(getattr(node, f), f"{path}.{f}") for f in node._fields)
            return TreeDef(type(node), tuple(node._fields), kids)
        if isinstance(node, _SEQUENCES):
            kids = tuple(walk(v, f"{path}[{i}]") for i, v in enumerate(node))
            return TreeDef(type(node), (), kids)
        out.append((path, node))
        return TreeDef("leaf")

    return out, walk(tree, "")


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)[0]]


def structure(tree) -> TreeDef:
    return flatten_with_path(tree)[1]


def unflatten(treedef: TreeDef, leaves_in) -> Any:
    """The tree of ``treedef`` with ``leaves_in`` in flatten order."""
    it = iter(leaves_in)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind is None:
            return None
        kids = [build(c) for c in td.children]
        if td.kind in _SEQUENCES:
            return td.kind(kids)
        if td.keys and issubclass(td.kind, tuple):  # a namedtuple
            return td.kind(*kids)
        return td.kind(zip(td.keys, kids))

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


# ------------------------------------------------------------ leaf bytes

def _torch_dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name (``float32``, ``bfloat16``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return dt


def leaf_meta(leaf) -> tuple[str, list[int], int]:
    """(dtype name, shape, nbytes) of a leaf, as numpy sees it."""
    if isinstance(leaf, torch.Tensor):
        return (_torch_dtype_name(leaf.dtype), list(leaf.shape),
                leaf.numel() * leaf.element_size())
    arr = np.asarray(leaf)
    return str(arr.dtype), list(arr.shape), arr.nbytes


def host_bytes(leaf) -> np.ndarray:
    """A leaf's bytes in C order as a 1-d numpy uint8 array (a tensor on the
    card is copied to the host)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def leaf_bytes(leaf) -> torch.Tensor:
    """A leaf's bytes in C order as a 1-d uint8 tensor on the leaf's device
    (the CPU for numpy arrays and scalars); a view where it can be."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().reshape(-1).view(torch.uint8)
    raw = host_bytes(leaf)
    return torch.from_numpy(raw if raw.flags.writeable else raw.copy())


def leaf_from_bytes(raw: torch.Tensor, dtype: str, shape, like, *, copy: bool = True) -> Any:
    """Rebuild a leaf from its bytes (a 1-d uint8 tensor, exactly its
    ``nbytes``): a tensor of ``dtype`` on ``like``'s device if ``like`` is a
    tensor (a view of ``raw`` when it is there already and ``copy`` is
    false), else a numpy array of ``dtype`` (an owned copy)."""
    if isinstance(like, torch.Tensor):
        return raw.to(like.device, copy=copy).view(torch_dtype(dtype)).reshape(shape)
    return raw.cpu().numpy().copy().view(np.dtype(dtype)).reshape(shape)
