"""Erasure coding of sharded training state across data-parallel ranks.

ZapRAID's stripe encoding applied to live training state: the k optimizer
state shards held by k data-parallel failure domains are the data chunks of
a stripe, and m parity shards are computed with the codec's kernels (XOR for
m=1, GF(256) Reed-Solomon for m=2).  If a rank dies, its shard is rebuilt
from the k-1 survivors and the parity, with no re-read of checkpoint storage
-- the in-memory analogue of the paper's full-drive recovery.

Every function works on byte views of the leaves, so any dtype works.  Each
leaf index is one stripe: the k leaves' bytes, zero-padded to a multiple of 4
and viewed as int32 lanes, are stacked into (k, n) and go to
``ops.xor_parity``/``rs_encode``/``rs_decode`` -- the single-stripe kernels
``stripe_xor``/``stripe_gf256``.  A leaf on the card stays there: its bytes
are viewed in place and the kernels run on device memory.

Outputs follow the inputs: a parity leaf is uint8 of the padded length and a
rebuilt leaf has the template leaf's dtype and shape, each as a tensor on the
leaf's device where the leaf is a tensor, else as a numpy array.  A DTensor
leaf (state sharded on a device mesh) is encoded by its global value
(``_tree``): its parity leaf is a plain uint8 tensor on the mesh's device,
and a rebuilt leaf is a DTensor placed as the template leaf is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.checkpoint import _tree
from repro_torch.kernels import ops


def _leaf_to_lanes(leaf) -> torch.Tensor:
    raw = _tree.leaf_bytes(leaf)
    pad = (-raw.numel()) % 4
    if pad:
        raw = F.pad(raw, (0, pad))
    elif raw.storage_offset() % 4:  # a view that starts off a lane boundary
        raw = raw.clone()
    return raw.view(torch.int32)


def _lanes_to_leaf(lanes: torch.Tensor, dtype: str, shape, nbytes: int, like, *,
                   copy: bool = False):
    """A leaf over the first ``nbytes`` of a kernel's output row: a view of
    it where ``like`` is a tensor on the same device, unless ``copy``."""
    raw = lanes.view(torch.uint8)[:nbytes]
    return _tree.leaf_from_bytes(raw, dtype, shape, like, copy=copy)


def _stack(leaves) -> torch.Tensor:
    return torch.stack([_leaf_to_lanes(leaf) for leaf in leaves])


def encode_shards(shards: list, m: int = 1) -> list:
    """Compute m parity trees over k rank-shard trees (leafwise)."""
    flat = [_tree.leaves(s) for s in shards]
    treedef = _tree.structure(shards[0])
    parity_leaves: list[list] = [[] for _ in range(m)]
    for leaves in zip(*flat):
        lanes = _stack(leaves)
        if m == 1:
            p = ops.xor_parity(lanes)[None]
        else:
            p = ops.rs_encode(lanes, m)
        nbytes = _tree.leaf_meta(leaves[0])[2]
        padded = nbytes + (-nbytes) % 4
        # a parity row is a plain tensor on the leaves' device, or numpy
        like = lanes if isinstance(leaves[0], torch.Tensor) else leaves[0]
        for j in range(m):
            parity_leaves[j].append(_lanes_to_leaf(p[j], "uint8", (padded,), padded, like))
    return [_tree.unflatten(treedef, pl) for pl in parity_leaves]


def reconstruct_shard(lost_rank: int, surviving: dict[int, object], parity: list, k: int):
    """Rebuild rank ``lost_rank``'s shard tree from the survivors (rank ->
    shard, taken in the dict's order) and parity rows in order, k rows in
    all."""
    m = len(parity)
    template = next(iter(surviving.values()))
    treedef = _tree.structure(template)
    surv_flat = {r: _tree.leaves(s) for r, s in surviving.items()}
    par_flat = [_tree.leaves(p) for p in parity]
    out_leaves = []
    for i, t in enumerate(_tree.leaves(template)):
        rows, roles = [], []
        for r, leaves in surv_flat.items():
            rows.append(leaves[i])
            roles.append(r)
        for j in range(m):
            if len(rows) >= k:
                break
            rows.append(par_flat[j][i])
            roles.append(k + j)
        lanes = _stack(rows[:k])
        roles = tuple(roles[:k])
        if m == 1:
            rec = ops.xor_parity(lanes)
        else:  # all k data rows decode; keep the lost one, not a view of all k
            rec = ops.rs_decode(lanes, roles, k, m)[lost_rank]
        dtype, shape, nbytes = _tree.leaf_meta(t)
        out_leaves.append(_lanes_to_leaf(rec, dtype, shape, nbytes, t, copy=m > 1))
    return _tree.unflatten(treedef, out_leaves)
