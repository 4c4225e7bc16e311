"""Assigned input-shape cells and their input tensors without data.

The counterpart of the JAX package's ``launch/shapes.py``.  Every
(architecture x shape) pair is a dry-run cell.  ``decode_*`` / ``long_*``
run ``decode_step`` (one new token against a seq_len KV/state cache);
``prefill_32k`` runs the prefill; ``train_4k`` runs the full train step.
``long_500k`` requires sub-quadratic attention and runs only for the
SSM/hybrid architectures (spec-directed skip for pure full-attention
archs).  The inputs are meta or fake tensors of the reference's shapes and
dtypes (its ``ShapeDtypeStruct``s): nothing here allocates.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, (
            "spec-directed skip: long_500k needs sub-quadratic attention; "
            f"{cfg.name} is a full-attention family ({cfg.family})"
        )
    if cfg.moe_dropless:
        return False, (
            f"{cfg.name}: the dropless MoE runs on one device; its expert segments are not "
            "split over the dry run's meshes"
        )
    return True, ""


def batch_struct(cfg: ModelConfig, cell: ShapeCell, device: str | torch.device = "meta"):
    """The model-input batch of a train/prefill cell as empty tensors on
    ``device``: meta tensors by default (the dry run's), fake ones when
    called under a ``FakeTensorMode``."""
    b, t = cell.global_batch, cell.seq_len

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    out = {"tokens": empty((b, t), torch.int32)}
    if cell.kind == "train":
        out["labels"] = empty((b, t), torch.int32)
    if cfg.family == "encdec":
        out["frames"] = empty((b, cfg.enc_len, cfg.d_model), torch.float32)
    if cfg.family == "vlm":
        out["vis_embeds"] = empty((b, cfg.vis_prefix_len, cfg.vis_embed_dim), torch.float32)
    return out


def decode_structs(model, cfg: ModelConfig, cell: ShapeCell):
    """(cache, tokens) of a decode cell: ``model.init_cache`` and the (B, 1)
    int32 tokens on the model's device.  A model built on ``meta`` (the dry
    run's) gives meta tensors; any other is run under a ``FakeTensorMode``,
    so a 128 x 32,768 cache allocates nothing either way."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    meta = model.device.type == "meta"
    with contextlib.nullcontext() if meta else FakeTensorMode():
        cache = model.init_cache(cell.global_batch, cell.seq_len)
        tokens = torch.empty((cell.global_batch, 1), dtype=torch.int32, device=model.device)
    return cache, tokens
