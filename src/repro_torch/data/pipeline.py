"""Deterministic synthetic data pipeline.

The counterpart of the JAX package's ``data/pipeline.py``: per-step training
batches from a counter-based PRNG, so every host makes exactly its own shard
with no communication and a restart from a checkpointed step reproduces the
identical stream.  The draws are the reference's, made without jax by
``_threefry`` (jax's threefry2x32, partitionable mode): ``tokens`` and
``labels`` equal the reference's bit for bit; the stub ``frames`` (encdec)
and ``vis_embeds`` (vlm) take torch's ``erfinv`` of the same uniform values,
within an ulp of XLA's.

``batch_specs`` (PartitionSpecs over a mesh) waits for the sharding slice.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.raid import check_device
from repro_torch.data import _threefry as tf
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0


def _normal(key: np.ndarray, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erfinv(u), u
    uniform in (-1, 1)."""
    u = tf.uniform(key, shape, np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)
    return torch.special.erfinv(torch.from_numpy(u).to(device)) * np.float32(math.sqrt(2))


def batch_for_step(dc: DataConfig, cfg: ModelConfig, step: int,
                   device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Global batch for ``step`` on ``device``: ``tokens`` and ``labels``
    (int32, (global_batch, seq_len)), plus the stub ``frames`` (encdec) or
    ``vis_embeds`` (vlm), float32."""
    dev = check_device(device)
    ks = tf.split(tf.fold_in(tf.prng_key(dc.seed), step), 3)
    tokens = torch.from_numpy(
        tf.randint(ks[0], (dc.global_batch, dc.seq_len + 1), 0, dc.vocab)).to(dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * _normal(ks[1], (dc.global_batch, cfg.enc_len, cfg.d_model), dev)
    if cfg.family == "vlm":
        batch["vis_embeds"] = 0.02 * _normal(
            ks[2], (dc.global_batch, cfg.vis_prefix_len, cfg.vis_embed_dim), dev)
    return batch


def host_shard(batch: dict, host_index: int, n_hosts: int) -> dict:
    """Slice a global batch to this host's rows (per-host data loading)."""
    def slc(x):
        per = x.shape[0] // n_hosts
        return x[host_index * per : (host_index + 1) * per]
    return {k: slc(v) for k, v in batch.items()}
