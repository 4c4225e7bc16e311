"""Roofline terms of one step on a device mesh, for the H100.

The counterpart of the JAX package's ``analysis/roofline.py``.  There the
inputs are a compiled module's HLO text and ``cost_analysis()``; here they
are the operators one rank dispatches while the step runs once under fake
tensors on a fake process group (``launch/dryrun.py``), recorded by
:class:`Recorder`:

* FLOPs: each operator that ``torch.utils.flop_counter`` has a formula for
  (the matmuls and convolutions, and the SSD scan's custom operators,
  ``kernels/ssd_scan.py``), counted on the rank's local shapes (a DTensor
  op is recorded as the local ops it runs);
* HBM bytes: each operator's input and output bytes, views excluded -- the
  traffic of an eager step, which fuses nothing;
* live bytes: each storage an operator's outputs hold that none of its
  inputs shares (a new allocation) is counted from that operator until the
  storage is freed; ``peak_bytes`` is the most alive at once, the step's
  temporaries and outputs beyond its arguments, and ``live_at_peak(outputs)``
  the outputs' part of it, which XLA's ``temp_size_in_bytes`` leaves out;
* collectives: each ``torch.ops._c10d_functional`` call (what DTensor
  issues) with its result bytes B and group size S, and its ring cost on
  the wire:
    all-reduce       2 * B * (S-1)/S
    all-gather       B * (S-1)/S        (B the gathered result)
    reduce-scatter   B * (S-1)          (B the scattered result)
    all-to-all       B * (S-1)/S
    permute          B

The three roofline terms are per-device FLOPs over the bf16 dense
tensor-core rate, HBM bytes over the memory rate, and collective wire bytes
over one link's rate.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM5 (NVIDIA H100 data sheet): dense bf16 tensor-core FLOP/s and
# HBM3 bytes/s per GPU.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# Each 16-way production mesh axis spans two 8-GPU nodes, so a ring over it
# crosses the inter-node fabric, whose rate bounds the ring: one 400 Gb/s
# ConnectX-7 NDR InfiniBand port per GPU (NVIDIA DGX H100 user guide,
# "network ports"), 50e9 bytes/s each way.  NVLink inside a node (450 GB/s
# each way per GPU) is not the bound.
LINK_BW = 400e9 / 8

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


def ring_wire_bytes(op: str, b: float, s: int) -> float:
    """Per-device wire bytes of one collective of result bytes ``b`` over a
    group of ``s`` (the reference's ring model)."""
    if s <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * b * (s - 1) / s
    if op in ("all-gather", "all-to-all"):
        return b * (s - 1) / s
    if op == "reduce-scatter":
        return b * (s - 1)
    if op == "collective-permute":
        return b
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class CollectiveStat:
    op: str
    count: int = 0
    bytes: float = 0.0       # per-device result bytes
    wire_bytes: float = 0.0  # per-device wire traffic (ring model)


@dataclasses.dataclass
class RooflineReport:
    flops: float                 # per-device
    hbm_bytes: float             # per-device (dispatched or analytic)
    collective_wire_bytes: float
    collective_bytes: float
    collectives: dict
    compute_s: float
    memory_s: float
    collective_s: float
    cost_analysis_flops: float   # the flop counter's per-device total
    cost_analysis_bytes: float   # the dispatched ops' bytes

    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant()
        return d


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(group) -> int:
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(group)
    return group.size()


class Recorder(TorchDispatchMode):
    """Records the operators dispatched under it: FLOPs by
    ``torch.utils.flop_counter``'s formulas, the bytes of non-view ops, the
    functional collectives, and the calls of operators named in ``watch``.
    An op on DTensors is passed on (``NotImplemented``), so what is recorded
    is the rank's local work and the collectives DTensor issues for it; an
    op on fake tensors (DTensor's own shape propagation) is not recorded."""

    def __init__(self, watch: tuple = ()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.collectives: dict[str, CollectiveStat] = {}
        self.watch = {str(w): 0 for w in watch}
        self.live_bytes = 0  # of the storages recorded ops allocated, still alive
        self.peak_bytes = 0
        self._live: dict[int, tuple[weakref.ref, int]] = {}  # storage: (ref, op it came from)
        self._peak_op = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        names = {t.__name__ for t in types}
        if "DTensor" in names:
            return NotImplemented
        out = func(*args, **kwargs)
        if "FakeTensor" in names:
            return out
        self.n_ops += 1
        self._allocated(args, out)
        packet = func._overloadpacket
        if str(packet) in self.watch:
            self.watch[str(packet)] += 1
        if func.namespace == "_c10d_functional":
            self._collective(func, out, args)
            return out
        if packet in self.registry:
            self.flops += float(self.registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += _nbytes(args) + _nbytes(out)
        return out

    def _allocated(self, args, out) -> None:
        """Count the storages of ``out`` that no argument shares (views and
        in-place results share theirs), each until it is freed."""
        outs = list(_tensors(out))
        if not outs:
            return
        inputs = {t.untyped_storage()._cdata for t in _tensors(args)}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (weakref.ref(st, functools.partial(self._freed, key, n)),
                               self.n_ops)
            self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes, self._peak_op = self.live_bytes, self.n_ops

    def live_at_peak(self, tree) -> int:
        """Bytes of the tallied storages that ``tree``'s tensors (a DTensor's
        local shard) hold and that were alive at the peak: those allocated by
        then, since what ``tree`` holds is still alive."""
        keys = set()
        for t in _tensors(tree):
            key = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()._cdata
            entry = self._live.get(key)
            if entry is not None and entry[1] <= self._peak_op:
                keys.add(key)
        return sum(self._live[k][0]().nbytes() for k in keys)

    def _freed(self, key: int, n: int, _ref) -> None:
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _collective(self, func, out, args) -> None:
        name = func._opname.rstrip("_").removesuffix("_coalesced")
        op = _FUNCTIONAL.get(name)
        if op is None:  # wait_tensor, broadcast: no ring cost of their own
            return
        b = float(_nbytes(out))
        s = _group_size(args[-1])
        st = self.collectives.setdefault(op, CollectiveStat(op))
        st.count += 1
        st.bytes += b
        st.wire_bytes += ring_wire_bytes(op, b, s)

    def report(self, *, analytic_hbm_bytes: Optional[float] = None) -> RooflineReport:
        wire = sum(st.wire_bytes for st in self.collectives.values())
        hbm = max(self.bytes, analytic_hbm_bytes or 0.0)
        return RooflineReport(
            flops=self.flops,
            hbm_bytes=hbm,
            collective_wire_bytes=wire,
            collective_bytes=sum(st.bytes for st in self.collectives.values()),
            collectives={k: dataclasses.asdict(v) for k, v in self.collectives.items()},
            compute_s=self.flops / PEAK_FLOPS,
            memory_s=hbm / HBM_BW,
            collective_s=wire / LINK_BW,
            cost_analysis_flops=self.flops,
            cost_analysis_bytes=self.bytes,
        )


def model_flops_per_step(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens/step.

    For train cells this is fwd+bwd (6ND); prefill is forward-only (2ND);
    decode is 2*N_active per token."""
    n_active = cfg.active_param_count()
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    if cell.kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens
