"""What every cell shares: the spec files, the seeded weights, the device
helpers, and the record a run leaves for the metric readers.

Files, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``: the model as it is run (``model``: the port's
  ``ModelConfig`` fields), its source, ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: a driver (``drivers/<driver>.py``) and its
  parameters;
* ``limits/<workload>.json``: each number the correctness check compares,
  with its limit and the readings the limit was set from;
* ``metrics/<metric>.py``: a reader ``read(record) -> float | None`` per
  metric; ``None`` leaves the metric out of the line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str, bench: dict | None = None) -> dict:
    bench = bench or spec()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    return load_json(BENCH / "limits" / f"{workload_name}.json")


def load_file(path: Path, name: str):
    """Import the module at ``path`` (a file name may hold dots)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    return load_file(BENCH / "metrics" / f"{metric}.py",
                     "port_bench_metric_" + metric.replace(".", "_").replace("-", "_")).read


def driver(name: str):
    return importlib.import_module(f"port_bench.drivers.{name}")


def metrics_for(bench: dict, workload_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer metrics."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload_name in m.get("workloads", [workload_name])]


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**cfg["model"])


# ------------------------------------------------------------------ weights

_ONES = ("d_skip", "norm", "ln", "final_norm", "ln1", "ln2")


def _init(name: str, shape) -> tuple[str, float]:
    """(kind, scale) of a leaf: ``normal`` leaves are scale * N(0, 1) in the
    leaf's type; the rest are set below.  Projections are N(0, 1/fan_in)
    in the (in, out) layout; the Mamba-2 leaves follow the published init
    (dt log-uniform in [1e-3, 1e-1], A uniform in [1, 16])."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _ONES:
        return "ones", 1.0
    if leaf == "conv_b":
        return "zeros", 0.0
    if leaf in ("dt_bias", "a_log"):
        return leaf, 1.0
    if leaf == "embed":
        return "normal", 1.0
    if leaf == "conv_w":
        return "normal", (3 * shape[-2]) ** -0.5
    return "normal", shape[-2] ** -0.5


def make_weights(cfg, seed: int, device) -> dict:
    """The model's leaves ({name: tensor}, the port's names and shapes)
    drawn on ``device`` from ``seed``: one draw per leaf type for every
    normal leaf at once, one for the dt and A leaves."""
    import torch

    from repro_torch.models.model import meta_model

    leaves_of = flat(meta_model(cfg).tree())
    gen = torch.Generator(device=device).manual_seed(seed)
    out: dict = {}
    normal = {}
    for name, like in sorted(leaves_of.items()):
        kind, scale = _init(name, like.shape)
        if kind == "normal":
            normal.setdefault(like.dtype, []).append((name, like, scale))
        elif kind == "ones":
            out[name] = torch.ones(like.shape, dtype=like.dtype, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(like.shape, dtype=like.dtype, device=device)
    for dtype, leaves in sorted(normal.items(), key=lambda kv: str(kv[0])):
        total = sum(like.numel() for _, like, _ in leaves)
        buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for name, like, scale in leaves:
            out[name] = buf[off:off + like.numel()].view(like.shape).mul_(scale)
            off += like.numel()
    for name in ("layers.block.dt_bias", "layers.block.a_log"):
        shape = leaves_of[name].shape
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        if name.endswith("dt_bias"):
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            out[name] = (dt + torch.log(-torch.expm1(-dt))).to(leaves_of[name].dtype)
        else:
            out[name] = torch.log(1 + 15 * u).to(leaves_of[name].dtype)
    return out


def flat(tree: dict, prefix: str = "") -> dict:
    """{"layers.block.w_z": leaf, ...} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def port_model(cfg, weights: dict):
    """The port's model of ``cfg`` holding ``weights`` (no other init)."""
    from repro_torch.models.model import meta_model

    model = meta_model(cfg)
    model.load_state_dict(weights, assign=True)
    return model


def dtype_bytes(cfg) -> int:
    """Bytes of an element of the configuration's compute type."""
    from repro_torch.models.layers import dtype_of

    return dtype_of(cfg).itemsize


# ------------------------------------------------------------ device helpers
# The drivers also run on the CPU at small sizes, for the tests of the
# harness; there these are no-ops and the peak reads 0.

def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


class Collections:
    """The interpreter's garbage collections in the window and the traced
    stretch, for the notes.

    Opening one collects once and freezes what set-up left alive (imports,
    the model, its state), as long-running trainers and servers do, so that
    a full collection in the window does not walk those objects; the
    collector stays on for everything the window allocates."""

    def __init__(self):
        import gc

        gc.collect()
        gc.freeze()
        self.pauses: dict[int, list[float]] = {}
        self._start = None
        gc.callbacks.append(self._watch)

    def _watch(self, phase: str, info: dict) -> None:
        import time

        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.pauses.setdefault(info["generation"], []).append(
                1e3 * (time.perf_counter() - self._start))
            self._start = None

    def close(self) -> dict:
        """{generation: [collections, their longest ms]}; stop watching and
        unfreeze."""
        import gc

        gc.callbacks.remove(self._watch)
        gc.unfreeze()
        return {g: [len(p), round(max(p), 3)] for g, p in sorted(self.pauses.items())}


class Marks:
    """CUDA events recorded between the window's steps or calls, read only
    after the window has closed: each step's device milliseconds, for the
    record's notes (none on the CPU)."""

    def __init__(self, dev):
        self.on = dev.type == "cuda"
        self.events = []

    def mark(self) -> None:
        if self.on:
            import torch

            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[-1].record()

    def ms(self) -> list[float]:
        return [round(a.elapsed_time(b), 3) for a, b in zip(self.events, self.events[1:])]


def stamp(phases: dict, name: str, t_start: float, dev) -> None:
    """Seconds from the process's start to the end of a set-up phase."""
    import time

    sync(dev)
    phases[name] = round(time.perf_counter() - t_start, 3)


def free(dev) -> None:
    """Collect what was dropped and give the card's cached blocks back."""
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------------------- record

@dataclasses.dataclass
class Cell:
    """One run's inputs."""
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers and the result line."""
    driver: str
    setup_s: float
    window_s: float          # the window's start to the sync after its last step or call
    work: int                # tokens completed in the window
    units: int               # steps or requests completed in the window
    peak_bytes: int          # max_memory_allocated over the window
    flops_per_token: float
    numbers: dict            # compared number -> value
    trace: object = None     # trace.Trace of the traced stretch
    traced_units: int = 0    # steps or calls inside the traced stretch
    ssd_calls: dict = dataclasses.field(default_factory=dict)  # op -> per-call least s
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def rate(self) -> float:
        return self.work / self.window_s


def op_roofline(rec: Record) -> float | None:
    """Least time over device time (%) of the operators in
    ``rec.ssd_calls``: each outermost traced call counts its least time;
    the device time is all the work launched under the operators, whatever
    the kernels are called.  None when the trace holds no such work."""
    if rec.trace is None or not rec.ssd_calls:
        return None
    least = sum(rec.trace.calls(op) * s for op, s in rec.ssd_calls.items())
    spent = sum(rec.trace.device_s(op) for op in rec.ssd_calls)
    return 100 * least / spent if least > 0 and spent > 0 else None


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a missing or non-finite number fails."""
    out, ok = {}, True
    for name, entry in lim["numbers"].items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= entry["limit"]
        ok = ok and good
        out[name] = {"value": v if v is None or math.isfinite(v) else str(v),
                     "limit": entry["limit"]}
    return ok, out
