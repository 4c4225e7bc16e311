"""Multi-pod dry run: run every (architecture x shape) cell once on the
production meshes without data, and take its roofline inputs.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell for 256 or 512 host-faked devices.  Here one process
stands for rank 0 of a ``fake`` process group of 256 or 512 ranks
(``launch/mesh.py``): the parameters, optimizer state, batch and caches are
DTensors on a ``DeviceMesh`` over that group, laid out by the reference's
specs (``distributed/sharding.py``), whose local shards are meta tensors --
shapes and dtypes, no storage (``models.model.meta_model``, drawing
nothing) -- and the train, prefill or decode step runs once to warm
DTensor's caches and once more with ``analysis.roofline.Recorder`` on, which
counts the rank's FLOPs and bytes and the collectives DTensor issues, and
tallies the bytes it allocates (``memory_analysis``, below).  A
meta tensor runs each operator's shape function (the SSD scan's custom
operators' too, ``kernels/ssd_scan.py``, counted per call) without
``FakeTensorMode``'s per-operator Python layer, which made a cell ~3.7x
slower.  Multi-pod steps run on the folded (32, 16) mesh
(``launch.mesh.compute_mesh``); their specs and bytes are the 3-D mesh's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all              # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi # 512 devices

A cell's ``memory_analysis`` holds three of the reference's fields
(``compiled.memory_analysis()``), for one rank:

* ``argument_size_in_bytes``: the placed inputs' local bytes (each DTensor's
  ``to_local()``; a non-tensor leaf, a cache's ``len``, as the reference's
  int32 scalar);
* ``output_size_in_bytes``: the step's outputs' local bytes, counted the
  same way;
* ``temp_size_in_bytes``: the peak of live bytes the recorded step
  allocated beyond its arguments, tallied in ``analysis.roofline.Recorder``'s
  dispatch mode (each new storage from its operator until it is freed),
  less the outputs' storages alive at that peak, which XLA's figure leaves
  out too.

The reference's ``generated_code_size_in_bytes`` and ``hlo_bytes`` measure
a compiled XLA executable and its HLO text.  An eager step has neither, so
the port records neither rather than a stand-in.

Results are written incrementally to ``experiments/dryrun_torch/*.json``
(one file per cell x mesh; the reference writes ``experiments/dryrun``);
existing files are skipped so the sweep is resumable.  ``--device`` is the
mesh's device type, ``cuda`` unless ``cpu`` is asked for.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import pathlib
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from repro_torch.analysis import roofline as rl
from repro_torch.checkpoint import _tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.raid import check_device
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import compute_mesh, make_production_mesh
from repro_torch.launch.shapes import SHAPES, batch_struct, cell_supported, decode_structs
from repro_torch.models.model import meta_model
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_mod

OUT_DIR = pathlib.Path("experiments/dryrun_torch")
SSD_OPS = ("repro_torch.ssd_scan", "repro_torch.ssd_scan_bwd")


def _leaves(tree):
    """Leaves of nested dicts in sorted-key order (the reference's)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _dev_bytes(shape_tree, spec_tree, mesh) -> float:
    """Per-device bytes of a sharded tree (from shapes + specs).  A leaf that
    is no tensor (a cache's ``len``) is the reference's int32 scalar."""
    sizes = sh.mesh_sizes(mesh)
    total = 0.0
    for leaf, spec in zip(_leaves(shape_tree), _leaves(spec_tree)):
        if isinstance(leaf, torch.Tensor):
            n, itemsize = math.prod(leaf.shape) if leaf.shape else 1, leaf.element_size()
        else:
            n, itemsize = 1, 4
        denom = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                denom *= sizes[a]
        total += n * itemsize / denom
    return total


def _cache_specs(model, cfg, cache_structs, mesh) -> dict:
    specs = {}
    for name, leaf in cache_structs.items():
        if name == "len":
            specs[name] = sh.P()
        elif name in ("k", "v", "ak", "av", "ck", "cv"):
            specs[name] = sh.cache_spec(mesh, tuple(leaf.shape), kv_heads_dim=3, seq_dim=2)
        elif name == "conv":
            specs[name] = sh.cache_spec(mesh, tuple(leaf.shape), kv_heads_dim=3, seq_dim=2)
        elif name == "ssd":
            # (L,B,H,N,P): heads over model, batch over data
            specs[name] = sh.cache_spec(mesh, tuple(leaf.shape), kv_heads_dim=2, seq_dim=3)
        else:
            specs[name] = sh.P()
    return specs


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: pathlib.Path,
             *, force: bool = False, opt_overrides: dict | None = None,
             cfg_overrides: dict | None = None, tag: str = "",
             device: str = "cuda") -> dict:
    mesh_name = "multi" if multi_pod else "single"
    out_file = out_dir / f"{arch}__{shape_name}__{mesh_name}{tag}.json"
    if out_file.exists() and not force:
        return json.loads(out_file.read_text())
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape_name)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": cell.kind, "status": "skip", "reason": reason,
    }
    if not ok:
        out_dir.mkdir(parents=True, exist_ok=True)
        out_file.write_text(json.dumps(result, indent=2))
        return result

    t0 = time.time()
    dev = check_device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    n_dev = mesh.size()
    try:
        result.update(_run_and_analyze(cfg, cell, mesh, n_dev, opt_overrides))
        result["status"] = "ok"
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        result["status"] = "fail"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc(limit=20)
    result["wall_s"] = round(time.time() - t0, 1)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(result, indent=2))
    return result


def cell_inputs(cfg, cell, mesh, opt_overrides=None) -> dict:
    """What a cell runs, on ``mesh``: ``fn`` (the train, prefill or decode
    step of ``cfg`` built on meta) and its DTensor ``args``, with the
    per-device ``param_dev_bytes`` and ``state_dev_bytes`` (parameters, plus
    the optimizer state or the cache) and the analytic HBM bytes of a step,
    all from shapes and specs as the reference computes them."""
    opt_cfg = adamw.AdamWConfig(**(opt_overrides or {}))
    tp = cfg.parallelism == "tp"
    inc_model = not tp  # pure-DP profile: batch shards over the model axis too
    model, train_step = steps_mod.make_train_step(cfg, opt_cfg, model=meta_model(cfg))
    params = steps_mod.params_of(model)
    pspecs = sh.param_specs(params, model.axes(), mesh, fsdp=cfg.fsdp, tp=tp)
    param_dev_bytes = _dev_bytes(params, pspecs, mesh)
    cmesh = compute_mesh(mesh)

    def put(tree, specs):  # on the mesh the step runs on
        return sh.distribute(tree, cmesh, sh.fold_pod(specs) if cmesh is not mesh else specs)

    dparams = put(params, pspecs)

    def batch_specs(batch):
        return {k: sh.data_spec(mesh, v.ndim, batch_size=v.shape[0], include_model=inc_model)
                for k, v in batch.items()}

    if cell.kind == "train":
        opt = steps_mod.init_opt_state(model, params, opt_cfg)
        ospecs = adamw.state_specs(pspecs, params, mesh, zero1=True)
        if "residual" in opt:
            ospecs["residual"] = ospecs["m"]
        opt_dev_bytes = _dev_bytes(opt, ospecs, mesh)
        batch = batch_struct(cfg, cell)
        fn, args = train_step, (dparams, put(opt, ospecs), put(batch, batch_specs(batch)))
        analytic_hbm = 2 * param_dev_bytes + 2 * opt_dev_bytes
        state_bytes = param_dev_bytes + opt_dev_bytes
    elif cell.kind == "prefill":
        _, fn = steps_mod.make_prefill_step(cfg, model=model)
        batch = batch_struct(cfg, cell)
        args = (dparams, put(batch, batch_specs(batch)))
        analytic_hbm = param_dev_bytes
        state_bytes = param_dev_bytes
    else:  # decode
        _, fn = steps_mod.make_decode_step(cfg, model=model)
        cache, tok = decode_structs(model, cfg, cell)
        cspecs = _cache_specs(model, cfg, cache, mesh)
        cache_dev_bytes = _dev_bytes(cache, cspecs, mesh)
        tspec = sh.data_spec(mesh, 2, batch_size=cell.global_batch)
        args = (dparams, put(cache, cspecs), put(tok, tspec))
        analytic_hbm = param_dev_bytes + 2 * cache_dev_bytes
        state_bytes = param_dev_bytes + cache_dev_bytes
    return {"fn": fn, "args": args, "mesh": cmesh, "param_dev_bytes": param_dev_bytes,
            "state_dev_bytes": state_bytes, "analytic_hbm": analytic_hbm}


def local_bytes(tree) -> int:
    """Bytes one rank holds of a tree of step inputs or outputs: each
    DTensor's local shard, each tensor whole, any other leaf (a cache's
    ``len``) the reference's int32 scalar."""
    total = 0
    for leaf in _tree.leaves(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        total += leaf.numel() * leaf.element_size() if isinstance(leaf, torch.Tensor) else 4
    return total


def _run_and_analyze(cfg, cell, mesh, n_dev, opt_overrides=None) -> dict:
    run = cell_inputs(cfg, cell, mesh, opt_overrides)
    rec = rl.Recorder(watch=SSD_OPS)
    with sh.use_mesh(run["mesh"]):
        # A first, unrecorded step fills DTensor's sharding caches: a miss
        # runs planning ops of its own (chunks and cats of meta tensors,
        # ~4x the step's ops and ~10x its bytes at qwen1.5-110b's), which
        # the recorded step then does not see.
        run["fn"](*run["args"])
        with rec:
            out = run["fn"](*run["args"])
    memory = {"argument_size_in_bytes": local_bytes(run["args"]),
              "output_size_in_bytes": local_bytes(out),
              "temp_size_in_bytes": rec.peak_bytes - rec.live_at_peak(out)}

    report = rec.report(analytic_hbm_bytes=run["analytic_hbm"])
    model_fl = rl.model_flops_per_step(cfg, cell)
    per_dev_model_fl = model_fl / n_dev
    bound_s = max(report.compute_s, report.memory_s, report.collective_s)
    return {
        "n_devices": n_dev,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "param_dev_bytes": run["param_dev_bytes"],
        "state_dev_bytes": run["state_dev_bytes"],
        "memory_analysis": memory,
        "roofline": report.to_dict(),
        "model_flops_step": model_fl,
        "model_flops_dev": per_dev_model_fl,
        "useful_flops_ratio": per_dev_model_fl / report.flops if report.flops else None,
        # fraction of the card's peak the step achieves if it runs exactly at
        # its dominant roofline bound: (useful FLOPs / peak) / bound_time
        "roofline_fraction": (per_dev_model_fl / rl.PEAK_FLOPS) / bound_s if bound_s else None,
        "dominant": report.dominant(),
        "n_ops": rec.n_ops,
        "ssd_calls": dict(rec.watch),
    }


def _run_task(task: tuple) -> dict:
    arch, shape, multi_pod, out_dir, kw = task
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    r = run_cell(arch, shape, multi_pod, pathlib.Path(out_dir), **kw)
    r["cell_s"] = time.perf_counter() - t0
    return r


def run_cells(cells, out_dir: pathlib.Path, *, workers: int = 1, **kw) -> list[dict]:
    """``run_cell`` of each (arch, shape, multi_pod) in ``cells`` (``kw`` its
    options); the results in the order of ``cells``, each with its
    ``cell_s`` (wall seconds in its worker).  With ``workers`` > 1, or
    cells on both meshes, they run in spawned processes: one pool per mesh,
    so that a process never tears its fake process group down for the
    other size (a mesh's cached subgroups would outlive it)."""
    tasks = [(a, s, m, str(out_dir), kw) for a, s, m in cells]
    kinds = sorted({m for _, _, m in cells})
    if workers <= 1 and len(kinds) <= 1:
        return [_run_task(t) for t in tasks]
    import concurrent.futures
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out: dict = {}
    for kind in kinds:
        mine = [i for i, t in enumerate(tasks) if t[2] == kind]
        with concurrent.futures.ProcessPoolExecutor(max(1, workers),
                                                    mp_context=ctx) as pool:
            out.update(zip(mine, pool.map(_run_task, [tasks[i] for i in mine])))
    return [out[i] for i in range(len(tasks))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value (perf variants)")
    ap.add_argument("--tag", default="", help="suffix for variant result files")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workers", type=int, default=1,
                    help="processes to spread the cells over")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(
            v.lower(), int(v) if v.isdigit() else v)

    out_dir = pathlib.Path(args.out)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    if args.workers <= 1:  # print each cell as it ends
        for cell in cells:
            _print(run_cells([cell], out_dir, force=args.force, tag=args.tag,
                             cfg_overrides=overrides or None, device=args.device)[0])
    else:
        for r in run_cells(cells, out_dir, workers=args.workers, force=args.force, tag=args.tag,
                           cfg_overrides=overrides or None, device=args.device):
            _print(r)


def _print(r: dict) -> None:
    rf = r.get("roofline_fraction")
    extra = (f"dom={r.get('dominant')} roofline={rf:.3f}" if rf is not None
             else r.get("reason", r.get("error", ""))[:70])
    print(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s} {r['status']:5s} "
          f"wall={r.get('wall_s', 0)}s {extra}", flush=True)


if __name__ == "__main__":
    main()
