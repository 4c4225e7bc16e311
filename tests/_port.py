"""Shared helpers for the port's parity tests: one configuration built in both
packages (the JAX reference and ``repro_torch`` on the CPU), seeded workloads
made with numpy, a whole-state comparison, and for the timed pipeline a
namespace per package, pipelines built alike in both and a comparison of
everything a timed run produces (the block service's and checkpoint engine's
outputs among them)."""
import dataclasses
import math
import types

import numpy as np

from repro import cache as jcache
from repro import obs as jobs
from repro import service as jservice
from repro import sim as jsim
from repro.checkpoint import state_parity as jparity
from repro.checkpoint import zapraid_ckpt as jckpt
from repro.core import array as jarray
from repro.core import handlers as jhandlers
from repro.core import recovery as jrecovery
from repro.core import segment as jsegment
from repro.core import zns as jzns
from repro.distributed import elastic as jelastic
from repro.service import scenario as jscenario
from repro_torch import cache as tcache
from repro_torch import obs as tobs
from repro_torch import service as tservice
from repro_torch import sim as tsim
from repro_torch.checkpoint import state_parity as tparity
from repro_torch.checkpoint import zapraid_ckpt as tckpt
from repro_torch.core import array as tarray
from repro_torch.core import handlers as thandlers
from repro_torch.core import recovery as trecovery
from repro_torch.core import segment as tsegment
from repro_torch.core import zns as tzns
from repro_torch.core.zns import drive_images
from repro_torch.distributed import elastic as telastic
from repro_torch.service import scenario as tscenario

BB = 256  # block bytes: small, a multiple of 4 (int32 lanes)
LOGICAL = 256


def configs(scheme="raid5", n_drives=4, *, hybrid=False, jax_kw=None,
            zones=12, zone_cap=64, **kw):
    """(jax cfg, jax zns, port cfg, port zns) for one configuration: G=8,
    ``zones`` zones of ``zone_cap`` blocks per drive (12 of 64 unless given);
    ``kw`` overrides any config field, ``jax_kw`` goes to the reference only."""
    if hybrid:
        kw = {**dict(hybrid=True, n_small=1, n_large=1, small_chunk_blocks=1,
                     large_chunk_blocks=4), **kw}
    common = {**dict(scheme=scheme, n_drives=n_drives, group_size=8,
                     chunk_blocks=1, logical_blocks=LOGICAL, gc_free_segments_low=1,
                     append_order="rng"), **kw}
    jc = jarray.ZapRaidConfig(**common, **(jax_kw or {}))
    tc = tarray.ZapRaidConfig(**common, device="cpu")
    jz = jzns.ZnsConfig(n_zones=zones, zone_cap_blocks=zone_cap, block_bytes=BB)
    tz = tzns.ZnsConfig(n_zones=zones, zone_cap_blocks=zone_cap, block_bytes=BB)
    return jc, jz, tc, tz


def pair(*args, **kw):
    jc, jz, tc, tz = configs(*args, **kw)
    return jarray.ZapRAIDArray(jc, jz), tarray.ZapRAIDArray(tc, tz)


def workload(arr, seed=3, n_writes=150, large=False):
    """Seeded random writes of 1-3 blocks (and 4-8 with ``large``), then a
    flush.  Returns the logical image {lba: block}."""
    rng = np.random.default_rng(seed)
    ref = {}
    for _ in range(n_writes):
        n = int(rng.integers(4, 9)) if large and rng.random() < 0.3 \
            else int(rng.integers(1, 4))
        lba = int(rng.integers(0, LOGICAL - n))
        blk = rng.integers(0, 256, (n, BB), dtype=np.uint8)
        arr.write(lba, blk)
        for i in range(n):
            ref[lba + i] = blk[i].copy()
    arr.flush()
    return ref


def assert_same_state(a, b):
    """Drive media/OOB/CRC/UNC/write pointers/zone states and counters, L2P,
    per-segment validity and Stats are all equal."""
    for ia, ib in zip(drive_images(a.drives), drive_images(b.drives), strict=True):
        for key in ia:
            assert np.array_equal(ia[key], ib[key]), key
    lbas = np.arange(a.cfg.logical_blocks)
    assert np.array_equal(a.l2p.get_many(lbas), b.l2p.get_many(lbas))
    assert sorted(a.segments) == sorted(b.segments)
    for sid, ra in a.segments.items():
        rb = b.segments[sid]
        assert np.array_equal(ra.valid, rb.valid), sid
        assert ra.valid_count == rb.valid_count, sid
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


def read_all_equal(a, b):
    got = b.read(0, LOGICAL)
    assert np.array_equal(got, a.read(0, LOGICAL))
    return got


def lifecycle_identical(scheme, n, hybrid):
    """Write, read, degraded reads with each drive failed in turn, a real
    failure with survivor-width writes, rebuild and GC: state equal after
    every step."""
    a, b = pair(scheme, n, hybrid=hybrid)
    ref = workload(a, large=hybrid)
    workload(b, large=hybrid)
    assert_same_state(a, b)
    got = read_all_equal(a, b)
    for lba, blk in ref.items():
        assert np.array_equal(got[lba], blk)
    # degraded reads with each drive failed in turn (scalar and batched)
    some = sorted(ref)[::7]
    for d in range(n):
        a.drives[d].failed = b.drives[d].failed = True
        read_all_equal(a, b)
        for lba in some:
            assert np.array_equal(b.read(lba, 1), a.read(lba, 1))
        a.drives[d].failed = b.drives[d].failed = False
    assert_same_state(a, b)
    # a real failure: writes at survivor width, rebuild, re-widen, then GC
    for arr in (a, b):
        arr.fail_drive(1)
        workload(arr, seed=5, n_writes=40, large=hybrid)
    assert_same_state(a, b)
    read_all_equal(a, b)
    for arr in (a, b):
        arr.rebuild_drive(1)
    assert_same_state(a, b)
    assert a.gc_once() == b.gc_once()
    assert_same_state(a, b)
    read_all_equal(a, b)


# ------------------------------------------------------------ timed pipeline

# One namespace per package, so a scenario is written once and run through
# both: the reference (its default numpy codec path) and the port on the CPU.
JAX = types.SimpleNamespace(
    name="jax", array=jarray, zns=jzns, handlers=jhandlers, sim=jsim, obs=jobs,
    cache=jcache, recovery=jrecovery, segment=jsegment, service=jservice,
    scenario=jscenario, ckpt=jckpt, parity=jparity, elastic=jelastic)
PORT = types.SimpleNamespace(
    name="torch", array=tarray, zns=tzns, handlers=thandlers, sim=tsim, obs=tobs,
    cache=tcache, recovery=trecovery, segment=tsegment, service=tservice,
    scenario=tscenario, ckpt=tckpt, parity=tparity, elastic=telastic)


def cpu(pkg) -> dict:
    """The keyword that puts one of the port's entry points on the CPU (the
    reference takes none)."""
    return {"device": "cpu"} if pkg is PORT else {}


def timed_pair(scheme="raid5", n_drives=4, *, seed=0, flush_interval_us=1000.0,
               precondition_rounds=1, pkgs=(JAX, PORT), **kw):
    """Two timed pipelines, one per package of ``pkgs`` (the reference's and
    the port's), built by ``build_timed`` from :func:`configs` (Zone-Append
    order from the device model, ``kw`` as there) and preconditioned alike
    with ``precondition_rounds`` seeded overwrites of the whole volume."""
    kw.setdefault("append_order", "timed")
    jc, jz, tc, tz = configs(scheme, n_drives, **kw)
    pipes = []
    for pkg in pkgs:
        cfg, zns = (jc, jz) if pkg is JAX else (tc, tz)
        pipe = pkg.handlers.HandlerPipeline.build_timed(
            cfg, zns, seed=seed, flush_interval_us=flush_interval_us)
        if precondition_rounds:
            rng = np.random.default_rng(seed)
            pipe.precondition(
                (lba, rng.integers(0, 256, (1, zns.block_bytes), dtype=np.uint8))
                for _ in range(precondition_rounds)
                for lba in range(cfg.logical_blocks))
        pipes.append(pipe)
    return pipes[0], pipes[1]


def shift(reqs, t0):
    """A request stream re-based to start at virtual time ``t0``."""
    return [dataclasses.replace(r, t_us=r.t_us + t0) for r in reqs]


def same(a, b):
    """Equality of nested dicts/lists/tuples of numbers where NaN == NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def assert_same_recorder(ra, rb):
    """Every output of two ``LatencyRecorder`` s: samples, percentiles (all,
    by op, by tenant), stage sums and counts, notes and their counts.  The
    one host-clock value, the sum of ``encode_sync_us`` (the host wall time
    of the group encodes), is compared by its count only."""
    assert [dataclasses.astuple(s) for s in ra.samples] == \
        [dataclasses.astuple(s) for s in rb.samples]
    tenants = sorted({s.tenant for s in ra.samples})
    for tenant in (None, *tenants):
        for op in (None, "R", "W"):
            assert same(ra.percentiles(op=op, tenant=tenant),
                        rb.percentiles(op=op, tenant=tenant)), (tenant, op)
    assert dict(ra.stage_sums) == dict(rb.stage_sums)
    assert dict(ra.stage_counts) == dict(rb.stage_counts)
    assert dict(ra.tenant_stage_sums) == dict(rb.tenant_stage_sums)
    assert dict(ra.tenant_stage_counts) == dict(rb.tenant_stage_counts)
    host = "encode_sync_us"
    assert {k: v for k, v in ra.notes.items() if k != host} == \
        {k: v for k, v in rb.notes.items() if k != host}
    assert (host in ra.notes) == (host in rb.notes)
    assert dict(ra.note_counts) == dict(rb.note_counts)
    assert ra.to_bench_rows("x") == rb.to_bench_rows("x")
    assert ra.span_us() == rb.span_us()


def assert_same_timing(da, db):
    """A timed drive's bookings (not part of its image): zone and channel
    free times, Zone-Append slots, planned and booked chunk completions."""
    assert np.array_equal(da.t_zone_free, db.t_zone_free)
    assert da.channels == db.channels
    assert da.za_slots == db.za_slots
    assert da.chunk_done == db.chunk_done
    assert {z: list(q) for z, q in da._planned.items()} == \
        {z: list(q) for z, q in db._planned.items()}
    assert da.busy_us == db.busy_us


def assert_same_timed(pa, pb):
    """Two timed pipelines ended alike: recorder, stage counters, virtual
    clock, events fired, I/O watermark, drive bookings, and the array's
    drive images, L2P, validity and Stats."""
    assert_same_recorder(pa.recorder, pb.recorder)
    assert pa.counters == pb.counters
    assert pa.engine.now == pb.engine.now
    assert pa.engine.events_fired == pb.engine.events_fired
    assert pa.engine.io_watermark == pb.engine.io_watermark
    assert pa.engine.pending() == pb.engine.pending()
    for da, db in zip(pa.array.drives, pb.array.drives, strict=True):
        assert_same_timing(da, db)
    assert_same_state(pa.array, pb.array)


# ------------------------------------------------------------------ models

def to_torch(tree):
    """A tree of jax/numpy leaves as torch tensors of the same dtype (bf16
    through float32, which is exact)."""
    import torch

    def one(leaf):
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(arr))

    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return one(tree)


def model_pair(arch, **overrides):
    """(jax cfg, jax model, jax params, port model) of ``smoke(arch)`` with
    ``overrides`` on both sides: the reference's ``init(PRNGKey(0))`` tree
    carried into the port's model on the CPU by ``load_jax_params``."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.models.config import smoke as j_smoke
    from repro.models.model import build_model as j_build_model
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke
    from repro_torch.models.convert import load_jax_params
    from repro_torch.models.model import build_model

    jcfg = j_smoke(j_get_config(arch), **overrides)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(smoke(get_config(arch), **overrides), device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, jparams))
    return jcfg, jmodel, jparams, tmodel


def model_inputs(cfg, rng, b):
    """The non-token inputs a family's prefill takes, made with numpy: the
    reference's batch entries and the port's keyword arguments."""
    import jax.numpy as jnp
    import torch

    if cfg.family == "vlm":
        name, shape = "vis_embeds", (b, cfg.vis_prefix_len, cfg.vis_embed_dim)
    elif cfg.family == "encdec":
        name, shape = "frames", (b, cfg.enc_len, cfg.d_model)
    else:
        return {}, {}
    arr = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return {name: jnp.asarray(arr)}, {name: torch.from_numpy(arr)}


def assert_prefill_and_decode_match(arch, *, tol=2e-4, b=2, t=12, steps=3, **overrides):
    """``prefill`` logits and every cache entry, then ``steps`` decode steps'
    logits and caches (the KV caches grown by ``steps`` on both sides, as
    the reference's serve loop pads them), port against reference."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch.launch.serve import KV_CACHES, grow_cache

    jcfg, jmodel, jparams, tmodel = model_pair(arch, **overrides)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (b, t + steps))
    jextra, textra = model_inputs(jcfg, rng, b)

    def close(got, want, what):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol, err_msg=what)

    def same_cache(tc, jc, what):
        assert set(tc) == set(jc), what
        assert tc["len"] == int(jc["len"]), what
        for key in set(jc) - {"len"}:
            assert tuple(tc[key].shape) == jc[key].shape, (what, key)
            assert tc[key].dtype == torch.float32, (what, key)
            close(tc[key], jc[key], f"{what} cache {key}")

    jlog, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks[:, :t], jnp.int32),
                                                 **jextra})
    tlog, tc = tmodel.prefill(torch.from_numpy(toks[:, :t]), **textra)
    assert tuple(tlog.shape) == jlog.shape == (b, 1, jcfg.vocab)
    close(tlog, jlog, "prefill logits")
    same_cache(tc, jc, "prefill")
    jc = dict(jc)
    for key in KV_CACHES:
        if key in jc:
            pad = [(0, 0)] * jc[key].ndim
            pad[2] = (0, steps)
            jc[key] = jnp.pad(jc[key], pad)
    grow_cache(tc, steps)
    decode = jax.jit(jmodel.decode_step)
    for i in range(steps):
        tok = toks[:, t + i : t + i + 1]
        jlog, jc = decode(jparams, jc, jnp.asarray(tok, jnp.int32))
        tlog, tc = tmodel.decode_step(tc, torch.from_numpy(tok))
        close(tlog, jlog, f"decode step {i} logits")
        same_cache(tc, jc, f"decode step {i}")
    return tmodel
