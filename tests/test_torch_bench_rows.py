"""The last committed rows of ``BENCH_PR10.json`` that no other port test
holds, reproduced by the port on the CPU at zero tolerance: ``fig2/*``
(Figure 2's Zone Write and Zone Append rates), ``exp3/g*`` (the group-size
sweep), ``exp4/*`` (the RAID schemes), ``exp10/trace_model`` and the two
``gc/p99_*`` rows of the timed GC actor.

Each row runs the code of ``benchmarks/run.py`` that writes it
(``bench_zns_primitives``, ``bench_group_size``, ``bench_raid_schemes``,
``bench_trace``'s model row, ``bench_gc_pipeline``'s timed pair; the last
at fixed sizes, whatever ``--quick`` says) through the reference and
through the port: the two outputs must be equal, and the port's row as the
benchmark's ``emit`` writes it -- µs rounded to 0.01 and the derived string
-- must equal the committed one.  The first rows are the ZN540-calibrated
performance model's arithmetic; the ``gc`` rows are virtual time.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from _port import JAX, PORT, cpu, same
from repro.core import group_layout as jlayout
from repro.core import perfmodel as jpm
from repro.core import raid as jraid
from repro_torch.core import group_layout as tlayout
from repro_torch.core import perfmodel as tpm
from repro_torch.core import raid as traid

_BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCH_PR10.json").read_text())
# the modules the analytic rows read: (perfmodel, group_layout, raid)
MODELS = ((jpm, jlayout, jraid), (tpm, tlayout, traid))


def committed(name):
    """A committed row: (us_per_call, derived)."""
    return _BENCH[name]["us_per_call"], _BENCH[name]["derived"]


def _both(fn):
    """``fn(pkg)`` through both packages; the outputs must be equal.
    Returns the port's."""
    a, b = fn(JAX), fn(PORT)
    assert same(a, b), (a, b)
    return b


def _models(fn):
    """``fn(perfmodel, group_layout, raid)`` of each package; the outputs
    must be equal.  Returns the port's."""
    a, b = (fn(*mods) for mods in MODELS)
    assert same(a, b), (a, b)
    return b


# ------------------------------------------------------------ Figure 2

@pytest.mark.parametrize("zones", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("size", [4, 8, 16])
@pytest.mark.parametrize("op", ["zw", "za"])
def test_fig2_row(op, size, zones):
    def run(pm, _layout, _raid):
        if op == "zw":
            return pm.zone_write_tput(size, zones)
        return pm.zone_append_tput(size, 4, zones)

    tput = _models(run)
    assert committed(f"fig2/{op}_{size}k_z{zones}") == (0.0, f"{tput:.1f}MiB/s")


# ------------------------------------------------------------- Exp#3, #4

@pytest.mark.parametrize("g", [4, 16, 64, 256, 1024, 4096])
def test_exp3_group_size_row(g):
    def run(pm, layout, _raid):
        p = pm.zapraid_write_perf(k=3, m=1, chunk_kib=4, group_size=g)
        d = pm.degraded_read_latency_us(k=3, chunk_kib=4, group_size=g)
        cst = layout.CompactStripeTable(4, 274366, g)
        return p.throughput_mib_s, d, cst.memory_bytes()

    tput, dr, cst = _models(run)
    assert committed(f"exp3/g{g}") == (
        0.0, f"{tput:.0f}MiB/s_dr={dr:.0f}us_cst={cst // 1024}KiB")


@pytest.mark.parametrize("scheme", ["raid0", "raid01", "raid4", "raid5", "raid6"])
def test_exp4_scheme_row(scheme):
    def run(pm, _layout, raid):
        s = raid.make_scheme(scheme, 4)
        za = pm.zapraid_write_perf(k=s.k, m=s.m, chunk_kib=4, group_size=256)
        zw = pm.zapraid_write_perf(k=s.k, m=s.m, chunk_kib=4, group_size=1, use_append=False)
        return za.throughput_mib_s, zw.throughput_mib_s

    za, zw = _models(run)
    gain = za / zw - 1
    assert committed(f"exp4/{scheme}") == (
        0.0, f"zap={za:.0f}MiB/s_zw={zw:.0f}MiB/s_gain={gain * 100:.0f}%")


def test_exp10_trace_model_row():
    def run(pm, _layout, _raid):
        kw = dict(k=3, m=1, cs_kib=8, cl_kib=16, n_small=1, n_large=3, frac_small=0.75)
        zap = pm.hybrid_write_perf(**kw, group_size=256)
        zw = pm.hybrid_write_perf(**kw, group_size=1)
        return zap.throughput_mib_s, zw.throughput_mib_s

    zap, zw = _models(run)
    assert committed("exp10/trace_model") == (
        0.0, f"zap={zap:.0f}MiB/s_zw={zw:.0f}MiB/s_gain={100 * (zap / zw - 1):.0f}%")


# ------------------------------------------------- the timed GC actor

def _gc_pair(pkg):
    """``bench_gc_pipeline``'s timed pair: foreground write p99 with inline
    GC bursts, and under the paced background-GC actor (same load, same
    device model), with the actor's booked device time."""
    cfg = pkg.array.ZapRaidConfig(scheme="raid5", n_drives=4, group_size=8, chunk_blocks=1,
                                  logical_blocks=360, gc_free_segments_low=1, **cpu(pkg))
    zns = pkg.zns.ZnsConfig(n_zones=7, zone_cap_blocks=64, block_bytes=256)

    def make_pipe():
        rng = np.random.default_rng(11)
        pipe = pkg.handlers.HandlerPipeline.build_timed(cfg, zns, seed=11)
        pipe.precondition((i % 360, rng.integers(0, 256, (1, 256), dtype=np.uint8))
                          for i in range(900))
        return pipe

    load = pkg.sim.multi_tenant([
        pkg.sim.TenantSpec(name="writer", kind="seq", n_ops=500, rate_iops=50_000, seed=41),
        pkg.sim.TenantSpec(name="reader", kind="uniform", n_ops=300, rate_iops=20_000,
                           read_frac=1.0, seed=42),
    ], logical_blocks=360)
    inline = make_pipe().replay(load)
    pipe = make_pipe()
    pipe.schedule_gc(at=5.0, interval_us=300.0, n_ticks=200)
    actor = pipe.replay(load)
    return (inline.percentiles(op="W")["p99"], actor.percentiles(op="W")["p99"],
            actor.notes.get("gc_device_us", 0.0))


@pytest.fixture(scope="module")
def gc_pair():
    return _both(_gc_pair)


@pytest.mark.parametrize("row", ["gc/p99_inline_bursts", "gc/p99_under_paced_gc"])
def test_gc_p99_row(gc_pair, row):
    p_i, p_a, busy = gc_pair
    want = {"gc/p99_inline_bursts": (round(p_i, 2), "write_p99_us_sim"),
            "gc/p99_under_paced_gc": (round(p_a, 2),
                                      f"{p_i / max(p_a, 1e-9):.2f}x_better_gc_busy={busy:.0f}us")}
    assert committed(row) == want[row]
