"""BENCHMARK.json against the benchmark's contract, and the files it names."""
import math
import re

import pytest

from port_bench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = common.spec()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert (common.ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def _named():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_named()), ids=lambda v: str(v)[:40])
def test_names_units_and_lines(group, entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    for key in ("why", "layer", "source"):
        if key in entry and group in ("configs", "workloads", "per_layer"):
            assert LINE.match(entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_bounds_and_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    workloads = [w["name"] for w in BENCH["workloads"]]
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, math.floor(0.25 * len(workloads)))
    for name in workloads:
        mine = [m["name"] for m in common.metrics_for(BENCH, name, trace=False)]
        assert "setup_s" in mine and len(mine) >= 2
        assert common.metrics_for(BENCH, name, trace=True)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m.get("workloads", workloads):
            assert w in moved.get("workloads", workloads), (m["name"], w)


def test_every_named_file_exists():
    for c in BENCH["configs"]:
        path = common.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert common.config(c["name"])["name"] == c["name"]
    for w in BENCH["workloads"]:
        tr = common.traffic(w["traffic"])
        assert (common.BENCH / "drivers" / f"{tr['driver']}.py").is_file()
        lim = common.limits(w["name"])
        assert lim["workload"] == w["name"] and lim["numbers"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(common.reader(m["name"]))
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_ports_own(entry):
    from repro_torch.configs import get_config
    from repro_torch.models.model import meta_model

    cfg = common.config(entry["name"])
    port = common.port_config(cfg)
    assert port == get_config(entry["name"])
    assert sum(p.numel() for p in meta_model(port).parameters()) == cfg["parameters"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"]
