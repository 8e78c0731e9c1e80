"""BENCHMARK.json against the contract it is written to, and every name in
it resolving to its files."""

import json
import os
import re

import pytest

from benchmark.harness import loadcase, spec

from .tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(os.path.join(REPO, "BENCHMARK.json")) as _fh:
    BENCH = json.load(_fh)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(REPO, c["file"]))
        assert c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0] and setup[0]["bound"] == 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in {"lower", "higher"}
        assert all(w in CELLS for w in m.get("workloads", []))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(REPO, cell)
    assert hasattr(spec.driver_of(c), "Session")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader_of(c, m["name"]).read)
        # the metric moves an end-to-end metric that this cell reports
        assert m["moves"] in names
    assert set(c.workload["check"]["limits"]) == {
        "residual", "support_gap", "force_gap", "stress_gap", "mesh_defects", "mesh_measure_gap",
        "mesh_size_gap"}


def test_load_cases_repeat_for_a_seed_and_differ_across_seeds():
    loads = {"pull": [0.005, 0.015], "shear": [-1e7, 1e7]}
    seed = 2**31 + 977
    a = [loadcase.draw(seed, i, loads) for i in range(50)]
    assert a == [loadcase.draw(seed, i, loads) for i in range(50)]
    assert a != [loadcase.draw(seed + 1, i, loads) for i in range(50)]
    assert a[0] != loadcase.draw(seed, 0, loads, loadcase.WARM_UP)
    assert all(0.005 <= x["pull"] <= 0.015 and abs(x["shear"]) <= 1e7 for x in a)
    # any whole number the driver may give, negative ones included
    assert loadcase.draw(-5, 0, loads) == loadcase.draw(-5, 0, loads)
