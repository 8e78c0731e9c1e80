"""Finding a cell's files by name.

BENCHMARK.json names each cell's configuration and traffic; the files
behind those names sit in the benchmark's folder:

  configs/<config>.json    the deployment: geometry, material, supports,
                           loads, solver options, `reduced`, `assumed`
  traffic/<traffic>.json   the traffic: which driver runs it, the load-case
                           draw and the traced stretch
  drivers/<driver>.py      a closed-loop driver (code), named by traffic
  workloads/<cell>.json    the cell's own numbers: how many answers the
                           reference judges and the limit of each number
  metrics/<metric>.py      a per-layer metric's reader

A later change adds a cell as new files and new entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list
    folder: str  # the benchmark's folder


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, folder: str = "benchmark") -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files."""
    spec = _read_json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    entry = entries[0]
    base = os.path.join(root, folder)
    config = _read_json(os.path.join(base, "configs", entry["config"] + ".json"))
    traffic = _read_json(os.path.join(base, "traffic", entry["traffic"] + ".json"))
    workload = _read_json(os.path.join(base, "workloads", name + ".json"))
    if config.get("name") != entry["config"]:
        raise ValueError(f"configs/{entry['config']}.json names {config.get('name')!r}")
    if (workload.get("config"), workload.get("traffic")) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names another configuration or traffic")
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        workload=workload,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        folder=base,
    )


def load_module(path: str, name: str):
    """A module from a file, by path: drivers and metric readers are found
    by file name, which may hold dots."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def driver_of(cell: Cell):
    name = cell.traffic["driver"]
    return load_module(os.path.join(cell.folder, "drivers", name + ".py"), f"bench_driver_{name}")


def reader_of(cell: Cell, metric: str):
    return load_module(
        os.path.join(cell.folder, "metrics", metric + ".py"),
        "bench_metric_" + metric.replace(".", "_"),
    )
