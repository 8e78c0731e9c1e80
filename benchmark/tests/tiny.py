"""A checkout of tiny cells for the benchmark's tests: a copy of
BENCHMARK.json and the benchmark's folder with new files and entries
only, as a later change would add a cell. The tiny configurations are
the real ones at a small size (the Delaunay plate at h = 0.05, 1,000-odd
nodes; the structured plate at 16 x 32 cells) under short traffic that
traces its second request."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.harness.inputs import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {
    "tiny_delaunay": ("delaunay_plate_1m", {"h": 0.05}),
    "tiny_structured": ("structured_plate_1m", {"n_radial": 16, "n_tangential": 32}),
}
CELLS = {
    "tiny_delaunay.load_cases": ("tiny_delaunay", "load_cases", "tiny_load_cases", "solve"),
    "tiny_structured.load_cases": ("tiny_structured", "load_cases", "tiny_load_cases", "solve"),
    "tiny_delaunay.fresh_jobs": ("tiny_delaunay", "fresh_jobs", "tiny_fresh_jobs", "job"),
    "tiny_delaunay.resumed_jobs": ("tiny_delaunay", "resumed_jobs", "tiny_resumed_jobs", "job"),
}
# the tiny cells' limits: the real cells' kinds of number, at a small size
LIMITS = {"residual": 1e-8, "support_gap": 1e-7, "force_gap": 1e-9, "stress_gap": 1e-9,
          "mesh_defects": 0.0, "mesh_measure_gap": 1e-9, "mesh_size_gap": 0.01}


def _dump(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def make_root(tmp: str) -> str:
    """A checkout under `tmp` with the tiny cells added as files and
    entries; returns its root."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    bench = os.path.join(root, "benchmark")
    for name, (real, sizes) in TINY.items():
        with open(os.path.join(bench, "configs", real + ".json")) as fh:
            cfg = json.load(fh)
        cfg["name"] = name
        cfg["geometry"].update(sizes)
        mesh = make_mesh(cfg)
        cfg["mesh"] = {"nodes": int(mesh.coords.shape[0]), "elements": int(len(mesh.tris))}
        _dump(os.path.join(bench, "configs", name + ".json"), cfg)
        spec["configs"].append({"name": name, "source": "tests", "why": "tests",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": sorted(sizes)})
    for cell, (cfg, real_traffic, traffic, kind) in CELLS.items():
        with open(os.path.join(bench, "traffic", real_traffic + ".json")) as fh:
            tr = json.load(fh)
        tr.update(warm_up=1, trace={"skip": 1, "requests": 2})
        _dump(os.path.join(bench, "traffic", traffic + ".json"), tr)
        _dump(os.path.join(bench, "workloads", cell + ".json"),
              {"config": cfg, "traffic": traffic, "check": {"sample": 2, "limits": LIMITS}})
        spec["workloads"].append({"name": cell, "config": cfg, "traffic": traffic,
                                  "chips": 1, "why": "tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            real_cells = [w["name"] for w in spec["workloads"]
                          if w["traffic"] == real_traffic and not w["name"].startswith("tiny")
                          and w["config"].split("_")[0] == TINY[cfg][0].split("_")[0]]
            if "workloads" in m and set(real_cells) & set(m["workloads"]):
                m["workloads"].append(cell)
    _dump(os.path.join(root, "BENCHMARK.json"), spec)
    return root
