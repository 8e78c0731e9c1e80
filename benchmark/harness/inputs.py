"""The program's inputs, made from a configuration and a load case through
its public entries: the mesh (`meshing.delaunay_backend.triangulate`,
`meshing.generators.plate_with_hole_mesh`), the boundary conditions
(`bc.apply_boundary_conditions`), the material and the solver options."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..reference.judge import region_hits


def make_mesh(config: dict):
    geometry = config["geometry"]
    if geometry["kind"] == "polygons":
        from magnetite_tpu_torch.meshing.delaunay_backend import triangulate

        loops = [np.asarray(loop, np.float64) for loop in geometry["loops"]]
        return triangulate(loops, 0.0, float(geometry["h"]))
    if geometry["kind"] == "plate_with_hole":
        from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh

        return plate_with_hole_mesh(
            geometry["n_radial"], geometry["n_tangential"],
            hole_radius=geometry["hole_radius"], half_width=geometry["half_width"],
        )
    raise ValueError(f"unknown geometry kind {geometry['kind']!r}")


def metadata(config: dict):
    from magnetite_tpu_torch.config import ModelMetadata

    m = config["material"]
    return ModelMetadata(
        youngs_modulus=m["youngs_modulus"], poisson_ratio=m["poisson_ratio"],
        part_thickness=m["part_thickness"], characteristic_length_min=0.0,
        characteristic_length_max=float(config["geometry"].get("h", 0.01)),
    )


def solver_options(config: dict, control: bool = False, **extra):
    """The configuration's SolverOptions; with `control`, its
    `control_solver` (the program's own lower-precision path)."""
    from magnetite_tpu_torch.config import SolverOptions

    return SolverOptions(**config["control_solver" if control else "solver"], **extra)


def boundary_rules(config: dict, coords: np.ndarray, load_case: dict) -> tuple:
    """The supports as the program's BoundaryRules, with the load case's
    values: a named force is the load case's total over the rule's nodes."""
    from magnetite_tpu_torch.config import BoundaryRegion, BoundaryRule, BoundaryTarget

    rules = []
    for rule in config["supports"]:
        region = {k: rule["region"].get(k, v) for k, v in
                  (("x_min", -math.inf), ("x_max", math.inf),
                   ("y_min", -math.inf), ("y_max", math.inf))}
        count = max(int(region_hits(coords, region).sum()), 1)
        target = {}
        for key in ("ux", "uy", "fx", "fy"):
            if key in rule:
                v = rule[key]
                if isinstance(v, str):
                    v = load_case[v] / count if key[0] == "f" else load_case[v]
                target[key] = float(v)
        rules.append(BoundaryRule(rule["name"], BoundaryRegion(**region), BoundaryTarget(**target)))
    return tuple(rules)


def boundary_arrays(config: dict, coords: np.ndarray, load_case: dict):
    from magnetite_tpu_torch.bc import apply_boundary_conditions

    return apply_boundary_conditions(coords, boundary_rules(config, coords, load_case))


class LoadCaseFields:
    """New load cases for one compiled problem, made on its device.

    The supports never change, so a load case changes only the values of
    the (node, axis) pairs that a load-case variable sets: set-up finds
    them once, in the problem's renumbered order (`perm[new] = old`), and
    each load case writes its values into copies of the compiled
    problem's `u_value` / `f_value`; every other value stays as compiled."""

    def __init__(self, config: dict, coords: np.ndarray, problem):
        import torch

        n = coords.shape[0]
        perm = problem.perm if problem.perm is not None else np.arange(n)
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        self.problem = problem
        self.writes = []  # (field, axis, node indices on the device, variable, divisor)
        owner = np.full((n, 2), -1)
        for i, rule in enumerate(config["supports"]):
            hit = region_hits(coords, rule["region"])
            for axis in (0, 1):
                if any(k in rule for k in (("ux", "fx"), ("uy", "fy"))[axis]):
                    owner[hit, axis] = i
        for i, rule in enumerate(config["supports"]):
            count = max(int(region_hits(coords, rule["region"]).sum()), 1)
            for axis, keys in enumerate((("ux", "fx"), ("uy", "fy"))):
                for key in keys:
                    v = rule.get(key)
                    if isinstance(v, str):
                        nodes = inv[np.nonzero(owner[:, axis] == i)[0]]
                        field = "u_value" if key[0] == "u" else "f_value"
                        divisor = 1.0 if field == "u_value" else float(count)
                        idx = torch.from_numpy(np.sort(nodes)).to(problem.device)
                        self.writes.append((field, axis, idx, v, divisor))
        held = boundary_arrays(config, coords, {k: 0.0 for k in config["loads"]}).u_known
        if not np.array_equal(problem.u_known.cpu().numpy(), held[perm]):
            raise ValueError("the compiled problem holds other supports than the configuration")

    def apply(self, load_case: dict):
        """The compiled problem with this load case's u_value and f_value."""
        fields = {"u_value": self.problem.u_value.clone(), "f_value": self.problem.f_value.clone()}
        for field, axis, idx, name, divisor in self.writes:
            fields[field][idx, axis] = load_case[name] / divisor
        return dataclasses.replace(self.problem, **fields)


def readings_of(res, **spans) -> dict:
    """A request's readings, those the per-layer metrics read: the
    benchmark's own spans, the device solve's span, the iterations and,
    where the request compiled, the AMG build's span."""
    out = dict(spans, device_s=res.timings["solve_s"], iterations=res.iterations)
    if "amg_build_s" in res.timings:
        out["amg_build_s"] = res.timings["amg_build_s"]
    return out


def shapes_of(problem) -> dict:
    """The compiled problem's operator shapes, for the kernels' byte counts:
    the level-0 bands of a banded operator and the multigrid levels."""
    system = problem.system
    out = {"mode": problem.mode, "nodes": int(problem.coords.shape[0])}
    if getattr(system, "offsets", None) is not None and getattr(system, "bands", None) is not None:
        out["dia_level0"] = {"n_diags": len(system.offsets), "n": int(system.bands.shape[-1])}
    levels = getattr(system, "mg_levels", None)
    if levels:
        out["mg_levels"] = [
            {"rows": int(lv.rows), "cols": int(lv.cols), "dense": lv.dense_inv is not None}
            for lv in levels
        ]
        out["mg_wrap"] = bool(system.grid.wrap)
    return out
