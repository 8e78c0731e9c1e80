"""The reference's judgement of one solved load case.

Everything here is worked out again from the configuration, the load case
and the mesh that the run solved on: which degrees of freedom the supports
hold and at what value, the applied forces, K u, the element stresses, and
the domain's area and boundary length. The run's answers are read only to
be judged.

Numbers (each the worst over what it covers; smaller is better):
  residual      ||free * (f - K u_bar)|| / ||free * (f - K u_fixed)||, u_bar
                the run's u with its held dofs at their prescribed values:
                the relative residual of the reduced system at the run's
                free dofs, the measure that the configuration's cg_rtol
                states (the held dofs are support_gap's)
  support_gap   max |u - u_prescribed| on held dofs / max |u_prescribed|
  force_gap     max |f_run - f_ref| / max |f_ref|, f_ref = K u on held
                dofs and the applied force on free ones
  stress_gap    max over sigma's components, the scalar stress and the
                von Mises stress of max |run - ref| / max |ref|, the
                reference's stresses taken from the run's u
  mesh_defects  elements of non-positive area, directed edges used twice,
                nodes no element uses (exact: 0)
  mesh_measure_gap  the larger of |area - domain area| / domain area and
                |boundary length - domain perimeter| / domain perimeter
  mesh_size_gap the larger of |nodes - stated| / stated and |elements -
                stated| / stated, against the counts the configuration
                states for its resolution: a coarser mesh of the same
                domain reads far off
"""

from __future__ import annotations

import math

import numpy as np

from . import plane_stress


def region_hits(coords: np.ndarray, region: dict) -> np.ndarray:
    """Nodes strictly inside an axis-aligned box (missing sides are open)."""
    x, y = coords[:, 0], coords[:, 1]
    return (
        (x > region.get("x_min", -math.inf)) & (x < region.get("x_max", math.inf))
        & (y > region.get("y_min", -math.inf)) & (y < region.get("y_max", math.inf))
    )


def boundary_arrays(coords: np.ndarray, supports: list, load_case: dict):
    """(held [N, 2] bool, prescribed u [N, 2], applied f [N, 2]).

    Rules apply in order and later rules win. A rule names, for each axis,
    a displacement (`ux` / `uy`) or a force (`fx` / `fy`). A number is the
    value at every node it covers; a name is a load-case variable: a
    displacement takes its value, a force its total, spread evenly over the
    rule's nodes."""
    n = coords.shape[0]
    held = np.zeros((n, 2), bool)
    u = np.zeros((n, 2))
    f = np.zeros((n, 2))
    for rule in supports:
        hit = region_hits(coords, rule["region"])
        count = max(int(hit.sum()), 1)
        for axis, (uk, fk) in enumerate((("ux", "fx"), ("uy", "fy"))):
            if uk in rule:
                v = rule[uk]
                held[hit, axis] = True
                u[hit, axis] = load_case[v] if isinstance(v, str) else float(v)
                f[hit, axis] = 0.0
            elif fk in rule:
                v = rule[fk]
                held[hit, axis] = False
                u[hit, axis] = 0.0
                f[hit, axis] = load_case[v] / count if isinstance(v, str) else float(v)
    return held, u, f


def domain_measures(geometry: dict) -> tuple:
    """(area, boundary length) of the configured domain."""
    if geometry["kind"] == "polygons":
        area = perimeter = 0.0
        for i, loop in enumerate(geometry["loops"]):
            p = np.asarray(loop, float)
            q = np.roll(p, -1, axis=0)
            a = 0.5 * abs(np.sum(p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]))
            area += a if i == 0 else -a
            perimeter += float(np.sum(np.hypot(*(q - p).T)))
        return area, perimeter
    if geometry["kind"] == "plate_with_hole":
        # a square of half-width w less the regular n-gon inscribed in the hole
        w, r, n = geometry["half_width"], geometry["hole_radius"], geometry["n_tangential"]
        hole_area = 0.5 * n * r * r * math.sin(2.0 * math.pi / n)
        hole_perimeter = 2.0 * n * r * math.sin(math.pi / n)
        return 4.0 * w * w - hole_area, 8.0 * w + hole_perimeter
    raise ValueError(f"unknown geometry kind {geometry['kind']!r}")


def mesh_numbers(coords: np.ndarray, tris: np.ndarray, geometry: dict, size: dict) -> dict:
    """mesh_defects, mesh_measure_gap and mesh_size_gap of one mesh;
    `size` is the configuration's stated {"nodes": ..., "elements": ...}."""
    tris = np.asarray(tris, np.int64)
    n = coords.shape[0]
    _, _, area2 = plane_stress.element_geometry(coords, tris)
    bad = int(np.count_nonzero(area2 <= 0.0))
    directed = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    key = directed[:, 0] * n + directed[:, 1]
    uniq, counts = np.unique(key, return_counts=True)
    bad += int(np.count_nonzero(counts > 1))
    bad += int(n - np.unique(tris).size)
    # a directed edge whose reverse is absent lies on the boundary
    src, dst = uniq // n, uniq % n
    reverse = dst * n + src
    on_boundary = ~np.isin(reverse, uniq, assume_unique=False)
    length = float(np.sum(np.hypot(*(coords[dst[on_boundary]] - coords[src[on_boundary]]).T)))
    area = float(np.sum(area2)) * 0.5
    want_area, want_length = domain_measures(geometry)
    gap = max(abs(area - want_area) / want_area, abs(length - want_length) / want_length)
    size_gap = max(abs(n - size["nodes"]) / size["nodes"],
                   abs(tris.shape[0] - size["elements"]) / size["elements"])
    return {"mesh_defects": float(bad), "mesh_measure_gap": gap, "mesh_size_gap": size_gap}


def _gap(run: np.ndarray, ref: np.ndarray) -> float:
    scale = float(np.max(np.abs(ref)))
    return float(np.max(np.abs(np.asarray(run, np.float64) - ref))) / max(scale, 1e-300)


def solve_numbers(coords, tris, material: dict, supports: list, load_case: dict,
                  answer: dict, sign_threshold: float = 1.0) -> dict:
    """residual, support_gap, force_gap and stress_gap of one answer
    (u, f, sigma, stress, von_mises as arrays in the mesh's node order)."""
    e, nu, t = material["youngs_modulus"], material["poisson_ratio"], material["part_thickness"]
    held, u_pre, f_app = boundary_arrays(coords, supports, load_case)
    u = np.asarray(answer["u"], np.float64)
    free = ~held
    ku = plane_stress.apply_stiffness(coords, tris, u, e, nu, t)
    ku_fixed = plane_stress.apply_stiffness(coords, tris, np.where(held, u_pre, 0.0), e, nu, t)
    ku_free = plane_stress.apply_stiffness(coords, tris, np.where(held, 0.0, u), e, nu, t)
    b = np.where(free, f_app - ku_fixed, 0.0)
    r = np.where(free, b - ku_free, 0.0)
    residual = float(np.linalg.norm(r) / max(np.linalg.norm(b), 1e-300))
    support_gap = float(np.max(np.abs(u[held] - u_pre[held]), initial=0.0)) / max(
        float(np.max(np.abs(u_pre[held]), initial=0.0)), 1e-300
    )
    f_ref = np.where(held, ku, f_app)
    sigma = plane_stress.stresses(coords, tris, u, e, nu)
    stress_gap = max(
        _gap(answer["sigma"], sigma),
        _gap(answer["stress"], plane_stress.scalar_stress(sigma, sign_threshold)),
        _gap(answer["von_mises"], plane_stress.von_mises(sigma)),
    )
    return {
        "residual": residual,
        "support_gap": support_gap,
        "force_gap": _gap(answer["f"], f_ref),
        "stress_gap": stress_gap,
    }
