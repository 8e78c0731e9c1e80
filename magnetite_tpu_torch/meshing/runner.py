"""Mesher orchestration: geometry files -> Mesh + boundary arrays.

Mirrors reference src/mesher.rs:939-974: dispatch by file extension (an
``.svg`` wins and stops the scan; ``.csv`` files accumulate as
[outer, inner...]; anything else is an error), mesh the loops, normalize
orientation, apply boundary rules.

Backend selection is new (the reference hard-requires gmsh): ``"auto"``
uses gmsh when installed, otherwise the built-in Delaunay backend.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..bc import BCArrays, apply_boundary_conditions
from ..config import SimulationInput, SolverOptions
from ..errors import InputError
from ..geometry.csv_geom import parse_csv
from ..geometry.svg import parse_svg
from .core import Mesh, normalize_orientation
from . import delaunay_backend, gmsh_backend


def load_geometry(
    geometry_files: Sequence[str],
    min_element_length: float = 0.0,
    log: Callable[[str], None] = print,
) -> list[np.ndarray]:
    """Parse geometry files into vertex loops [outer, inner...]."""
    loops: list[np.ndarray] = []
    for path in geometry_files:
        if path.endswith(".svg"):
            loops = parse_svg(path, min_element_length, log=log)
            break
        elif path.endswith(".csv"):
            loops.append(parse_csv(path))
        else:
            raise InputError(f"Unrecognized geometry filetype {path}")
    if not loops:
        raise InputError("No geometry files provided")
    return loops


def mesh_loops(
    loops: list[np.ndarray],
    characteristic_length_min: float,
    characteristic_length_max: float,
    backend: str = "auto",
    ccw_threshold: float = 0.0,
    log: Callable[[str], None] = print,
) -> Mesh:
    """Triangulate vertex loops with the selected backend."""
    if backend == "auto":
        backend = "gmsh" if gmsh_backend.gmsh_available() else "delaunay"
    if backend == "gmsh":
        log("info: meshing with gmsh backend...")
        mesh = gmsh_backend.triangulate(
            loops, characteristic_length_min, characteristic_length_max
        )
    elif backend == "delaunay":
        log("info: meshing with built-in Delaunay backend...")
        mesh = delaunay_backend.triangulate(
            loops, characteristic_length_min, characteristic_length_max
        )
    else:
        raise InputError(f"unknown meshing backend '{backend}'")
    mesh = normalize_orientation(mesh, threshold=ccw_threshold)
    log(
        f"info: loaded {mesh.num_nodes} nodes and "
        f"{mesh.num_elements} elements"
    )
    return mesh


def run(
    geometry_files: Sequence[str],
    sim: SimulationInput,
    backend: str = "auto",
    options: SolverOptions = SolverOptions(),
    log: Callable[[str], None] = print,
) -> tuple[Mesh, BCArrays]:
    """Full mesher stage: files -> (Mesh, BCArrays)."""
    md = sim.metadata
    loops = load_geometry(
        geometry_files, md.characteristic_length_min, log=log
    )
    mesh = mesh_loops(
        loops,
        md.characteristic_length_min,
        md.characteristic_length_max,
        backend=backend,
        ccw_threshold=options.ccw_threshold,
        log=log,
    )
    log(f"info: loaded {len(sim.boundary_rules)} boundary rules from input file")
    bca = apply_boundary_conditions(mesh.coords, sim.boundary_rules)
    return mesh, bca
