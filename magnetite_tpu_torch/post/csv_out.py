"""Simulation result CSV writers (schema parity with the reference).

nodes.csv:    header ``x,y,ux,uy``      (reference: src/post_processor.rs:42-56)
elements.csv: header ``n0,n1,n2,stress`` (reference: src/post_processor.rs:59-75)

Floats are written with shortest round-trip repr (same family of formatting
as Rust's Display). Vectorized numpy savetxt is avoided deliberately: repr
keeps full precision without 17-digit noise.
"""

from __future__ import annotations

import numpy as np

from ..errors import PostProcessorError
from ..fem.solve import SolveResult
from ..meshing.core import Mesh


def write_results(
    mesh: Mesh,
    result: SolveResult,
    nodes_path: str = "nodes.csv",
    elements_path: str = "elements.csv",
    log=print,
) -> None:
    try:
        with open(nodes_path, "w") as f:
            f.write("x,y,ux,uy\n")
            rows = np.concatenate([mesh.coords, result.u], axis=1).tolist()
            f.writelines(
                f"{x!r},{y!r},{ux!r},{uy!r}\n" for x, y, ux, uy in rows
            )
        with open(elements_path, "w") as f:
            f.write("n0,n1,n2,stress\n")
            tri_rows = mesh.tris.tolist()
            stress_rows = result.stress.astype(np.float64).tolist()
            f.writelines(
                f"{t[0]},{t[1]},{t[2]},{s!r}\n"
                for t, s in zip(tri_rows, stress_rows)
            )
    except OSError as err:
        raise PostProcessorError(f"Failed to write output CSVs: {err}")
    log(f"info: wrote output to {nodes_path} and {elements_path}")


def read_nodes_csv(path: str) -> np.ndarray:
    """Read a nodes.csv back -> [N,4] (x, y, ux, uy)."""
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


def read_elements_csv(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read an elements.csv back -> (tris [E,3] int, stress [E])."""
    data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return data[:, :3].astype(np.int32), data[:, 3]
