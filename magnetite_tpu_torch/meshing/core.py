"""Mesh container + orientation normalization.

The device boundary of the framework: a `Mesh` is plain flat numpy arrays
(coords [N,2] f64, tris [E,3] i32) that land directly in JAX device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..errors import MesherError


@dataclass
class Mesh:
    """A 2D triangle mesh.

    coords: [N, 2] float64 node coordinates.
    tris:   [E, 3] int32 node indices per triangle (CCW after normalization).

    Structured meshes (from the generators) carry their logical grid:
    grid_shape=(rows, cols) with node index = row*cols + col, and wrap_cols
    True when the col axis is periodic (annulus). This unlocks the stencil
    operator and geometric-multigrid paths; unstructured meshes leave it None.
    """

    coords: np.ndarray
    tris: np.ndarray
    grid_shape: Optional[tuple[int, int]] = None
    wrap_cols: bool = False
    # True when the producer guarantees every coupling is between grid
    # neighbors ((dr, dt) in {-1,0,1}^2) -- lets the solver skip the host
    # grid-locality scan and build the stencil scatter pattern on device.
    grid_local: bool = False
    # True when connectivity is exactly the canonical cell split (two
    # triangles per cell along the (r,t)-(r+1,t+1) diagonal, as produced by
    # meshing.generators) -- unlocks scatter-free structured assembly.
    canonical_grid: bool = False

    @property
    def num_nodes(self) -> int:
        return int(self.coords.shape[0])

    @property
    def num_elements(self) -> int:
        return int(self.tris.shape[0])

    def validate(self) -> None:
        if self.coords.ndim != 2 or self.coords.shape[1] != 2:
            raise MesherError(f"coords must be [N,2], got {self.coords.shape}")
        if self.tris.ndim != 2 or self.tris.shape[1] != 3:
            raise MesherError(f"tris must be [E,3], got {self.tris.shape}")
        if self.num_elements and (
            self.tris.min() < 0 or self.tris.max() >= self.num_nodes
        ):
            raise MesherError("element node index out of range")


def signed_areas(coords: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Signed triangle areas, vectorized.

    0.5*(x0*(y1-y2) + x1*(y2-y0) + x2*(y0-y1))  (reference: src/solver.rs:187-193)
    """
    p = coords[tris]  # [E, 3, 2]
    x, y = p[..., 0], p[..., 1]
    return 0.5 * (
        x[:, 0] * (y[:, 1] - y[:, 2])
        + x[:, 1] * (y[:, 2] - y[:, 0])
        + x[:, 2] * (y[:, 0] - y[:, 1])
    )


def normalize_orientation(mesh: Mesh, threshold: float = 0.0) -> Mesh:
    """Reverse node order of triangles whose signed area is below `threshold`.

    The correct rule is threshold=0.0 (flip clockwise triangles to CCW).
    The reference uses threshold=1.0 (src/mesher.rs:522-526), which also flips
    already-CCW triangles smaller than unit area -- pass 1.0 to replicate that
    behavior for parity experiments. The flip is applied exactly once.
    """
    areas = signed_areas(mesh.coords, mesh.tris)
    flip = areas < threshold
    tris = mesh.tris.copy()
    tris[flip] = tris[flip][:, ::-1]
    return Mesh(
        coords=mesh.coords,
        tris=tris,
        grid_shape=mesh.grid_shape,
        wrap_cols=mesh.wrap_cols,
        grid_local=mesh.grid_local,
        canonical_grid=mesh.canonical_grid,
    )
