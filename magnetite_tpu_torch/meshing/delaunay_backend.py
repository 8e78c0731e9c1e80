"""Built-in Delaunay meshing backend (scipy, no external binaries).

The reference delegates all meshing to an external ``gmsh`` subprocess
(src/mesher.rs:481-519). That stays available as an optional backend
(`gmsh_backend`), but this built-in backend makes the framework
self-contained: polygon loops with holes -> quality triangle mesh, entirely
in-process.

Algorithm:
  1. Resample every loop's edges so boundary spacing <= h (the target
     characteristic length), keeping original vertices.
  2. Fill the interior with a hexagonal lattice of spacing h (hex packing
     gives near-equilateral Delaunay triangles), keeping only points inside
     the domain with >= 0.7h clearance from every boundary.
  3. Delaunay-triangulate hybrid-style: qhull (scipy.spatial) on the
     boundary band only; the deep interior's canonical hex triangles are
     emitted directly (see `triangulate` for the exactness argument).
  4. Drop triangles whose centroid falls outside the domain (removes hole
     fills and concave-region bridging) and drop unused nodes.
"""

from __future__ import annotations

import numpy as np

from ..errors import MesherError
from ..geometry.polygon import points_in_domain
from ..utils.logging import spanned
from .core import Mesh, normalize_orientation, signed_areas


def _resample_loop(loop: np.ndarray, h: float) -> np.ndarray:
    """Subdivide loop edges longer than h; keep original vertices."""
    if loop.shape[0] < 3:
        raise MesherError(
            f"geometry loop needs >= 3 vertices, got {loop.shape[0]}"
        )
    out = []
    v = loop.shape[0]
    for i in range(v):
        a = loop[i]
        b = loop[(i + 1) % v]
        length = float(np.hypot(*(b - a)))
        out.append(a)
        if length > h:
            n_sub = int(np.ceil(length / h))
            for k in range(1, n_sub):
                out.append(a + (b - a) * (k / n_sub))
    return np.asarray(out)


def _hex_lattice(bbox_min, bbox_max, h: float) -> tuple[np.ndarray, int, int]:
    """Hexagonal point lattice of spacing h covering the bbox.

    Returns (points [ny*nx, 2] row-major, ny, nx); index = row*nx + col,
    odd rows staggered +h/2 in x (the canonical triangulation in
    `_canonical_deep_tris` depends on exactly this layout)."""
    dx = h
    dy = h * np.sqrt(3.0) / 2.0
    nx = max(int(np.ceil((bbox_max[0] - bbox_min[0]) / dx)) + 2, 2)
    ny = max(int(np.ceil((bbox_max[1] - bbox_min[1]) / dy)) + 2, 2)
    xs = bbox_min[0] + dx * np.arange(nx)
    ys = bbox_min[1] + dy * np.arange(ny)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    gx = gx + (np.arange(ny) % 2)[:, None] * (dx / 2.0)  # stagger odd rows
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1), ny, nx


def _clearance_limited(
    points: np.ndarray, loops: list[np.ndarray], cutoff: float
) -> np.ndarray:
    """Min distance from each point to any loop segment, EXACT wherever
    the result is <= `cutoff`; values above the cutoff are loose upper
    bounds (+inf when outside every chunk's bbox). Callers must only
    compare the result against thresholds <= cutoff.

    The all-pairs kernel (min_distance_to_segments) materializes
    [P, V, 2] -- ~1 s at 1M lattice points even for a 12-segment
    rectangle-with-hole. Only points near the boundary matter (the
    clearance thresholds are a few h), so this runs the exact kernel on
    bbox-prefiltered subsets, 16 consecutive segments at a time (loop
    segments are a path, so a chunk's union bbox stays local)."""
    clearance = np.full(points.shape[0], np.inf)
    for loop in loops:
        a = loop
        b = np.roll(loop, -1, axis=0)
        for s in range(0, loop.shape[0], 16):
            a_c = a[s : s + 16]
            b_c = b[s : s + 16]
            lo = np.minimum(a_c, b_c).min(axis=0) - cutoff
            hi = np.maximum(a_c, b_c).max(axis=0) + cutoff
            m = np.nonzero(
                (points[:, 0] >= lo[0])
                & (points[:, 0] <= hi[0])
                & (points[:, 1] >= lo[1])
                & (points[:, 1] <= hi[1])
            )[0]
            if not m.size:
                continue
            # open-segment distances (polygon.min_distance_to_segments
            # treats its input as a CLOSED loop; a chunk's wrap edge
            # would be a chord that under-estimates clearance)
            ab = b_c - a_c  # [V,2]
            ab_len2 = np.maximum((ab**2).sum(axis=1), 1e-300)
            ap = points[m][:, None, :] - a_c[None, :, :]
            t = np.clip(
                (ap * ab[None, :, :]).sum(axis=2) / ab_len2[None, :],
                0.0,
                1.0,
            )
            closest = a_c[None, :, :] + t[:, :, None] * ab[None, :, :]
            d2 = ((points[m][:, None, :] - closest) ** 2).sum(axis=2)
            clearance[m] = np.minimum(clearance[m], np.sqrt(d2.min(axis=1)))
    return clearance


def _canonical_deep_tris(deep: np.ndarray, gid: np.ndarray) -> np.ndarray:
    """Canonical hex-lattice triangles whose three vertices are all deep.

    `deep` [ny, nx] bool, `gid` [ny, nx] global point ids. The hex
    lattice's Delaunay triangulation is its canonical triangulation
    (equilateral triangles, no cocircular degeneracies), so these are
    exactly the full point set's Delaunay triangles with all-deep
    vertices -- see `triangulate` for the partition argument."""
    ny, nx = deep.shape
    if ny < 2 or nx < 2:
        return np.zeros((0, 3), dtype=np.int64)
    par = (np.arange(ny - 1) % 2)[:, None]
    a = deep[:-1, :-1]
    b = deep[:-1, 1:]
    c = deep[1:, :-1]
    d = deep[1:, 1:]
    ga = gid[:-1, :-1]
    gb = gid[:-1, 1:]
    gc = gid[1:, :-1]
    gd = gid[1:, 1:]
    even = par == 0
    out = []
    for mask, (i, j, k) in (
        (a & b & c & even, (ga, gb, gc)),  # even strip, up
        (b & c & d & even, (gb, gc, gd)),  # even strip, down
        (a & b & d & ~even, (ga, gb, gd)),  # odd strip, up
        (a & c & d & ~even, (ga, gc, gd)),  # odd strip, down
    ):
        r, cc = np.nonzero(mask)
        if r.size:
            out.append(np.stack([i[r, cc], j[r, cc], k[r, cc]], axis=1))
    if not out:
        return np.zeros((0, 3), dtype=np.int64)
    return np.concatenate(out, axis=0)


_DEEP_CLEARANCE = 3.0  # x h: lattice points farther than this are "deep"
_RING_WIDTH = 3.0  # x h: deep points this close to the band join the qhull


@spanned("mesh.triangulate")
def triangulate(
    loops: list[np.ndarray],
    characteristic_length_min: float,
    characteristic_length_max: float,
) -> Mesh:
    """Mesh the domain bounded by loops[0] minus holes loops[1:].

    Hybrid Delaunay: the interior hex lattice's Delaunay triangulation
    is its canonical triangulation, so qhull only runs on the boundary
    BAND (boundary points + lattice points within a few h of a loop) --
    ~5 s -> ~0.2 s of the 1M-element mesh. The split is exact:

    * a full-set Delaunay triangle with all three vertices "deep"
      (clearance >= 3h) has circumradius 0.577h and every lattice
      neighbor present, so it is canonical -> emitted directly from the
      grid (`_canonical_deep_tris`);
    * a triangle with >= 1 band vertex has all vertices within ~2
      circumdiameters of the band, i.e. inside the band+ring subset, and
      a subset-Delaunay triangle with a band vertex whose circumcircle
      reached a NON-subset point (clearance >= 6h) would have
      circumradius >= 1.5h and thus contain subset lattice points --
      contradiction. So subset qhull reproduces exactly the full-set
      triangles with >= 1 band vertex; its all-deep triangles (the
      spurious ones spanning the subset's interior hole) are dropped.

    Parity with full-set qhull is asserted in tests across geometries.
    """
    from scipy.spatial import Delaunay, QhullError

    outer, holes = loops[0], list(loops[1:])
    if characteristic_length_max <= 0:
        raise MesherError("characteristic_length_max must be positive")
    h = float(characteristic_length_max)

    boundary_pts = np.concatenate(
        [_resample_loop(loop, h) for loop in loops], axis=0
    )
    # dedupe exactly-coincident boundary points (repeated loop vertices);
    # kept lattice points sit >= 0.7h off every segment so they can never
    # coincide with boundary points
    boundary_pts = np.unique(boundary_pts, axis=0)
    n_b = boundary_pts.shape[0]

    bbox_min = outer.min(axis=0)
    bbox_max = outer.max(axis=0)
    lattice, ny, nx = _hex_lattice(bbox_min, bbox_max, h)
    inside = points_in_domain(lattice, outer, holes)
    ring_cut = (_DEEP_CLEARANCE + _RING_WIDTH) * h
    clearance = _clearance_limited(lattice, loops, ring_cut + h)
    clearance[~inside] = -np.inf
    kept = inside & (clearance >= 0.7 * h)
    deep = kept & (clearance >= _DEEP_CLEARANCE * h)
    in_subset = kept & (clearance < ring_cut)

    lat_gid = -np.ones(ny * nx, dtype=np.int64)
    lat_gid[kept] = n_b + np.arange(int(kept.sum()))
    points = np.concatenate([boundary_pts, lattice[kept]], axis=0)
    if points.shape[0] < 3:
        raise MesherError("not enough points to mesh; refine the geometry")

    sub_ids = np.concatenate(
        [np.arange(n_b, dtype=np.int64), lat_gid[in_subset]]
    )
    sub_deep = np.concatenate(
        [np.zeros(n_b, dtype=bool), deep[in_subset]]
    )
    try:
        tri = Delaunay(points[sub_ids])
    except QhullError as err:
        # collinear/coincident boundary loops leave qhull no valid simplex;
        # surface it as the module's typed error like every other
        # bad-geometry path
        raise MesherError(
            "Delaunay triangulation failed -- the boundary geometry is "
            f"degenerate (collinear or coincident points?): {err}"
        ) from err
    st = tri.simplices
    st = st[~sub_deep[st].all(axis=1)]  # drop all-deep (incl. spanning)
    qtris = sub_ids[st]

    # only qhull triangles can stick out of the domain; canonical deep
    # triangles sit >= (3 - 0.6)h inside every loop by construction
    centroids = points[qtris].mean(axis=1)
    qtris = qtris[points_in_domain(centroids, outer, holes)]

    dtris = _canonical_deep_tris(deep.reshape(ny, nx), lat_gid.reshape(ny, nx))
    tris = np.concatenate([qtris, dtris], axis=0).astype(np.int32)
    if tris.shape[0] == 0:
        # every triangle was filtered (e.g. a hole congruent to the outer
        # loop): raise the typed error before the empty-area reduction below
        raise MesherError("meshing produced no elements inside the domain")

    # drop degenerate slivers (zero area after filtering)
    areas = np.abs(signed_areas(points, tris))
    tris = tris[areas > 1e-12 * max(areas.max(), 1.0)]

    # remove nodes not referenced by any kept triangle
    used = np.zeros(points.shape[0], dtype=bool)
    used[tris.reshape(-1)] = True
    remap = -np.ones(points.shape[0], dtype=np.int64)
    remap[used] = np.arange(int(used.sum()))
    kept_coords = points[used]
    kept_tris = remap[tris]

    # lattice-row node ordering: bin by lattice row, sort by x within rows.
    # Concentrates (col-row) offsets into a few dozen values so the solver's
    # banded (DIA/hybrid) SpMV applies instead of gather-ELL.
    dy = h * np.sqrt(3.0) / 2.0
    row_bin = np.round((kept_coords[:, 1] - kept_coords[:, 1].min()) / dy)
    order = np.lexsort((kept_coords[:, 0], row_bin))
    inv = np.empty(order.size, dtype=np.int64)
    inv[order] = np.arange(order.size)
    mesh = Mesh(
        coords=kept_coords[order],
        tris=inv[kept_tris].astype(np.int32),
    )
    mesh = normalize_orientation(mesh)
    mesh.validate()
    if mesh.num_elements == 0:
        raise MesherError("meshing produced no elements inside the domain")
    return mesh
