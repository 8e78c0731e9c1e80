"""Vectorized 2D polygon predicates (numpy, host-side)."""

from __future__ import annotations

import numpy as np


def polygon_signed_area(loop: np.ndarray) -> float:
    """Shoelace signed area of a closed loop [V,2] (CCW positive)."""
    x, y = loop[:, 0], loop[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    return 0.5 * float(np.sum(x * y2 - x2 * y))


def points_in_polygon(points: np.ndarray, loop: np.ndarray) -> np.ndarray:
    """Even-odd (ray crossing) point-in-polygon test, vectorized.

    points [P,2], loop [V,2] -> bool [P]. Boundary points are unspecified
    (callers keep a clearance margin from the boundary anyway).
    """
    x = points[:, 0][:, None]  # [P,1]
    y = points[:, 1][:, None]
    x1, y1 = loop[:, 0][None, :], loop[:, 1][None, :]  # [1,V]
    x2, y2 = np.roll(loop[:, 0], -1)[None, :], np.roll(loop[:, 1], -1)[None, :]
    crosses = ((y1 > y) != (y2 > y)) & (
        x < (x2 - x1) * (y - y1) / np.where(y2 == y1, np.inf, y2 - y1) + x1
    )
    return crosses.sum(axis=1) % 2 == 1


def min_distance_to_segments(points: np.ndarray, loop: np.ndarray) -> np.ndarray:
    """Min distance from each point to any edge of the closed loop.

    points [P,2], loop [V,2] -> [P]. O(P*V) vectorized.
    """
    a = loop  # [V,2]
    b = np.roll(loop, -1, axis=0)
    ab = b - a  # [V,2]
    ab_len2 = np.maximum((ab**2).sum(axis=1), 1e-300)  # [V]
    ap = points[:, None, :] - a[None, :, :]  # [P,V,2]
    t = np.clip((ap * ab[None, :, :]).sum(axis=2) / ab_len2[None, :], 0.0, 1.0)
    closest = a[None, :, :] + t[:, :, None] * ab[None, :, :]
    d2 = ((points[:, None, :] - closest) ** 2).sum(axis=2)
    return np.sqrt(d2.min(axis=1))


def points_in_domain(
    points: np.ndarray, outer: np.ndarray, holes: list[np.ndarray]
) -> np.ndarray:
    """Inside the outer loop and outside every hole."""
    inside = points_in_polygon(points, outer)
    for hole in holes:
        inside &= ~points_in_polygon(points, hole)
    return inside
