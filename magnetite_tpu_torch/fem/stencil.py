"""2D stencil (9-point block) operator for structured-grid meshes (port of
magnetite_tpu/fem/stencil.py).

For meshes whose nodes form a logical (rows x cols) grid (Mesh.grid_shape),
every stiffness coupling is between grid neighbours (dr, dt) in {-1,0,1}^2,
with the col axis optionally periodic (annulus wrap). The operator is stored
as stencil[9, 2, 2, rows, cols], cols minormost (the JAX package's layout,
so tests hand its numpy stencils straight to this module):

    y[i,r,c] = sum_{dr,dt} sum_j stencil[(dr+1)*3+dt+1, i, j, r, c] * u[j, r+dr, c+dt]

The host structure scan is a numpy copy of the JAX package's; assembly and
the matvec run on the device. On the card the matvec is the hand-written
CUDA kernel (kernels/stencil_kernel.py), on the CPU its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.stencil_kernel import (  # noqa: F401
    OFFSETS,
    shift2d,
    stencil_matvec,
    stencil_matvec_plain,
)

CENTER = 4  # index of (0, 0) in OFFSETS


@dataclass
class StencilStructure:
    """Scatter pattern mapping element blocks into the stencil array."""

    slot_ids: np.ndarray  # [E*9] int64: ((dr+1)*3+(dt+1))*R*C + r*C + c
    rows: int
    cols: int
    wrap_cols: bool


def build_stencil_structure(
    tris: np.ndarray, rows: int, cols: int, wrap_cols: bool
) -> Optional[StencilStructure]:
    """Build the pattern, or None if any coupling is not grid-local."""
    tris = np.asarray(tris, dtype=np.int64)
    a = np.repeat(tris, 3, axis=1).reshape(-1)  # row node of each pair
    b = np.tile(tris, (1, 3)).reshape(-1)  # col node
    ra, ca = a // cols, a % cols
    rb, cb = b // cols, b % cols
    dr = rb - ra
    dt = cb - ca
    if wrap_cols:
        dt = np.where(dt > cols // 2, dt - cols, dt)
        dt = np.where(dt < -(cols // 2), dt + cols, dt)
    if (np.abs(dr) > 1).any() or (np.abs(dt) > 1).any():
        return None
    s_idx = (dr + 1) * 3 + (dt + 1)
    slot_ids = s_idx * (rows * cols) + a
    return StencilStructure(
        slot_ids=slot_ids.astype(np.int64),
        rows=rows,
        cols=cols,
        wrap_cols=wrap_cols,
    )


def _plane_stress_coefficients(e_mod, nu):
    d0 = e_mod / (1.0 - nu * nu)
    return d0, nu * d0, 0.5 * (1.0 - nu) * d0


def assemble_stencil_fused(
    coords: torch.Tensor,  # [N, 2]
    tris: torch.Tensor,  # [E, 3] int64
    e_mod,
    nu,
    thickness,
    rows: int,
    cols: int,
    wrap_cols: bool,
) -> torch.Tensor:
    """Element stiffness + scatter in one pass -> stencil [9, 2, 2, R, C].

    Closed-form CST blocks for every node pair (a, b) of every element,
    laid out [3, 3, E], scattered with `index_add_` (the JAX package's
    `segment_sum`). On the card the atomic adds sum in a run-dependent
    order, so results agree with the JAX package to rounding, not bits."""
    at = tris.T  # [3, E]
    p = coords[at]  # [3, E, 2]
    x, y = p[..., 0], p[..., 1]
    beta = torch.stack([y[1] - y[2], y[2] - y[0], y[0] - y[1]])  # [3, E]
    gamma = torch.stack([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
    area2 = x[0] * (y[1] - y[2]) + x[1] * (y[2] - y[0]) + x[2] * (y[0] - y[1])
    coef = thickness / (2.0 * area2)  # t / (4A)
    d0, d1, d2 = _plane_stress_coefficients(e_mod, nu)

    ba, bb = beta[:, None, :], beta[None, :, :]  # [3, 3, E] (a-major)
    ga, gb = gamma[:, None, :], gamma[None, :, :]
    k00 = coef * (d0 * ba * bb + d2 * ga * gb)
    k01 = coef * (d1 * ba * gb + d2 * ga * bb)
    k10 = coef * (d1 * ga * bb + d2 * ba * gb)
    k11 = coef * (d0 * ga * gb + d2 * ba * bb)

    # pair-major scatter pattern [3, 3, E] matching the value layout
    a3, b3 = at[:, None, :], at[None, :, :]
    dr = torch.div(b3, cols, rounding_mode="floor") - torch.div(
        a3, cols, rounding_mode="floor"
    )
    dt = b3 % cols - a3 % cols
    if wrap_cols:
        dt = torch.where(dt > cols // 2, dt - cols, dt)
        dt = torch.where(dt < -(cols // 2), dt + cols, dt)
    slot = (((dr + 1) * 3 + (dt + 1)) * (rows * cols) + a3).reshape(-1)

    def scatter(k):
        out = torch.zeros(9 * rows * cols, dtype=coords.dtype, device=coords.device)
        return out.index_add_(0, slot, k.reshape(-1)).reshape(9, rows, cols)

    s00, s01, s10, s11 = scatter(k00), scatter(k01), scatter(k10), scatter(k11)
    return torch.stack(
        [torch.stack([s00, s01], dim=1), torch.stack([s10, s11], dim=1)], dim=1
    )


# canonical cell split shared by the mesh generators: every grid cell
# (r, t) -> two triangles along the (r,t)-(r+1,t+1) diagonal
_CELL_TRIS = (
    ((0, 0), (0, 1), (1, 1)),
    ((0, 0), (1, 0), (1, 1)),
)


def assemble_stencil_structured(
    coords: torch.Tensor,  # [R*C, 2]
    e_mod,
    nu,
    thickness,
    rows: int,
    cols: int,
    wrap_cols: bool,
) -> torch.Tensor:
    """Scatter-free assembly for canonical generator grids -> [9,2,2,R,C].

    Connectivity is implied by the grid (two triangles per cell along the
    (r,t)-(r+1,t+1) diagonal), so each of the 2 triangle types x 9 node
    pairs adds one shifted per-cell value grid into its stencil band: no
    atomics, deterministic on the card. Uses |2A|, so it does not depend on
    the elements' vertex order."""
    xg = coords[:, 0].reshape(rows, cols)
    yg = coords[:, 1].reshape(rows, cols)
    ct = cols if wrap_cols else cols - 1  # cells per row

    def node_grid(g, dr, dt):
        """Value of g at (cell_r + dr, cell_t + dt), on the cell grid."""
        v = g[dr : dr + rows - 1, :]
        if wrap_cols:
            return torch.roll(v, -dt, dims=1) if dt else v
        return v[:, dt : dt + ct]

    d0, d1, d2 = _plane_stress_coefficients(e_mod, nu)
    stencil = torch.zeros(
        (9, 2, 2, rows, cols), dtype=coords.dtype, device=coords.device
    )
    for tri in _CELL_TRIS:
        x = [node_grid(xg, dr, dt) for dr, dt in tri]  # 3 x [R-1, ct]
        y = [node_grid(yg, dr, dt) for dr, dt in tri]
        beta = [y[1] - y[2], y[2] - y[0], y[0] - y[1]]
        gamma = [x[2] - x[1], x[0] - x[2], x[1] - x[0]]
        area2 = x[0] * (y[1] - y[2]) + x[1] * (y[2] - y[0]) + x[2] * (y[0] - y[1])
        coef = thickness / (2.0 * torch.abs(area2))  # t / (4|A|)

        for a in range(3):
            ra, ta = tri[a]
            for b in range(3):
                ba_, bb_ = beta[a], beta[b]
                ga_, gb_ = gamma[a], gamma[b]
                kblk = torch.stack([
                    torch.stack([
                        coef * (d0 * ba_ * bb_ + d2 * ga_ * gb_),
                        coef * (d1 * ba_ * gb_ + d2 * ga_ * bb_),
                    ]),
                    torch.stack([
                        coef * (d1 * ga_ * bb_ + d2 * ba_ * gb_),
                        coef * (d0 * ga_ * gb_ + d2 * ba_ * bb_),
                    ]),
                ])  # [2, 2, R-1, ct]
                # destination: band (db - da), node (cell + da)
                s = (tri[b][0] - ra + 1) * 3 + (tri[b][1] - ta + 1)
                dst = stencil[s, :, :, ra : ra + rows - 1]
                if wrap_cols:
                    dst += torch.roll(kblk, ta, dims=-1) if ta else kblk
                else:
                    dst[..., ta : ta + ct] += kblk
    return stencil


def make_stencil_operator(stencil: torch.Tensor, wrap_cols: bool):
    """op(u [2, R, C]) -> K u: the CUDA kernel for card tensors, the plain
    version for CPU tensors."""

    def op(u: torch.Tensor) -> torch.Tensor:
        return stencil_matvec(stencil, u, wrap_cols)

    return op


def stencil_to_dense(stencil: np.ndarray, wrap_cols: bool) -> np.ndarray:
    """Expand to a dense (2RC, 2RC) matrix (testing only)."""
    _, _, _, r, c = stencil.shape
    n = r * c
    k = np.zeros((n, 2, n, 2))
    for s, (dr, dt) in enumerate(OFFSETS):
        for rr in range(r):
            r2 = rr + dr
            if r2 < 0 or r2 >= r:
                continue
            for cc in range(c):
                c2 = cc + dt
                if wrap_cols:
                    c2 %= c
                elif c2 < 0 or c2 >= c:
                    continue
                k[rr * c + cc, :, r2 * c + c2, :] += stencil[s, :, :, rr, cc]
    return k.reshape(2 * n, 2 * n)
