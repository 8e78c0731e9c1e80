"""Geometric multigrid V-cycle preconditioner for structured-grid problems
(port of magnetite_tpu/fem/multigrid.py).

  * transfers: bilinear prolongation and its exact adjoint restriction on
    the logical (rows, cols) grid, wrap-aware in cols (annulus);
  * coarse operators: Galerkin RAP computed on the device by stencil
    probing -- R(A(P(.))) applied to a few periodic comb vectors reads off
    all nine coarse 2x2 blocks exactly;
  * smoother: damped block-Jacobi (symmetric, so the V-cycle stays SPD and
    CG-compatible); the coarsest level is one dense inverse when small.

Fields are [2, rows, cols] (fem/stencil.py's layout). On the card every
level's matvec is the hand-written stencil kernel; the Galerkin probing
runs through the plain version, whose leading batch dimension takes the
place of the JAX package's `vmap` over probes. Every 2x2 block product is
written out as multiply-adds, so no TF32 path can reach it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .stencil import CENTER, OFFSETS, make_stencil_operator, stencil_matvec_plain


# ----------------------------- transfers ---------------------------------


def prolong(uc: torch.Tensor, wrap_cols: bool) -> torch.Tensor:
    """Bilinear interpolation coarse -> fine on [..., Rc, Cc] grids.

    Fine dims: rows 2*Rc-1; cols 2*Cc if wrap_cols else 2*Cc-1. Fine even
    nodes coincide with coarse nodes; odd nodes average their neighbours."""
    # along cols
    if wrap_cols:
        mid = 0.5 * (uc + torch.roll(uc, -1, dims=-1))
        x = torch.stack([uc, mid], dim=-1).reshape(*uc.shape[:-1], -1)
    else:
        mid = 0.5 * (uc[..., :-1] + uc[..., 1:])
        body = torch.stack([uc[..., :-1], mid], dim=-1).reshape(*uc.shape[:-1], -1)
        x = torch.cat([body, uc[..., -1:]], dim=-1)
    # along rows (never wrapped)
    mid = 0.5 * (x[..., :-1, :] + x[..., 1:, :])
    body = torch.stack([x[..., :-1, :], mid], dim=-2).reshape(
        *x.shape[:-2], -1, x.shape[-1]
    )
    return torch.cat([body, x[..., -1:, :]], dim=-2)


def restrict(rf: torch.Tensor, wrap_cols: bool) -> torch.Tensor:
    """Exact adjoint of `prolong` (P^T), fine -> coarse."""
    # rows adjoint: odd row k feeds even rows k and k + 1
    even, odd = rf[..., ::2, :], rf[..., 1::2, :]
    up = F.pad(odd, (0, 0, 1, 0))[..., : even.shape[-2], :]
    down = F.pad(odd, (0, 0, 0, 1))[..., : even.shape[-2], :]
    x = even + 0.5 * (up + down)
    # cols adjoint
    even, odd = x[..., ::2], x[..., 1::2]
    if wrap_cols:
        return even + 0.5 * (odd + torch.roll(odd, 1, dims=-1))
    up = F.pad(odd, (1, 0))[..., : even.shape[-1]]
    down = F.pad(odd, (0, 1))[..., : even.shape[-1]]
    return even + 0.5 * (up + down)


# --------------------------- Galerkin coarsening ---------------------------


def galerkin_coarse_stencil(
    op_fine: Callable[[torch.Tensor], torch.Tensor],
    rc: int,
    cc: int,
    wrap_cols: bool,
    dtype,
    device=None,
) -> torch.Tensor:
    """Coarse stencil [9, 2, 2, rc, cc] of R o A_fine o P by comb probing.

    Probe vectors are 1 on coarse nodes with (r % 3 == p, c % pc == q) for
    one displacement component; the coarse operator's reach is 1 in each
    grid direction, so every output entry belongs to exactly one stencil
    offset. pc = 4 for wrapped cols (power-of-two cols stay comb-consistent
    across the seam), 3 otherwise. `op_fine` takes the whole probe batch
    [P, 2, R, C] at once; the batch (24 probes at the fine size) is freed
    when this returns."""
    pc = 4 if wrap_cols else 3
    if wrap_cols and cc % pc != 0:
        raise ValueError(
            f"wrapped cols must be divisible by {pc} for probing, got {cc}"
        )
    r_ids = torch.arange(rc, device=device)[:, None] % 3  # [rc, 1]
    c_ids = torch.arange(cc, device=device)[None, :] % pc  # [1, cc]

    probes = torch.zeros((3, pc, 2, 2, rc, cc), dtype=dtype, device=device)
    for p in range(3):
        for q in range(pc):
            comb = ((r_ids == p) & (c_ids == q)).to(dtype)
            for comp in range(2):
                probes[p, q, comp, comp] = comb
    probes = probes.reshape(-1, 2, rc, cc)  # [P, 2, rc, cc]

    ys = restrict(op_fine(prolong(probes, wrap_cols)), wrap_cols)
    ys = ys.reshape(3, pc, 2, 2, rc, cc)  # [p, q, comp_in, comp_out, r, c]

    out = []
    for dr, dt in OFFSETS:
        p_sel = (r_ids + dr) % 3
        q_sel = (c_ids + dt) % pc
        # out-of-range neighbours of a non-wrapped grid contribute zero by
        # construction: no probe has a node there
        acc = torch.zeros((2, 2, rc, cc), dtype=dtype, device=device)
        for p in range(3):
            for q in range(pc):
                mask = ((p_sel == p) & (q_sel == q)).to(dtype)
                acc = acc + ys[p, q].permute(1, 0, 2, 3) * mask
        out.append(acc)
    return torch.stack(out)  # [9, 2(out), 2(in), rc, cc]


# ------------------------------ hierarchy ---------------------------------


@dataclass
class MGLevel:
    stencil: torch.Tensor  # [9, 2, 2, R, C]
    diag_inv: torch.Tensor  # [2, 2, R, C] inverse center blocks
    rows: int
    cols: int
    op: Callable[[torch.Tensor], torch.Tensor] = None  # the level's matvec
    # dense inverse of the whole level operator [2RC, 2RC], node-major (set
    # on the coarsest level when small): an exact coarse solve
    dense_inv: Optional[torch.Tensor] = None


# exact coarse solves above this many DOFs would cost more than they save
_DENSE_COARSE_MAX_DOF = 2048
# the JAX package's defaults, which every caller takes: at most 10 levels,
# none coarser than 8 cells a side; V(2, 2) damped block-Jacobi, and a deep
# 48-sweep smoothing "solve" on a coarsest level without a dense inverse
MAX_LEVELS = 10
MIN_SIZE = 8
SWEEPS = 2
COARSE_SWEEPS = 48
OMEGA = 0.7


def stencil_to_dense_device(stencil: torch.Tensor, wrap_cols: bool) -> torch.Tensor:
    """Expand [9, 2, 2, R, C] to a dense (2RC, 2RC) matrix on its device,
    node-major DOF order (node*2 + component), as fem/stencil.stencil_to_dense."""
    _, _, _, rows, cols = stencil.shape
    n = rows * cols
    dev = stencil.device
    r = torch.arange(rows, device=dev)[:, None]
    c = torch.arange(cols, device=dev)[None, :]
    k = torch.zeros((n, n, 2, 2), dtype=stencil.dtype, device=dev)
    for s, (dr, dt) in enumerate(OFFSETS):
        r2 = (r + dr).expand(rows, cols)
        c2 = (c + dt).expand(rows, cols)
        valid = (r2 >= 0) & (r2 < rows)
        if wrap_cols:
            c2 = c2 % cols
        else:
            valid = valid & (c2 >= 0) & (c2 < cols)
            c2 = c2.clamp(0, cols - 1)
        row_flat = (r * cols + c).expand(rows, cols).reshape(-1)
        col_flat = (r2.clamp(0, rows - 1) * cols + c2).reshape(-1)
        vals = stencil[s].permute(2, 3, 0, 1).reshape(n, 2, 2)
        vals = vals * valid.reshape(-1, 1, 1).to(stencil.dtype)
        k.index_put_((row_flat, col_flat), vals, accumulate=True)
    return k.permute(0, 2, 1, 3).reshape(2 * n, 2 * n)


def dense_coarse_inverse(stencil: torch.Tensor, wrap_cols: bool) -> torch.Tensor:
    """Inverse of the (SPD, BC-reduced) level operator, in the level's own
    dtype (the card factors f64 natively); computed once per hierarchy."""
    return torch.linalg.inv(stencil_to_dense_device(stencil, wrap_cols))


def apply_dense_inverse(dense_inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Exact coarse solve on a [2, R, C] field (node-major flattening), as
    a multiply and a row sum: no TF32 path, whatever the global flags."""
    _, rows, cols = r.shape
    r_flat = r.permute(1, 2, 0).reshape(1, -1)
    e = torch.sum(dense_inv * r_flat, dim=1)
    return e.reshape(rows, cols, 2).permute(2, 0, 1)


def _block_apply(blk: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[2, 2, R, C] x [2, R, C] -> [2, R, C], block by block."""
    return torch.stack([
        blk[0, 0] * v[0] + blk[0, 1] * v[1],
        blk[1, 0] * v[0] + blk[1, 1] * v[1],
    ])


def _center_inverse(stencil: torch.Tensor) -> torch.Tensor:
    d = stencil[CENTER]  # [2, 2, R, C]
    a, b = d[0, 0], d[0, 1]
    c, e = d[1, 0], d[1, 1]
    det = a * e - b * c
    det = torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
    return torch.stack([torch.stack([e, -b]), torch.stack([-c, a])]) / det


def can_coarsen(rows: int, cols: int, wrap_cols: bool) -> bool:
    if rows < 2 * MIN_SIZE + 1 or (rows - 1) % 2:
        return False
    if wrap_cols:
        return cols >= 2 * MIN_SIZE and cols % 2 == 0 and (cols // 2) % 4 == 0
    return cols >= 2 * MIN_SIZE + 1 and (cols - 1) % 2 == 0


def build_hierarchy(fine_stencil: torch.Tensor, wrap_cols: bool) -> list:
    """The level list (finest first). The fine stencil must already be the
    BC-reduced operator (identity on fixed DOFs), so every level inherits
    the boundary conditions through RAP."""
    rows, cols = fine_stencil.shape[-2], fine_stencil.shape[-1]
    dtype, dev = fine_stencil.dtype, fine_stencil.device
    levels = [
        MGLevel(
            stencil=fine_stencil,
            diag_inv=_center_inverse(fine_stencil),
            rows=rows,
            cols=cols,
            op=make_stencil_operator(fine_stencil, wrap_cols),
        )
    ]
    while len(levels) < MAX_LEVELS and can_coarsen(rows, cols, wrap_cols):
        rc = (rows - 1) // 2 + 1
        cc = cols // 2 if wrap_cols else (cols - 1) // 2 + 1
        fine = levels[-1].stencil
        coarse = galerkin_coarse_stencil(
            lambda v: stencil_matvec_plain(fine, v, wrap_cols),
            rc, cc, wrap_cols, dtype, dev,
        )
        levels.append(
            MGLevel(
                stencil=coarse,
                diag_inv=_center_inverse(coarse),
                rows=rc,
                cols=cc,
                op=make_stencil_operator(coarse, wrap_cols),
            )
        )
        rows, cols = rc, cc
    last = levels[-1]
    if len(levels) > 1 and 2 * last.rows * last.cols <= _DENSE_COARSE_MAX_DOF:
        last.dense_inv = dense_coarse_inverse(last.stencil, wrap_cols)
    return levels


# ------------------------------- V-cycle ----------------------------------


def _smooth(level: MGLevel, e, r, sweeps: int):
    """Damped block-Jacobi: e += omega * D^-1 (r - A e)."""
    for _ in range(sweeps):
        e = e + OMEGA * _block_apply(level.diag_inv, r - level.op(e))
    return e


def vcycle_preconditioner(levels: list, wrap_cols: bool):
    """apply(r [2, R, C]) -> approximate solution of A e = r. Symmetric by
    construction (matching pre/post Jacobi sweeps): an SPD preconditioner."""

    def cycle(l: int, r: torch.Tensor) -> torch.Tensor:
        level = levels[l]
        zero = torch.zeros_like(r)
        if l == len(levels) - 1:
            if level.dense_inv is not None:
                return apply_dense_inverse(level.dense_inv, r)
            return _smooth(level, zero, r, COARSE_SWEEPS)
        e = _smooth(level, zero, r, SWEEPS)
        res = r - level.op(e)
        ec = cycle(l + 1, restrict(res, wrap_cols))
        e = e + prolong(ec, wrap_cols)
        return _smooth(level, e, r, SWEEPS)

    def apply(r: torch.Tensor) -> torch.Tensor:
        return cycle(0, r)

    return apply
