"""Fused multigrid smoothing: CUDA kernels `mg_presmooth<T, WRAP>` and
`mg_postsmooth<T, WRAP>` (csrc/mg_smooth.cu) and their plain versions.

One V-cycle level is two calls:

    mg_presmooth(S, Dinv, r)          -> e = smooth^2(0; r), rc = restrict(r - S e)
    mg_postsmooth(S, Dinv, r, e, ec)  -> smooth^2(e + prolong(ec); r)

with smooth(e; r) = e + OMEGA Dinv (r - S e), one damped block-Jacobi
sweep, S the level's stencil [9, 2, 2, R, C] and Dinv [2, 2, R, C] its
inverse center blocks. `mg_postsmooth` takes e=None (zero) and ec=None (no
correction) for the coarsest level's smoothing solve. The kernels replace
the V-cycle's use of magnetite_tpu/pallas/stencil_kernel.py::_kernel: five
stencil calls per level there, plus the updates and transfers around them.

The grid transfers `prolong` / `restrict` live here too (fem/multigrid.py
re-exports them): the plain versions are exactly the V-cycle's former
composition, so a CPU operand gives the same bits as before. A CUDA operand
launches the kernel or raises `KernelError`. Each wrapper counts its
launches in `.launches` and, per (rows, cols, dtype), in `.shape_launches`.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from ..fem.blocks import apply_blocks
from . import cuda_lib
from .stencil_kernel import stencil_matvec_plain

# damped block-Jacobi weight and sweeps per smoothing phase (the JAX
# package's defaults, which every caller takes)
OMEGA = 0.7
SWEEPS = 2


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


def coarse_shape(rows: int, cols: int, wrap_cols: bool) -> Optional[tuple]:
    """(Rc, Cc) of the grid that `prolong` maps onto (rows, cols), or None
    when no coarse grid fits it exactly."""
    if rows < 3 or rows % 2 == 0 or cols < 2 or (cols % 2 == 0) != bool(wrap_cols):
        return None
    return (rows + 1) // 2, (cols // 2 if wrap_cols else (cols + 1) // 2)


# ---------------------------- plain versions ------------------------------


def smooth_plain(stencil, diag_inv, e, r, wrap_cols: bool, sweeps: int):
    """Damped block-Jacobi: e += OMEGA * Dinv (r - S e), `sweeps` times."""
    for _ in range(sweeps):
        e = e + OMEGA * apply_blocks(diag_inv, r - stencil_matvec_plain(stencil, e, wrap_cols))
    return e


def mg_presmooth_plain(stencil, diag_inv, r, wrap_cols: bool):
    """(e, rc): two sweeps from zero, and the restricted residual."""
    e = smooth_plain(stencil, diag_inv, torch.zeros_like(r), r, wrap_cols, SWEEPS)
    return e, restrict(r - stencil_matvec_plain(stencil, e, wrap_cols), wrap_cols)


def mg_postsmooth_plain(stencil, diag_inv, r, e, ec, wrap_cols: bool):
    """Two sweeps from e + prolong(ec) (e=None: zero; ec=None: no correction)."""
    if e is None:
        e = torch.zeros_like(r)
    if ec is not None:
        e = e + prolong(ec, wrap_cols)
    return smooth_plain(stencil, diag_inv, e, r, wrap_cols, SWEEPS)


# ------------------------------- kernels ----------------------------------


def _check(name, stencil, diag_inv, r, fields, wrap_cols, coarse):
    """Raise KernelError unless every operand fits the level's grid; returns
    (rows, cols, (Rc, Cc) or None)."""
    rows, cols = stencil.shape[-2], stencil.shape[-1]
    rcc = coarse_shape(rows, cols, wrap_cols)
    shapes = [(t, (2, rows, cols)) for t in fields]
    if coarse is not None:
        shapes.append((coarse, (2, *rcc) if rcc else None))
    ok = (
        tuple(stencil.shape) == (9, 2, 2, rows, cols)
        and tuple(diag_inv.shape) == (2, 2, rows, cols)
        and all(t.dtype == r.dtype for t in (stencil, diag_inv, *(t for t, _ in shapes)))
        and all(want is not None and tuple(t.shape) == want for t, want in shapes)
    )
    if not ok:
        raise cuda_lib.KernelError(
            f"{name}: stencil {tuple(stencil.shape)} {stencil.dtype}, diag_inv "
            f"{tuple(diag_inv.shape)} {diag_inv.dtype}, "
            + ", ".join(f"{tuple(t.shape)} {t.dtype}" for t, _ in shapes)
            + f", wrap={bool(wrap_cols)}"
        )
    return rows, cols, rcc


def mg_presmooth(stencil, diag_inv, r, wrap_cols: bool):
    """(e [2, R, C], rc [2, Rc, Cc]) of one level's pre-smoothing phase."""
    if r.device.type == "cpu" and stencil.device.type == "cpu":
        return mg_presmooth_plain(stencil, diag_inv, r, wrap_cols)
    r = r.contiguous()
    cuda_lib.require_cuda("mg_presmooth", r.dtype, stencil, diag_inv, r)
    rows, cols, rcc = _check("mg_presmooth", stencil, diag_inv, r, (r,), wrap_cols, None)
    if rcc is None:
        raise cuda_lib.KernelError(
            f"mg_presmooth: a {rows}x{cols} grid (wrap={bool(wrap_cols)}) has no coarse grid"
        )
    e = torch.empty_like(r)
    rc = torch.empty((2, *rcc), dtype=r.dtype, device=r.device)
    cuda_lib.launch(
        "mg_presmooth", "mt_mg_presmooth", r,
        cuda_lib.DTYPE_CODES[r.dtype], int(bool(wrap_cols)), stencil.data_ptr(),
        diag_inv.data_ptr(), r.data_ptr(), e.data_ptr(), rc.data_ptr(), rows, cols,
    )
    mg_presmooth.launches += 1
    mg_presmooth.shape_launches[rows, cols, r.dtype] += 1
    return e, rc


def mg_postsmooth(stencil, diag_inv, r, e, ec, wrap_cols: bool):
    """One level's post-smoothing phase: smooth^2(e + prolong(ec))."""
    if r.device.type == "cpu" and stencil.device.type == "cpu":
        return mg_postsmooth_plain(stencil, diag_inv, r, e, ec, wrap_cols)
    r = r.contiguous()
    e = None if e is None else e.contiguous()
    ec = None if ec is None else ec.contiguous()
    cuda_lib.require_cuda("mg_postsmooth", r.dtype, stencil, diag_inv,
                          *(t for t in (r, e, ec) if t is not None))
    fields = (r,) if e is None else (r, e)
    rows, cols, _ = _check("mg_postsmooth", stencil, diag_inv, r, fields, wrap_cols, ec)
    out = torch.empty_like(r)
    cuda_lib.launch(
        "mg_postsmooth", "mt_mg_postsmooth", r,
        cuda_lib.DTYPE_CODES[r.dtype], int(bool(wrap_cols)), stencil.data_ptr(),
        diag_inv.data_ptr(), r.data_ptr(), None if e is None else e.data_ptr(),
        None if ec is None else ec.data_ptr(), out.data_ptr(), rows, cols,
    )
    mg_postsmooth.launches += 1
    mg_postsmooth.shape_launches[rows, cols, r.dtype] += 1
    return out


mg_presmooth.launches = 0
mg_presmooth.shape_launches = Counter()
mg_postsmooth.launches = 0
mg_postsmooth.shape_launches = Counter()
