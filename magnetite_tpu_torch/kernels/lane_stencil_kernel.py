"""Lane-batched 9-point 2x2-block stencil SpMV: the CUDA kernel
`lane_stencil_kernel<T, S>` (csrc/lane_stencil_matvec.cu) in two
instances, and their plain versions.

    S = 1  y[i, r, c, b] = sum_s sum_j S[s, i, j, r, c] * u[j, r+dr_s, c+dt_s, b]
    S = 3  the same sum with the block of offset s per lane b:
           wa_b Sa[s] + wb_b Sb[s] + wc_b Sc[s] + Sfix[s]

on [2, R, C, B] lane fields of the structured-grid design sweeps
(parallel/sweep.py: S = 1 for the load sweep's operator and multigrid
levels, S = 3 for the material sweep's basis levels). Rows outside the grid
read zero; columns wrap when `wrap` is set (annulus meshes) and read zero
outside the grid otherwise. The JAX package computes this function in plain
XLA (magnetite_tpu/parallel/sweep.py::_lane_stencil_matvec and
::_lane_material_matvec), where it fuses into one pass; there is no
`pallas_call` behind it. In eager PyTorch the plain version is ~40 (S = 1)
or ~150 (S = 3) launches per matvec, hence the kernel.

The kernel reads its stencils packed node-major (`pack_lane_stencils`,
once per compiled sweep): S = 1 [R, C, 9, 2, 2], S = 3 [R, C, 9, 2, 2, 4]
with (Sa, Sb, Sc, Sfix) innermost. The sweeps keep the JAX package's
layout ([9, 2, 2, R, C] per stencil) in their setup and the packed copy
beside it.

`lane_stencil_matvec` / `lane_stencil_matvec3` are the entry points: CPU
operands take the plain version (the stencils packed or not), CUDA operands
launch the kernel on packed stencils or raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .stencil_kernel import OFFSETS

# csrc geometry: a 16-byte chunk of lanes, two chunks a thread, eight
# threads a column, up to 16 columns a tile; strips of STRIP_ROWS rows, or
# of SHORT_STRIP_ROWS on grids of at most SHORT_GRID_ROWS rows
VEC_BYTES, MAX_TILE_COLS = 16, 16
STRIP_ROWS, SHORT_STRIP_ROWS, SHORT_GRID_ROWS = 6, 2, 12


class PackedStencils(NamedTuple):
    """Stencils packed for the kernel: [R, C, 9, 2, 2] (one stencil) or
    [R, C, 9, 2, 2, 4] ((Sa, Sb, Sc, Sfix) innermost)."""

    data: torch.Tensor

    @property
    def sets(self) -> int:
        return 3 if self.data.dim() == 6 else 1


def pack_lane_stencils(stencils) -> PackedStencils:
    """One stencil [9, 2, 2, R, C], or four (Sa, Sb, Sc, Sfix), packed
    node-major for the kernel (a contiguous copy, made once)."""
    if isinstance(stencils, torch.Tensor):
        return PackedStencils(stencils.permute(3, 4, 0, 1, 2).contiguous())
    st = torch.stack(tuple(stencils), dim=-1)  # [9, 2, 2, R, C, 4]
    return PackedStencils(st.permute(3, 4, 0, 1, 2, 5).contiguous())


def unpack_lane_stencils(packed: PackedStencils):
    """The JAX layout back, as views: a [9, 2, 2, R, C] stencil, or the
    four of S = 3."""
    data = packed.data
    if packed.sets == 1:
        return data.permute(2, 3, 4, 0, 1)
    return tuple(data[..., k].permute(2, 3, 4, 0, 1) for k in range(4))


def _jax_layout(stencils):
    return unpack_lane_stencils(stencils) if isinstance(stencils, PackedStencils) else stencils


def _pad_lanes(u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """One padded copy of u [2, R, C, B]: zero rows above and below, the
    columns wrapped (or zero) left and right."""
    if wrap:
        u = torch.cat([u[..., -1:, :], u, u[..., :1, :]], dim=-2)
        return F.pad(u, (0, 0, 0, 0, 1, 1))
    return F.pad(u, (0, 0, 1, 1, 1, 1))


def lane_stencil_matvec_plain(stencil, u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Plain version (the JAX package's _lane_stencil_matvec): stencil
    [9, 2, 2, R, C] or packed, u [2, R, C, B] -> K u [2, R, C, B]; one
    padded copy of u, then the nine offsets as static slices."""
    stencil = _jax_layout(stencil)
    rows, cols = u.shape[-3], u.shape[-2]
    u_pad = _pad_lanes(u, wrap)
    y0 = torch.zeros_like(u[0])
    y1 = torch.zeros_like(u[1])
    for s, (dr, dt) in enumerate(OFFSETS):
        us = u_pad[:, 1 + dr : 1 + dr + rows, 1 + dt : 1 + dt + cols, :]
        blk = stencil[s][..., None]  # [2, 2, R, C, 1] broadcast over lanes
        y0 = y0 + blk[0, 0] * us[0] + blk[0, 1] * us[1]
        y1 = y1 + blk[1, 0] * us[0] + blk[1, 1] * us[1]
    return torch.stack([y0, y1])


def lane_material_matvec_plain(stencils4, w3, u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Plain version of S = 3 (the JAX package's _lane_material_matvec):
    stencils4 = (Sa, Sb, Sc, Sfix), each [9, 2, 2, R, C], or packed; w3 =
    (wa, wb, wc), each [B]. The basis blocks are combined per offset with
    the lane weights; no per-lane stencil is kept."""
    rows, cols = u.shape[-3], u.shape[-2]
    u_pad = _pad_lanes(u, wrap)
    sa, sb, sc, sfix = _jax_layout(stencils4)
    wa, wb, wc = w3
    y0 = torch.zeros_like(u[0])
    y1 = torch.zeros_like(u[1])
    for s, (dr, dt) in enumerate(OFFSETS):
        us = u_pad[:, 1 + dr : 1 + dr + rows, 1 + dt : 1 + dt + cols, :]

        def coef(i, j):
            return (sa[s, i, j][..., None] * wa + sb[s, i, j][..., None] * wb
                    + sc[s, i, j][..., None] * wc + sfix[s, i, j][..., None])

        y0 = y0 + coef(0, 0) * us[0] + coef(0, 1) * us[1]
        y1 = y1 + coef(1, 0) * us[0] + coef(1, 1) * us[1]
    return torch.stack([y0, y1])


class LaneStencilPlan(NamedTuple):
    vec: bool  # 16-byte chunks of lanes (else one lane at a time)
    tile_cols: int
    strip_rows: int


def lane_stencil_plan(rows: int, cols: int, nb: int, es: int, aligned: bool) -> LaneStencilPlan:
    """The launch geometry: 16-byte chunks when B is a multiple of the chunk
    and the lane fields are 16-byte aligned; the columns cut into the
    fewest tiles of at most MAX_TILE_COLS, evened out (65: 5 tiles of 13);
    strips of STRIP_ROWS rows (SHORT_STRIP_ROWS on short grids). Small
    blocks, many of them: several fit on an SM and the grid runs many
    waves, so its last wave is short; each strip re-reads two halo rows,
    mostly from L2 (measured on the H100 against other tile widths and
    strips: PERF.md §6, PR 11)."""
    vec = aligned and nb % (VEC_BYTES // es) == 0
    tiles = -(-cols // MAX_TILE_COLS)
    strip = SHORT_STRIP_ROWS if rows <= SHORT_GRID_ROWS else STRIP_ROWS
    return LaneStencilPlan(vec, -(-cols // tiles), min(rows, strip))


def _require_packed(name: str, stencils, sets: int) -> torch.Tensor:
    if not isinstance(stencils, PackedStencils) or stencils.sets != sets:
        raise cuda_lib.KernelError(
            f"{name}: CUDA operands take stencils packed by pack_lane_stencils "
            f"({'[R, C, 9, 2, 2, 4]' if sets == 3 else '[R, C, 9, 2, 2]'})")
    return stencils.data


def _check(name, packed, u, ws=()):
    cuda_lib.require_cuda(name, u.dtype, packed, *ws, u)
    rows, cols = packed.shape[0], packed.shape[1]
    want = (rows, cols, 9, 2, 2) + ((4,) if packed.dim() == 6 else ())
    bad = (
        u.dim() != 4 or tuple(u.shape[:3]) != (2, rows, cols) or rows < 1 or cols < 2
        or tuple(packed.shape) != want or packed.dtype != u.dtype
        or any(tuple(w.shape) != (u.shape[3],) or w.dtype != u.dtype for w in ws)
    )
    if bad:
        raise cuda_lib.KernelError(
            f"{name}: packed stencils {tuple(packed.shape)} {packed.dtype}, u {tuple(u.shape)} "
            f"{u.dtype}, weights {[tuple(w.shape) for w in ws]}"
        )
    if packed.data_ptr() % VEC_BYTES:
        raise cuda_lib.KernelError(f"{name}: packed stencils must be 16-byte aligned")
    return rows, cols, u.shape[3]


def _plan_of(u, y, ws, rows, cols, nb):
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (u, y, *ws))
    return lane_stencil_plan(rows, cols, nb, u.element_size(), aligned)


def _on_cpu(stencils, u) -> bool:
    """u and the stencils (a tensor, a tuple of them, or packed) on the CPU."""
    first = stencils if isinstance(stencils, torch.Tensor) else stencils[0]
    return u.device.type == "cpu" and first.device.type == "cpu"


def lane_stencil_matvec(stencil, u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """S = 1: y = K u for a stencil [9, 2, 2, R, C] (CPU) or packed (CPU or
    CUDA) and lane fields u [2, R, C, B], f32 or f64, any B >= 1."""
    if _on_cpu(stencil, u):
        return lane_stencil_matvec_plain(stencil, u, wrap)
    packed = _require_packed("lane_stencil_matvec", stencil, 1)
    u = u.contiguous()
    rows, cols, nb = _check("lane_stencil_matvec", packed, u)
    y = torch.empty_like(u)
    plan = _plan_of(u, y, (), rows, cols, nb)
    cuda_lib.launch(
        "lane_stencil_matvec", "mt_lane_stencil_matvec", u,
        cuda_lib.DTYPE_CODES[u.dtype], int(bool(wrap)), int(plan.vec), packed.data_ptr(),
        u.data_ptr(), y.data_ptr(), rows, cols, nb, plan.tile_cols, plan.strip_rows,
    )
    return y


def lane_stencil_matvec3(stencils4, w3, u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """S = 3: y_b = (wa_b Sa + wb_b Sb + wc_b Sc + Sfix) u_b. stencils4 =
    (Sa, Sb, Sc, Sfix), each [9, 2, 2, R, C] (CPU), or packed (CPU or
    CUDA); w3 = (wa, wb, wc), each [B]."""
    if _on_cpu(stencils4, u):
        return lane_material_matvec_plain(stencils4, w3, u, wrap)
    packed = _require_packed("lane_stencil_matvec3", stencils4, 3)
    u = u.contiguous()
    w3 = [w.contiguous() for w in w3]
    rows, cols, nb = _check("lane_stencil_matvec3", packed, u, w3)
    y = torch.empty_like(u)
    plan = _plan_of(u, y, w3, rows, cols, nb)
    cuda_lib.launch(
        "lane_stencil_matvec3", "mt_lane_stencil_matvec3", u,
        cuda_lib.DTYPE_CODES[u.dtype], int(bool(wrap)), int(plan.vec), packed.data_ptr(),
        *(w.data_ptr() for w in w3), u.data_ptr(), y.data_ptr(), rows, cols, nb,
        plan.tile_cols, plan.strip_rows,
    )
    return y
