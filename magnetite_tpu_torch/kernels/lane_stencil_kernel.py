"""Lane-batched 9-point 2x2-block stencil SpMV: the CUDA kernel
`lane_stencil_kernel<T, S, V>` (csrc/lane_stencil_matvec.cu) in two
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

`lane_stencil_matvec` / `lane_stencil_matvec3` are the entry points: CPU
operands take the plain version, CUDA operands launch the kernel or raise.
Each counts its launches in `.launches` and, per (rows, cols, dtype), in
`.shape_launches`.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from . import cuda_lib
from .stencil_kernel import OFFSETS

# a thread carries VEC_BYTES of consecutive lanes when B allows it; the
# grid aims at WAVE_THREADS resident threads per SM (csrc: one thread per
# (lane vector, column, strip of rows))
VEC_BYTES, WAVE_THREADS = 16, 2048
H100_SMS = 132


def _pad_lanes(u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """One padded copy of u [2, R, C, B]: zero rows above and below, the
    columns wrapped (or zero) left and right."""
    if wrap:
        u = torch.cat([u[..., -1:, :], u, u[..., :1, :]], dim=-2)
        return F.pad(u, (0, 0, 0, 0, 1, 1))
    return F.pad(u, (0, 0, 1, 1, 1, 1))


def lane_stencil_matvec_plain(stencil: torch.Tensor, u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Plain version (the JAX package's _lane_stencil_matvec): stencil
    [9, 2, 2, R, C], u [2, R, C, B] -> K u [2, R, C, B]; one padded copy of
    u, then the nine offsets as static slices."""
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
    stencils4 = (Sa, Sb, Sc, Sfix), each [9, 2, 2, R, C]; w3 = (wa, wb, wc),
    each [B]. The basis blocks are combined per offset with the lane
    weights; no per-lane stencil is kept."""
    rows, cols = u.shape[-3], u.shape[-2]
    u_pad = _pad_lanes(u, wrap)
    sa, sb, sc, sfix = stencils4
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


def lane_stencil_plan(rows: int, cols: int, nb: int, es: int, aligned: bool,
                      sms: int = H100_SMS) -> tuple:
    """(lanes per thread, rows per strip) of one launch: 16 bytes of lanes
    per thread when B is a multiple of that and the lane fields are 16-byte
    aligned (else one lane), and the fewest strips of rows that give
    WAVE_THREADS threads per SM (a thread walks its strip down the rows,
    so each strip re-reads two halo rows)."""
    vec = VEC_BYTES // es if aligned and nb % (VEC_BYTES // es) == 0 else 1
    per_strip = -(-nb // vec) * cols
    strips = min(rows, max(1, -(-(sms * WAVE_THREADS) // per_strip)))
    return vec, -(-rows // strips)


def _check(name, stencils, u, ws=()):
    cuda_lib.require_cuda(name, u.dtype, *stencils, *ws, u)
    rows, cols = stencils[0].shape[-2], stencils[0].shape[-1]
    bad = (
        u.dim() != 4 or tuple(u.shape[:3]) != (2, rows, cols) or rows < 1 or cols < 2
        or any(tuple(s.shape) != (9, 2, 2, rows, cols) or s.dtype != u.dtype for s in stencils)
        or any(tuple(w.shape) != (u.shape[3],) or w.dtype != u.dtype for w in ws)
    )
    if bad:
        raise cuda_lib.KernelError(
            f"{name}: stencils {[tuple(s.shape) for s in stencils]} {stencils[0].dtype}, "
            f"u {tuple(u.shape)} {u.dtype}, weights {[tuple(w.shape) for w in ws]}"
        )
    return rows, cols, u.shape[3]


def _plan_of(u, y, ws, rows, cols, nb):
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (u, y, *ws))
    return lane_stencil_plan(rows, cols, nb, u.element_size(), aligned,
                             cuda_lib.sm_count(u.device))


def lane_stencil_matvec(stencil: torch.Tensor, u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """S = 1: y = K u for stencil [9, 2, 2, R, C] and lane fields u
    [2, R, C, B], f32 or f64, any B >= 1."""
    if u.device.type == "cpu" and stencil.device.type == "cpu":
        return lane_stencil_matvec_plain(stencil, u, wrap)
    u = u.contiguous()
    rows, cols, nb = _check("lane_stencil_matvec", (stencil,), u)
    y = torch.empty_like(u)
    vec, strip_rows = _plan_of(u, y, (), rows, cols, nb)
    lib = cuda_lib.load()
    rc = lib.mt_lane_stencil_matvec(
        cuda_lib.DTYPE_CODES[u.dtype], int(bool(wrap)), vec, stencil.data_ptr(), u.data_ptr(),
        y.data_ptr(), rows, cols, nb, strip_rows, cuda_lib.stream_of(u),
    )
    cuda_lib.check(lib, rc, "lane_stencil_matvec")
    lane_stencil_matvec.launches += 1
    lane_stencil_matvec.shape_launches[rows, cols, u.dtype] += 1
    return y


def lane_stencil_matvec3(stencils4, w3, u: torch.Tensor, wrap: bool) -> torch.Tensor:
    """S = 3: y_b = (wa_b Sa + wb_b Sb + wc_b Sc + Sfix) u_b. stencils4 =
    (Sa, Sb, Sc, Sfix), each [9, 2, 2, R, C]; w3 = (wa, wb, wc), each [B]."""
    if u.device.type == "cpu" and stencils4[0].device.type == "cpu":
        return lane_material_matvec_plain(stencils4, w3, u, wrap)
    u = u.contiguous()
    w3 = [w.contiguous() for w in w3]
    rows, cols, nb = _check("lane_stencil_matvec3", stencils4, u, w3)
    y = torch.empty_like(u)
    vec, strip_rows = _plan_of(u, y, w3, rows, cols, nb)
    lib = cuda_lib.load()
    rc = lib.mt_lane_stencil_matvec3(
        cuda_lib.DTYPE_CODES[u.dtype], int(bool(wrap)), vec,
        *(s.data_ptr() for s in stencils4), *(w.data_ptr() for w in w3),
        u.data_ptr(), y.data_ptr(), rows, cols, nb, strip_rows, cuda_lib.stream_of(u),
    )
    cuda_lib.check(lib, rc, "lane_stencil_matvec3")
    lane_stencil_matvec3.launches += 1
    lane_stencil_matvec3.shape_launches[rows, cols, u.dtype] += 1
    return y


lane_stencil_matvec.launches = 0
lane_stencil_matvec.shape_launches = Counter()
lane_stencil_matvec3.launches = 0
lane_stencil_matvec3.shape_launches = Counter()
