"""9-point 2x2-block stencil SpMV: CUDA kernel `stencil_matvec<T, WRAP>` and
its plain version.

    y[i, r, c] = sum_{dr,dt in -1..1} sum_j S[(dr+1)*3+dt+1, i, j, r, c] * u[j, r+dr, c+dt]

Rows outside the grid contribute 0; columns wrap when `wrap` is set
(annulus meshes) and contribute 0 outside the grid otherwise. Replaces both
magnetite_tpu/pallas/stencil_kernel.py::_kernel and ::_kernel_blocked (see
csrc/stencil_matvec.cu for what bounds it on Hopper). `stencil_matvec` is
the one entry point: a CPU operand takes the plain PyTorch version, a CUDA
operand launches the kernel or raises. It counts its launches in
`.launches` and, per (rows, cols, dtype), in `.shape_launches`.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import cuda_lib

# stencil offset enumeration, index = (dr+1)*3 + (dt+1)
OFFSETS = [(dr, dt) for dr in (-1, 0, 1) for dt in (-1, 0, 1)]


def shift2d(u: torch.Tensor, dr: int, dt: int, wrap_cols: bool) -> torch.Tensor:
    """u [..., R, C] -> value at (r+dr, c+dt); zero-padded rows, wrapped or
    zero-padded cols."""
    out = u
    if dr:
        out = torch.roll(out, -dr, dims=-2)
        if dr > 0:
            out[..., -dr:, :] = 0.0
        else:
            out[..., :(-dr), :] = 0.0
    if dt:
        out = torch.roll(out, -dt, dims=-1)
        if not wrap_cols:
            if dt > 0:
                out[..., -dt:] = 0.0
            else:
                out[..., :(-dt)] = 0.0
    return out


def stencil_matvec_plain(
    stencil: torch.Tensor, u: torch.Tensor, wrap_cols: bool
) -> torch.Tensor:
    """Plain version: y = K u on grid fields u [..., 2, R, C] (the port of
    magnetite_tpu/fem/stencil.py::stencil_matvec_xla); leading batch dims
    of u are applied to the same stencil [9, 2, 2, R, C]."""
    y0 = torch.zeros_like(u[..., 0, :, :])
    y1 = torch.zeros_like(u[..., 1, :, :])
    for s, (dr, dt) in enumerate(OFFSETS):
        us = shift2d(u, dr, dt, wrap_cols)
        blk = stencil[s]
        # explicit 2x2 block multiply-adds, full precision in every dtype
        y0 = y0 + blk[0, 0] * us[..., 0, :, :] + blk[0, 1] * us[..., 1, :, :]
        y1 = y1 + blk[1, 0] * us[..., 0, :, :] + blk[1, 1] * us[..., 1, :, :]
    return torch.stack([y0, y1], dim=-3)


def stencil_matvec(
    stencil: torch.Tensor, u: torch.Tensor, wrap_cols: bool
) -> torch.Tensor:
    """y = K u for stencil [9, 2, 2, R, C] and u [2, R, C]."""
    if u.device.type == "cpu" and stencil.device.type == "cpu":
        return stencil_matvec_plain(stencil, u, wrap_cols)
    u = u.contiguous()
    cuda_lib.require_cuda("stencil_matvec", u.dtype, stencil, u)
    rows, cols = stencil.shape[-2], stencil.shape[-1]
    if (
        tuple(stencil.shape) != (9, 2, 2, rows, cols)
        or tuple(u.shape) != (2, rows, cols)
        or stencil.dtype != u.dtype
        or rows < 1 or cols < 2
    ):
        raise cuda_lib.KernelError(
            f"stencil_matvec: stencil {tuple(stencil.shape)} {stencil.dtype}, "
            f"u {tuple(u.shape)} {u.dtype}"
        )
    y = torch.empty_like(u)
    cuda_lib.launch(
        "stencil_matvec", "mt_stencil_matvec", u,
        cuda_lib.DTYPE_CODES[u.dtype], int(bool(wrap_cols)), stencil.data_ptr(),
        u.data_ptr(), y.data_ptr(), rows, cols,
    )
    stencil_matvec.launches += 1
    stencil_matvec.shape_launches[rows, cols, u.dtype] += 1
    return y


stencil_matvec.launches = 0
stencil_matvec.shape_launches = Counter()
