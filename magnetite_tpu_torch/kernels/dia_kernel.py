"""Banded block SpMV: CUDA kernel `dia_matvec<T, M>` and its plain version.

    y[i, n] = sum_d sum_j bands[d, i, j, n] * u[j, n + offsets[d]]

Replaces magnetite_tpu/pallas/dia_kernel.py::_kernel (see
csrc/dia_matvec.cu for what bounds it on Hopper and how the design answers
that: one thread per node for the level-0 2x2 blocks, a block of warps
splitting the offsets of 32 nodes for the coarse levels' 3x3 blocks).
`dia_matvec` is the one entry point: a CPU operand takes the plain PyTorch
version, a CUDA operand launches the kernel or raises. It counts its
launches in `.launches` and, per (m, N, dtype), in `.shape_launches`.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from . import cuda_lib


def dia_matvec_blocks(bands: torch.Tensor, offsets, u: torch.Tensor):
    """Plain version: y = K u for m x m blocks, bands [D, m, m, N],
    u/y [m, N] (the port of magnetite_tpu/fem/dia.py::dia_matvec_blocks).

    Rolls wrap, but every band is zero wherever its shifted index would be
    invalid, so the wraparound contributes exactly 0."""
    m = u.shape[0]
    ys = [torch.zeros_like(u[0]) for _ in range(m)]
    for d_idx, off in enumerate(offsets):
        shifted = torch.roll(u, -int(off), dims=1) if off != 0 else u
        b = bands[d_idx]
        for i in range(m):
            acc = ys[i]
            for j in range(m):
                acc = acc + b[i, j] * shifted[j]
            ys[i] = acc
    return torch.stack(ys)


def dia_matvec(
    bands: torch.Tensor,
    offsets,
    u: torch.Tensor,
    offsets_dev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = K u. `offsets`: the band offsets as Python ints; `offsets_dev`:
    the same as an int32 tensor on the card (made here when not given)."""
    if u.device.type == "cpu" and bands.device.type == "cpu":
        return dia_matvec_blocks(bands, offsets, u)
    u = u.contiguous()
    if offsets_dev is None:
        offsets_dev = torch.tensor(
            [int(o) for o in offsets], dtype=torch.int32, device=u.device
        )
    cuda_lib.require_cuda("dia_matvec", u.dtype, bands, u, offsets_dev)
    d, m, m2, n = bands.shape
    if (
        m != m2 or m not in (2, 3) or tuple(u.shape) != (m, n)
        or bands.dtype != u.dtype or offsets_dev.dtype != torch.int32
        or offsets_dev.numel() != d
    ):
        raise cuda_lib.KernelError(
            f"dia_matvec: bands {tuple(bands.shape)} {bands.dtype}, u "
            f"{tuple(u.shape)} {u.dtype}, {offsets_dev.numel()} offsets"
        )
    y = torch.empty_like(u)
    cuda_lib.launch(
        "dia_matvec", "mt_dia_matvec", u,
        cuda_lib.DTYPE_CODES[u.dtype], m, bands.data_ptr(),
        offsets_dev.data_ptr(), d, u.data_ptr(), y.data_ptr(), n,
    )
    dia_matvec.launches += 1
    dia_matvec.shape_launches[m, n, u.dtype] += 1
    return y


dia_matvec.launches = 0
dia_matvec.shape_launches = Counter()
