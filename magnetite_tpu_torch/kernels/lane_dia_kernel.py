"""Lane-batched band SpMV: CUDA kernels `lane_dia_matvec<T>` (K7) and
`lane_dia_matvec3<T>` (K8) and their plain versions.

    K7  y[ci, n, b] = sum_d sum_cj bands[d, ci, cj, n] * u[cj, n + offsets[d], b]
    K8  y_b = (wa_b Ka + wb_b Kb + wc_b Kc) u_b

on [2, N, B] lane fields of design sweeps, the band coefficients shared by
every lane (K8: three basis band sets and per-lane weights [B]). Replace
magnetite_tpu/pallas/lane_dia_kernel.py::_kernel and ::_kernel3 (see
csrc/lane_dia_matvec.cu for what bounds them on Hopper and how the design
answers that). `lane_dia_matvec` / `lane_dia_matvec3` are the entry
points: a CPU operand takes the plain PyTorch version (the JAX package's
roll formulation), a CUDA operand launches the kernel or raises. Both take
f32 and f64, any B >= 1 and any offsets.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib


def lane_dia_matvec_plain(bands: torch.Tensor, offsets, u: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 (magnetite_tpu/parallel/sweep.py's
    band_matvec_roll): bands [D, 2, 2, N], u [2, N, B] -> K u [2, N, B].

    Rolls wrap, but every band is zero wherever its shifted index would be
    invalid, so the wraparound contributes exactly 0."""
    y0 = torch.zeros_like(u[0])
    y1 = torch.zeros_like(u[1])
    for d_idx, off in enumerate(offsets):
        shifted = torch.roll(u, -int(off), dims=1) if off != 0 else u
        b = bands[d_idx][:, :, :, None]  # [2, 2, N, 1] broadcast over lanes
        y0 = y0 + b[0, 0] * shifted[0] + b[0, 1] * shifted[1]
        y1 = y1 + b[1, 0] * shifted[0] + b[1, 1] * shifted[1]
    return torch.stack([y0, y1])


def lane_dia_matvec3_plain(bands3, w3, offsets, u: torch.Tensor) -> torch.Tensor:
    """Plain version of K8 (magnetite_tpu/parallel/sweep.py::
    _lane_weighted_band_matvec): six per-basis accumulators over one roll
    per offset, combined with the per-lane weights (wa, wb, wc) at the end."""
    acc = [torch.zeros_like(u[0]) for _ in range(6)]
    for d_idx, off in enumerate(offsets):
        s = torch.roll(u, -int(off), dims=1) if off != 0 else u
        for k, bk in enumerate(bands3):
            blk = bk[d_idx][:, :, :, None]  # [2, 2, N, 1]
            acc[2 * k] = acc[2 * k] + blk[0, 0] * s[0] + blk[0, 1] * s[1]
            acc[2 * k + 1] = acc[2 * k + 1] + blk[1, 0] * s[0] + blk[1, 1] * s[1]
    wa, wb, wc = w3
    y0 = acc[0] * wa + acc[2] * wb + acc[4] * wc
    y1 = acc[1] * wa + acc[3] * wb + acc[5] * wc
    return torch.stack([y0, y1])


def offsets_tensor(offsets, device) -> torch.Tensor:
    """The band offsets as the int32 tensor the kernels read (callers that
    launch repeatedly make it once; the plain versions take Python ints)."""
    return torch.tensor([int(o) for o in offsets], dtype=torch.int32, device=device)


def _check_shapes(name, bands_list, u, offsets_dev, ws=()):
    d, n = bands_list[0].shape[0], u.shape[1] if u.dim() == 3 else -1
    bad = (
        u.dim() != 3 or u.shape[0] != 2
        or offsets_dev.dtype != torch.int32 or offsets_dev.numel() != d
        or any(tuple(b.shape) != (d, 2, 2, n) or b.dtype != u.dtype for b in bands_list)
        or any(tuple(w.shape) != (u.shape[2],) or w.dtype != u.dtype for w in ws)
    )
    if bad:
        raise cuda_lib.KernelError(
            f"{name}: bands {[tuple(b.shape) for b in bands_list]} "
            f"{bands_list[0].dtype}, u {tuple(u.shape)} {u.dtype}, weights "
            f"{[tuple(w.shape) for w in ws]}, {offsets_dev.numel()} offsets"
        )


def lane_dia_matvec(
    bands: torch.Tensor,
    offsets,
    u: torch.Tensor,
    offsets_dev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7: y = K u on [2, N, B] lane fields. `offsets`: the band offsets as
    Python ints; `offsets_dev`: the same as an int32 tensor on the card
    (made here when not given)."""
    if u.device.type == "cpu" and bands.device.type == "cpu":
        return lane_dia_matvec_plain(bands, offsets, u)
    u = u.contiguous()
    if offsets_dev is None:
        offsets_dev = offsets_tensor(offsets, u.device)
    cuda_lib.require_cuda("lane_dia_matvec", u.dtype, bands, u, offsets_dev)
    _check_shapes("lane_dia_matvec", [bands], u, offsets_dev)
    _, n, nb = u.shape
    y = torch.empty_like(u)
    lib = cuda_lib.load()
    rc = lib.mt_lane_dia_matvec(
        cuda_lib.DTYPE_CODES[u.dtype], bands.data_ptr(), offsets_dev.data_ptr(),
        bands.shape[0], u.data_ptr(), y.data_ptr(), n, nb, cuda_lib.stream_of(u),
    )
    cuda_lib.check(lib, rc, "lane_dia_matvec")
    lane_dia_matvec.launches += 1
    lane_dia_matvec.f64_launches += int(u.dtype == torch.float64)
    return y


def lane_dia_matvec3(
    bands3,
    w3,
    offsets,
    u: torch.Tensor,
    offsets_dev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K8: y_b = (wa_b Ka + wb_b Kb + wc_b Kc) u_b. bands3: three
    [D, 2, 2, N] basis band sets; w3: (wa, wb, wc), each [B]."""
    if u.device.type == "cpu" and bands3[0].device.type == "cpu":
        return lane_dia_matvec3_plain(bands3, w3, offsets, u)
    u = u.contiguous()
    w3 = [w.contiguous() for w in w3]
    if offsets_dev is None:
        offsets_dev = offsets_tensor(offsets, u.device)
    cuda_lib.require_cuda("lane_dia_matvec3", u.dtype, *bands3, *w3, u, offsets_dev)
    _check_shapes("lane_dia_matvec3", list(bands3), u, offsets_dev, w3)
    _, n, nb = u.shape
    y = torch.empty_like(u)
    lib = cuda_lib.load()
    rc = lib.mt_lane_dia_matvec3(
        cuda_lib.DTYPE_CODES[u.dtype], *(b.data_ptr() for b in bands3),
        *(w.data_ptr() for w in w3), offsets_dev.data_ptr(), bands3[0].shape[0],
        u.data_ptr(), y.data_ptr(), n, nb, cuda_lib.stream_of(u),
    )
    cuda_lib.check(lib, rc, "lane_dia_matvec3")
    lane_dia_matvec3.launches += 1
    lane_dia_matvec3.f64_launches += int(u.dtype == torch.float64)
    return y


# launches, and of those the f64 instance's (the refined sweeps run both)
lane_dia_matvec.launches = lane_dia_matvec.f64_launches = 0
lane_dia_matvec3.launches = lane_dia_matvec3.f64_launches = 0
