"""Double-float band SpMV: CUDA kernel `df_dia_matvec` and its plain version.

An f64-grade y = K u for 2x2 blocks from f32 hi/lo pairs of the bands and
of u (Veltkamp split, two-sum compensation). Replaces
magnetite_tpu/pallas/dia_kernel.py::_df_kernel; csrc/df_dia_matvec.cu says
what bounds it on Hopper and why it is written with non-contracting
intrinsics. The error is about 1.3e-14 of max sum |K||u|.

`df_dia_matvec` is the one entry point: a CPU operand takes the plain
PyTorch version, which repeats the kernel's f32 arithmetic op for op; a
CUDA operand launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

_VELTKAMP = 4097.0  # 2^(24 - 24//2) + 1: split an f32 into exact 12-bit halves


def df_split(x64: torch.Tensor):
    """f64 -> (hi, lo) f32 pair with hi + lo == x to ~2^-48 relative."""
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(x64.dtype)).to(torch.float32)
    return hi, lo


def split_bands(bands64: torch.Tensor) -> torch.Tensor:
    """f64 bands [D, 2, 2, N] -> hi/lo pairs [D, 2(hi, lo), 2, 2, N] f32,
    the layout both versions read (done once per compiled problem)."""
    hi, lo = df_split(bands64)
    return torch.stack([hi, lo], dim=1).contiguous()


def _veltkamp(x):
    t = _VELTKAMP * x
    x1 = t - (t - x)
    return x1, x - x1


def _two_sum_acc(s, c, p):
    """(s + p, c + rounding error of s + p): branch-free Knuth two-sum."""
    s2 = s + p
    z = s2 - s
    e = (s - (s2 - z)) + (p - z)
    return s2, c + e


def df_dia_matvec_plain(bands_hl: torch.Tensor, offsets, u64: torch.Tensor):
    """Plain version, the kernel's arithmetic in f32 torch ops: bands_hl
    [D, 2, 2, 2, N] f32, u64 [2, N] f64 -> y [2, N] f64.

    Rolls wrap, but every band is zero wherever its shifted index would be
    invalid, so the wraparound terms add exact zeros to both sums."""
    uh, ul = df_split(u64)
    u1, u2 = _veltkamp(uh)
    zero = torch.zeros_like(uh[0])
    s, c = [zero, zero], [zero, zero]
    for d_idx, off in enumerate(offsets):
        fields = [
            torch.roll(f, -int(off), dims=1) if off else f for f in (u1, u2, uh, ul)
        ]
        v1, v2, vh, vl = fields
        for i in range(2):
            s_i, c_i = s[i], c[i]
            for j in range(2):
                bh, bl = bands_hl[d_idx, 0, i, j], bands_hl[d_idx, 1, i, j]
                b1, b2 = _veltkamp(bh)
                s_i, c_i = _two_sum_acc(s_i, c_i, b1 * v1[j])
                s_i, c_i = _two_sum_acc(s_i, c_i, b1 * v2[j])
                s_i, c_i = _two_sum_acc(s_i, c_i, b2 * v1[j])
                c_i = c_i + b2 * v2[j] + bh * vl[j] + bl * vh[j]
            s[i], c[i] = s_i, c_i
    return torch.stack(s).to(u64.dtype) + torch.stack(c).to(u64.dtype)


def df_dia_matvec(
    bands_hl: torch.Tensor,
    offsets,
    u64: torch.Tensor,
    offsets_dev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = K u to ~2^-46 of the term scale. `offsets`: the band offsets as
    Python ints; `offsets_dev`: the same as an int32 tensor on the card
    (made here when not given)."""
    if u64.device.type == "cpu" and bands_hl.device.type == "cpu":
        return df_dia_matvec_plain(bands_hl, offsets, u64)
    u64 = u64.contiguous()
    if offsets_dev is None:
        offsets_dev = torch.tensor(
            [int(o) for o in offsets], dtype=torch.int32, device=u64.device
        )
    cuda_lib.require_cuda("df_dia_matvec", u64.dtype, bands_hl, u64, offsets_dev)
    d, n = bands_hl.shape[0], bands_hl.shape[-1]
    if (
        tuple(bands_hl.shape) != (d, 2, 2, 2, n)
        or bands_hl.dtype != torch.float32
        or u64.dtype != torch.float64 or tuple(u64.shape) != (2, n)
        or offsets_dev.dtype != torch.int32 or offsets_dev.numel() != d
    ):
        raise cuda_lib.KernelError(
            f"df_dia_matvec: bands_hl {tuple(bands_hl.shape)} {bands_hl.dtype}, "
            f"u {tuple(u64.shape)} {u64.dtype}, {offsets_dev.numel()} offsets"
        )
    y = torch.empty_like(u64)
    cuda_lib.launch(
        "df_dia_matvec", "mt_df_dia_matvec", u64,
        bands_hl.data_ptr(), offsets_dev.data_ptr(), d, u64.data_ptr(),
        y.data_ptr(), n,
    )
    return y
