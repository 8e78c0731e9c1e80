"""Level-0 AMG transfers: CUDA kernels `prolong0<T>` / `restrict0<T>` and
their plain versions (the gather forms of magnetite_tpu/fem/amg.py:1286-1307).

    prolong0:  ec [n1, 3] -> u0 [2, n0],  u0[:, n] = p0[n] @ ec[agg[n]]
    restrict0: tmp [2, n0] -> rc [n1, 3], rc[a] = sum_k pt0_vals[a, k] @ tmp[:, pt0_cols[a, k]]

Replace magnetite_tpu/pallas/transfer_kernel.py::_prolong_kernel and
::_restrict_kernel (see csrc/transfer.cu for what bounds them on Hopper).
Restrict is the exact adjoint of prolong: pt0_vals holds p0's blocks
transposed, listed per aggregate (AMGSetup.fast0). A CPU operand takes the
plain version, a CUDA operand launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def prolong0_plain(ec, agg, p0):
    """u0 [2, n0] = per-node P0 blocks [n0, 2, 3] times ec[agg] [n0, 3]."""
    return (p0 * ec[agg][:, None, :]).sum(-1).T.contiguous()


def restrict0_plain(tmp, pt0_cols, pt0_vals):
    """rc [n1, 3] = sum over each aggregate's members of P0_i^T tmp[:, i]."""
    g = tmp[:, pt0_cols].permute(1, 2, 0)  # [n1, w0, 2]
    return (pt0_vals * g[:, :, None, :]).sum(dim=(1, 3))


def prolong0(ec, agg, p0):
    if ec.device.type == "cpu" and p0.device.type == "cpu":
        return prolong0_plain(ec, agg, p0)
    ec = ec.contiguous()
    cuda_lib.require_cuda("prolong0", ec.dtype, ec, agg, p0)
    n0 = agg.shape[0]
    if (
        ec.dim() != 2 or ec.shape[1] != 3 or tuple(p0.shape) != (n0, 2, 3)
        or p0.dtype != ec.dtype or agg.dtype != torch.int32
    ):
        raise cuda_lib.KernelError(
            f"prolong0: ec {tuple(ec.shape)} {ec.dtype}, agg "
            f"{tuple(agg.shape)} {agg.dtype}, p0 {tuple(p0.shape)} {p0.dtype}"
        )
    u0 = torch.empty((2, n0), dtype=ec.dtype, device=ec.device)
    cuda_lib.launch(
        "prolong0", "mt_prolong0", ec,
        cuda_lib.DTYPE_CODES[ec.dtype], ec.data_ptr(), agg.data_ptr(),
        p0.data_ptr(), u0.data_ptr(), n0,
    )
    prolong0.launches += 1
    return u0


def restrict0(tmp, pt0_cols, pt0_vals):
    if tmp.device.type == "cpu" and pt0_vals.device.type == "cpu":
        return restrict0_plain(tmp, pt0_cols, pt0_vals)
    tmp = tmp.contiguous()
    cuda_lib.require_cuda("restrict0", tmp.dtype, tmp, pt0_cols, pt0_vals)
    n1, w0 = pt0_cols.shape
    if (
        tmp.dim() != 2 or tmp.shape[0] != 2
        or tuple(pt0_vals.shape) != (n1, w0, 3, 2)
        or pt0_vals.dtype != tmp.dtype or pt0_cols.dtype != torch.int32
    ):
        raise cuda_lib.KernelError(
            f"restrict0: tmp {tuple(tmp.shape)} {tmp.dtype}, pt0_cols "
            f"{tuple(pt0_cols.shape)} {pt0_cols.dtype}, pt0_vals "
            f"{tuple(pt0_vals.shape)} {pt0_vals.dtype}"
        )
    rc_out = torch.empty((n1, 3), dtype=tmp.dtype, device=tmp.device)
    cuda_lib.launch(
        "restrict0", "mt_restrict0", tmp,
        cuda_lib.DTYPE_CODES[tmp.dtype], tmp.data_ptr(), pt0_cols.data_ptr(),
        pt0_vals.data_ptr(), rc_out.data_ptr(), tmp.shape[1], n1, w0,
    )
    restrict0.launches += 1
    return rc_out


prolong0.launches = 0
restrict0.launches = 0
