"""Single-vector block-ELL SpMV: the CUDA kernel `ell_matvec_kernel<T>`
(csrc/ell_matvec.cu) and its plain version.

    y[i, n] = sum_k sum_j data[k, i, j, n] * u[j, cols[k, n]]

for y [2, N] and u [2, N_u], N_u >= N: the level-0 operator of the ELL
solve mode (fem/solve.py::EllSystem, N_u = N), and a shard's rows against
the whole gathered field in the all-gather sharded path
(parallel/sharding.py, N_u the padded node count). data [K, 2, 2, N] and cols [K, N] int32 are the
assembly's [N, K, 2, 2] / [N, K] relaid out slot-major (`ell_to_slot_major`,
once per compiled problem); padding slots point at the row's own node and
hold zero blocks. The JAX package computes this function as
fem/operator.py's `ell_matvec` on [N, 2] fields and leaves it to XLA; there
is no `pallas_call` behind it.

`ell_matvec_t` is the entry point: CPU operands take the plain version,
CUDA operands launch the kernel or raise.

One launch plan at every shape: one thread a row in 704-thread blocks, the
sum over the slots in the plain version's order, so a call repeats bit for
bit. Splitting a row over 2 or 4 threads was slower at the 1M plate's ELL
mode and at the all-gather shard on the H100 (scripts/ell_coarse_variants.py
as of commit b558abc; PERF.md §6).
"""

from __future__ import annotations

import torch

from . import cuda_lib


def ell_to_slot_major(ell: torch.Tensor, cols: torch.Tensor) -> tuple:
    """(data [K, 2, 2, N], cols [K, N] int32) from the node-major
    ell [N, K, 2, 2] / cols [N, K], on their device."""
    return (
        ell.permute(1, 2, 3, 0).contiguous(),
        cols.to(torch.int32).T.contiguous(),
    )


def ell_diag_blocks(data: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The diagonal 2x2 block of each node, [2, 2, N], from slot-major
    data / cols: the slot whose column is the node itself (padding slots
    also point there but hold zeros, so the sum is exact)."""
    own = cols == torch.arange(cols.shape[1], device=cols.device, dtype=cols.dtype)
    return (own.to(data.dtype)[:, None, None, :] * data).sum(dim=0)


def ell_matvec_t_plain(data: torch.Tensor, cols: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain version: a loop over the K slots, y += data[k] . u[:, cols[k]],
    so no [2, K, N] gather is ever held; the kernel's summation order."""
    y0 = u.new_zeros(cols.shape[1])
    y1 = u.new_zeros(cols.shape[1])
    for k in range(cols.shape[0]):
        g = u[:, cols[k].long()]  # [2, N]
        b = data[k]
        y0 = y0 + b[0, 0] * g[0] + b[0, 1] * g[1]
        y1 = y1 + b[1, 0] * g[0] + b[1, 1] * g[1]
    return torch.stack([y0, y1])


def ell_matvec_t(data: torch.Tensor, cols: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """y = K u for slot-major data [K, 2, 2, N] / cols [K, N] int32 (each
    in [0, N_u)) and a field u [2, N_u] with N_u >= N, f32 or f64, any
    K >= 1; y is [2, N]."""
    if u.device.type == "cpu" and data.device.type == "cpu":
        return ell_matvec_t_plain(data, cols, u)
    u = u.contiguous()
    cuda_lib.require_cuda("ell_matvec_t", u.dtype, data, cols, u)
    k, n = cols.shape if cols.dim() == 2 else (-1, -1)
    n_u = u.shape[1] if u.dim() == 2 else -1
    if (
        cols.dtype != torch.int32 or data.dtype != u.dtype or k < 1
        or tuple(data.shape) != (k, 2, 2, n) or u.shape[0] != 2 or n_u < n
    ):
        raise cuda_lib.KernelError(
            f"ell_matvec_t: data {tuple(data.shape)} {data.dtype}, cols "
            f"{tuple(cols.shape)} {cols.dtype}, u {tuple(u.shape)} {u.dtype}"
        )
    y = torch.empty((2, n), dtype=u.dtype, device=u.device)
    cuda_lib.launch(
        "ell_matvec_t", "mt_ell_matvec", u,
        cuda_lib.DTYPE_CODES[u.dtype], data.data_ptr(), cols.data_ptr(), u.data_ptr(),
        y.data_ptr(), n, n_u, k,
    )
    return y
