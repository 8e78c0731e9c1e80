"""Matrix-vector products for the global stiffness operator (port of
magnetite_tpu/fem/operator.py).

All operators act on displacement fields shaped [N, 2] (node-major), the
layout of the block-ELL data; the lane-batched sweeps pass [2, N, B] lane
fields with a [2, N, 1] mask through the same masking helpers.

Boundary conditions are imposed by masking, not by row/column partitioning:
the masked operator

    A(v) = free * K(free * v) + (1 - free) * v

is the reduced system padded back to full size with an identity on the
constrained DOFs: symmetric positive definite, with a static shape.

Every product is written out as multiply-adds, so no TF32 path can reach
it.
"""

from __future__ import annotations

from typing import Callable

import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]


def ell_matvec(ell_data: torch.Tensor, cols: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Block-ELL SpMV: y[n, i] = sum_k sum_j data[n, k, i, j] * u[cols[n, k], j].

    ell_data [N, K, 2, 2], cols [N, K], u [N, 2] -> [N, 2]: one gather
    ([N, K, 2]) and one contraction."""
    gathered = u[cols.long()]  # [N, K, 2]
    return (ell_data * gathered[:, :, None, :]).sum(dim=(1, 3))


def make_ell_operator(ell_data: torch.Tensor, cols: torch.Tensor) -> MatVec:
    def op(u: torch.Tensor) -> torch.Tensor:
        return ell_matvec(ell_data, cols, u)

    return op


def make_constrained_operator(matvec: MatVec, free_mask: torch.Tensor) -> MatVec:
    """Wrap K into the BC-reduced SPD operator (identity on fixed DOFs)."""

    def op(v: torch.Tensor) -> torch.Tensor:
        kv = matvec(free_mask * v)
        return free_mask * kv + (1.0 - free_mask) * v

    return op


def reduced_rhs(
    matvec: MatVec,
    free_mask: torch.Tensor,
    u_fixed: torch.Tensor,
    f_applied: torch.Tensor,
) -> torch.Tensor:
    """RHS of the reduced system: b = free*(f - K u_fixed) + (1-free)*u_fixed;
    with it the masked solve returns the prescribed values exactly on fixed
    DOFs."""
    return free_mask * (f_applied - matvec(u_fixed)) + (1.0 - free_mask) * u_fixed


def block_jacobi_inverse(diag_blocks: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """[N, 2, 2] inverses of the reduced operator's diagonal blocks
    free_n * K_nn * free_n + diag(1 - free_n), closed form. No guard: a
    block with det == 0 gives inf / nan, as in the JAX package (a reduced
    SPD block never has one)."""
    f = free_mask  # [N, 2]
    d = diag_blocks * (f[:, :, None] * f[:, None, :])
    a, b = d[:, 0, 0] + (1.0 - f[:, 0]), d[:, 0, 1]
    c, e = d[:, 1, 0], d[:, 1, 1] + (1.0 - f[:, 1])
    det = a * e - b * c
    return torch.stack(
        [torch.stack([e, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
    ) / det[:, None, None]


def block_jacobi_preconditioner(diag_blocks: torch.Tensor, free_mask: torch.Tensor) -> MatVec:
    """Inverse of the 2x2 diagonal blocks of the reduced operator
    (`block_jacobi_inverse`) as an apply function on [N, 2] fields."""
    inv = block_jacobi_inverse(diag_blocks, free_mask)

    def apply(r: torch.Tensor) -> torch.Tensor:
        return (inv * r[:, None, :]).sum(dim=-1)

    return apply


def jacobi_preconditioner(diag_blocks: torch.Tensor, free_mask: torch.Tensor) -> MatVec:
    """Scalar Jacobi: divide by the reduced operator's diagonal entries."""
    diag = torch.stack([diag_blocks[:, 0, 0], diag_blocks[:, 1, 1]], dim=-1)
    d = free_mask * diag + (1.0 - free_mask)

    def apply(r: torch.Tensor) -> torch.Tensor:
        return r / d

    return apply


def identity_preconditioner() -> MatVec:
    return lambda r: r
