"""Shared 2x2 nodal-block helpers (port of magnetite_tpu/parallel/blocks.py;
here in the fem layer, since the single-solve smoothers use them as well as
the design sweeps above it).

Every banded path needs the same two pieces around the (ux, uy) diagonal
blocks of the stiffness operator:

  * BC reduction: free * D * free + (1 - free) * I -- the reduced
    operator is the identity on fixed DOFs, so block-Jacobi smoothing
    leaves prescribed displacements untouched.
  * A guarded closed-form 2x2 inverse / solve (Cramer): blocks whose
    determinant is exactly zero (padding rows, fully-constrained nodes
    before reduction) pass through with det := 1, which on reduced
    operators only ever touches rows that are identity anyway.

Every product is written out as multiply-adds, so no TF32 path can reach it.
"""

from __future__ import annotations

import torch


def reduce_diag_blocks(d: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """BC-reduce 2x2 diagonal blocks: free*D*free + (1-free)*I.

    d [2, 2, *dims], free [2, *tail] with *tail broadcastable against
    *dims (e.g. d [2,2,N,B] with free [2,N,1])."""
    d = d * (free[:, None] * free[None, :])  # a new tensor: safe to add into
    d[0, 0] += 1.0 - free[0]
    d[1, 1] += 1.0 - free[1]
    return d


def guarded_inv2(d: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of 2x2 blocks d [2, 2, *dims], det==0 -> I/1.

    Returns the same [2, 2, *dims] layout."""
    a_, b_ = d[0, 0], d[0, 1]
    c_, e_ = d[1, 0], d[1, 1]
    det = a_ * e_ - b_ * c_
    det = torch.where(det == 0, torch.ones_like(det), det)
    return torch.stack([torch.stack([e_, -b_]), torch.stack([-c_, a_])]) / det


def apply_blocks(d: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-block 2x2 apply: d [2, 2, *dims] @ r [2, *dims] -> [2, *dims]."""
    return torch.stack([
        d[0, 0] * r[0] + d[0, 1] * r[1],
        d[1, 0] * r[0] + d[1, 1] * r[1],
    ])


def solve2(d: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Guarded per-block 2x2 solve: d [2,2,*dims], r [2,*dims] -> d^-1 r.

    Same guard as guarded_inv2 (det==0 -> det:=1); Cramer applied to r
    directly, so no inverse is materialized."""
    a_, b_ = d[0, 0], d[0, 1]
    c_, e_ = d[1, 0], d[1, 1]
    det = a_ * e_ - b_ * c_
    det = torch.where(det == 0, torch.ones_like(det), det)
    x0 = (e_ * r[0] - b_ * r[1]) / det
    x1 = (-c_ * r[0] + a_ * r[1]) / det
    return torch.stack([x0, x1])
