"""Mixed-precision iterative refinement: an f64-grade residual from f32
inner solves (port of magnetite_tpu/fem/refine.py).

    repeat:  r = b - A x          (f64 operator: the exact residual)
             d ~= A^-1 r          (f32 PCG: all the iterations)
             x = x + d            (f64 accumulation)

Each pass contracts the true f64 residual by about the inner solve's
accuracy (~1e-4 relative), so two or three passes reach 1e-8..1e-12. The
JAX package's `lax.while_loop` over passes is a Python loop here, with one
host read of the f64 residual per pass (the span `solve.wait`); the inner
solve is fem/cg.pcg.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.logging import span
from .cg import MatVec, pcg

# the inner f32 solves' relative tolerance: safely above the f32 CG stall
# floor at 1M+ DOF; a lower one burns iterations on f32 noise the next
# f64 pass fixes anyway
INNER_RTOL = 1e-4


class RefineResult(NamedTuple):
    x: torch.Tensor  # f64 solution
    outer_steps: int  # refinement passes taken
    inner_iterations: torch.Tensor  # int64 scalar: total f32 CG iterations
    residual_norm: torch.Tensor  # final f64 ||b - A x||
    converged: torch.Tensor  # bool scalar
    inner_per_pass: tuple = ()  # int64 scalars: each pass's f32 iterations
    issued: int = 0  # inner iterations issued on the device, frozen ones included


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def mixed_precision_solve(
    op64: MatVec,
    op32: MatVec,
    b: torch.Tensor,  # f64
    *,
    preconditioner32: Optional[MatVec] = None,
    x0: Optional[torch.Tensor] = None,  # f64, must satisfy the fixed DOFs
    rtol: float = 1e-10,
    atol: float = 0.0,
    inner_maxiter: int = 100,
    max_outer: int = 8,
    dot=_dot,
    graph=None,
) -> RefineResult:
    """Solve A x = b (SPD) to an f64-grade residual with f32 inner solves.
    op64 must be op32's operator evaluated in f64 (same BC reduction).
    `dot` is every inner product, outer and inner (fem/cg.pcg's hook: the
    sharded solves pass the sum over shards). `graph` (fem/cg.PCGGraph)
    replays every pass's inner solve; the outer residual and the update of
    x stay eager."""
    f64 = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0.to(f64)
    threshold = torch.clamp(rtol * torch.sqrt(dot(b, b)), min=atol)
    thresh2 = threshold * threshold

    r = b - op64(x)
    rnorm2 = dot(r, r)
    per_pass = []
    k = issued = 0
    while k < max_outer:
        with span("solve.wait"):
            pending = bool(rnorm2 > thresh2)
        if not pending:
            break
        # scale the residual toward unit norm so the f32 inner solve works
        # in a healthy dynamic range whatever the outer residual's size
        scale = torch.sqrt(rnorm2)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        inner = pcg(
            op32,
            (r / safe).to(torch.float32),
            preconditioner=preconditioner32,
            rtol=INNER_RTOL,
            maxiter=inner_maxiter,
            dot=dot,
            graph=graph,
        )
        x = x + inner.x.to(f64) * safe
        r = b - op64(x)
        rnorm2 = dot(r, r)
        per_pass.append(inner.iterations)
        issued += inner.issued
        k += 1
    inner_total = torch.zeros((), dtype=torch.int64, device=b.device)
    for it in per_pass:
        inner_total = inner_total + it
    return RefineResult(
        x=x,
        outer_steps=k,
        inner_iterations=inner_total,
        residual_norm=torch.sqrt(rnorm2),
        converged=rnorm2 <= thresh2,
        inner_per_pass=tuple(per_pass),
        issued=issued,
    )
